"""The benchmark's plain reference: C-FedRAG's models, retrieval and prompt
grammar in plain PyTorch and NumPy.  It imports nothing of the program
under test and takes nothing the program made: only the raw inputs the
benchmark generated (texts, weights) and, to judge them, the program's
outputs."""
