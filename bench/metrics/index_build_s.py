"""Federation: the providers' chunk tokenising and F_emb index build during set-up, in s (the program's spans)."""
from fedbench import ring


def read(run):
    return ring.index_build_s(ring.setup_spans(run))
