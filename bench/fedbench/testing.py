"""Helpers of the benchmark's CPU tests (``bench/test_bench_*.py``): a
cell of BENCHMARK.json cut to a size the CPU runs in seconds (two layers
of width 64 for every model, one hash tokenizer of 8,192 ids, 64 chunks a
site of 8-24 words, 4 slots), with its batch cut to 16 questions and no
ramp.  Run with a window longer than the batch (``WINDOW_S``), every
answer retires inside it, however loaded the CPU.

A configuration's ``generator`` block may carry ``"smoke"``: ``ModelConfig``
fields that the cut sets after its own (a hybrid's period, say
``{"n_layers": 2, "attn_every": 2, "attn_offset": 1}``)."""
import copy

WINDOW_S = 900.0
BATCH = (4, 3, 5, 2, 2)  # questions of each of MIRAGE's five sets


def smoke_generator(generator: dict) -> dict:
    """A configuration's generator model block at smoke size."""
    g = copy.deepcopy(generator["model"])
    moe = bool(g.get("n_experts"))
    g.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4 if moe else 2, head_dim=16, d_ff=128, vocab_size=8192)
    if moe:
        g.update(n_experts=8, moe_d_ff=32, n_shared_experts=1, moe_top_k=2)
    g.update(generator.get("smoke", {}))
    return g


def shrink(resolved: dict) -> dict:
    r = copy.deepcopy(resolved)
    c = r["config"]
    c["generator"]["model"] = smoke_generator(c["generator"])
    for k in ("embedder", "reranker"):
        c[k]["model"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128)
    c["tokenizer_vocab_size"] = 8192
    c["corpus"].update(chunks_per_site=64, words=[8, 24], word_pool=2000)
    c["retrieval"]["chunk_max_len"] = 32
    c["serve"].update(max_batch=4, max_prompt_len=300, max_new_tokens=24)
    t = r["traffic"]
    t["question_sets"] = [dict(s, count=n) for s, n in zip(t["question_sets"], BATCH)]
    t["ramp_s"] = 0.0
    if t["answer_tokens"]["dist"] == "loguniform":
        t["answer_tokens"].update(lo=4, hi=16)
    t["check"].update(answer_tokens=40, min_answers=3, requests=8)
    return r
