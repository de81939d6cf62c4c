"""Whether what the timed path produced is right: the plain reference
against the program's outputs, after the window.

A sample of the requests the window finished, drawn from the seed with
the longest answer in it, is checked at every layer the window drove:

- ``topk_gap`` / ``topk_err``: each provider's top m against ``q @ c.T``
  over the whole site, in the reference's float32 embeddings of the
  chunks and the query.  The gap is the widest amount by which the
  program's j-th chunk scores below the reference's j-th best (so a
  wrong chunk, a wrong order or a missing row all show, and a near tie
  swapped by rounding shows as small); the error is the widest
  difference between a score the program reported and the reference's
  score of the same chunk.
- ``rerank_gap`` / ``rerank_err``: the context's chunks and their order
  against the reference cross encoder's scores of the same candidates,
  measured the same way.
- ``prompt_mismatch``: prompts that differ from the one the reference's
  copy of the grammar builds from the context's chunk ids and the
  question's text (exact: limit 0).
- ``answer_gap``: the widest amount by which a served token's logit lies
  below the reference's best logit at its position, over the sample's
  prompts and answers run once through the reference decoder;
  ``answer_gap_mean``: the same amount averaged over every served token.
  A sparse-expert generator compares the mean: its widest gap is set by
  the few tokens whose top-k experts a rounding flips (PERF.md), and does
  not separate the program from the control.

Each stage is checked on the program's own output of the stage before
(the rerank on the candidates the providers returned, the prompt on the
context the rerank chose, the answer on the prompt): a difference
that rounding makes in one stage is judged there and does not cascade.

``control=True`` also reads the same numbers for the reference computed
in float8 (``reference.models.Prec("fp8")``) in the program's place: its
own top m, its own context, and at each answer position the token it
puts first.

The generator's answers are judged by the ``decoder_logits`` of the
configuration's own reference file (``cell.generator_files``), for the
program and for the control alike; the encoders, retrieval and the
prompt by ``reference.models``, ``retrieval`` and ``text``.
"""
from __future__ import annotations

import numpy as np
import torch

from fedbench import load_file
from fedbench.traffic import rng
from reference import models as R
from reference import retrieval as RT
from reference import text as T

BAD = 1e9  # the reading of an output that is malformed (a duplicate, an id out of range)
NAMES = ("topk_gap", "topk_err", "rerank_gap", "rerank_err", "prompt_mismatch", "answer_gap", "answer_gap_mean")


def sample(records, seed: int, target_tokens: int, min_answers: int, max_checked: int):
    """(requests whose answers are checked, requests whose retrieval,
    rerank and prompt are checked): the finished requests in a seeded
    order with the one of the longest answer first."""
    done = [r for r in records if r.status == "done" and r.answer is not None and r.responses is not None]
    if not done:
        return [], []
    order = list(rng(seed, "check").permutation(len(done)))
    longest = max(range(len(done)), key=lambda i: len(done[i].answer))
    order.remove(longest)
    order = [longest] + order
    picked, tokens = [], 0
    for i in order:
        if tokens >= target_tokens and len(picked) >= min_answers:
            break
        picked.append(done[i])
        tokens += len(done[i].answer)
    return picked, [done[i] for i in order[:max_checked]]


def _gap(ref_scores: np.ndarray, chosen: np.ndarray) -> float:
    """Widest shortfall of the j-th chosen item's reference score below the
    reference's j-th best; ``chosen`` indexes ``ref_scores``."""
    if len(set(chosen.tolist())) != len(chosen) or chosen.min() < 0 or chosen.max() >= len(ref_scores):
        return BAD
    best = np.sort(ref_scores)[::-1][: len(chosen)]
    return float(np.max(np.maximum(best - ref_scores[chosen], 0.0)))


class Reference:
    """The reference's inputs: its own tokens of every chunk and question,
    from the benchmark's word indices, and the models' weights; and the
    generator's forward pass, ``decoder_logits`` of the file ``reference``."""

    def __init__(self, cfg: dict, corpus, weights: dict, models: dict, device, reference):
        self.cfg, self.w, self.m, self.device = cfg, weights, models, device
        self.decoder_logits = load_file(reference, "bench_reference_generator").decoder_logits
        vocab = cfg["tokenizer_vocab_size"]
        self.pool_ids = np.asarray([T.word_id(w, vocab) for w in corpus.pool], np.int64)
        texts = corpus.texts
        n_len = cfg["retrieval"]["chunk_max_len"]
        self.chunk_rows = np.stack([T.encode_ids(self.pool_ids[texts.words(i)], n_len) for i in range(len(texts))])
        self.site_of = corpus.site
        self.site_start = {int(s): int(np.flatnonzero(corpus.site == s)[0]) for s in np.unique(corpus.site)}
        self.site_emb: dict = {}

    def query_row(self, words: np.ndarray) -> np.ndarray:
        return T.encode_ids(self.pool_ids[words], T.QUERY_MAX_LEN)

    def site_embeddings(self, site: int, prec: R.Prec) -> torch.Tensor:
        key = (site, prec.kind)
        if key not in self.site_emb:
            rows = torch.as_tensor(self.chunk_rows[self.site_of == site], device=self.device)
            self.site_emb[key] = R.embed_texts(self.m["embedder"], self.w["embedder"], rows, prec)
        return self.site_emb[key]


def _words_of(schedule, rec):
    return schedule.questions.words(schedule.qid[rec.qidx])


def check(ref: Reference, schedule, picked, checked, control: bool = False) -> dict:
    """Readings of the program (and, with ``control``, of the float8
    control) on the sampled requests; ``{"program": {...}, "control": {...}}``."""
    dev = ref.device
    f32, fp8 = R.F32, R.Prec("fp8")
    precs = [("program", f32)] + ([("control", fp8)] if control else [])
    out = {k: {n: 0.0 for n in NAMES} for k, _ in precs}
    m = ref.cfg["retrieval"]["m_local"]
    width = ref.cfg["serve"]["max_prompt_len"]
    with torch.no_grad():
        # retrieval: every checked request, every provider
        q_rows = torch.as_tensor(np.stack([ref.query_row(_words_of(schedule, r)) for r in checked]), device=dev) \
            if checked else None
        q_emb = {p.kind: R.embed_texts(ref.m["embedder"], ref.w["embedder"], q_rows, p) for _, p in precs} \
            if checked else {}
        for b, rec in enumerate(checked):
            for resp in rec.responses:
                site = resp["provider"]  # one provider a site, in site order
                s = RT.scores(q_emb["f32"][b : b + 1], ref.site_embeddings(site, f32))[0].cpu().numpy()
                local = resp["chunk_ids"].astype(np.int64) - ref.site_start[site]
                g = _gap(s, local)
                o = out["program"]
                o["topk_gap"] = max(o["topk_gap"], g)
                o["topk_err"] = max(o["topk_err"], BAD if g == BAD else
                                    float(np.max(np.abs(resp["scores"].astype(np.float64) - s[local]))))
                if control:
                    sc, ic = RT.topk(q_emb["fp8"][b : b + 1], ref.site_embeddings(site, fp8), m)
                    ic = ic[0].cpu().numpy()
                    o = out["control"]
                    o["topk_gap"] = max(o["topk_gap"], _gap(s, ic))
                    o["topk_err"] = max(o["topk_err"], float(np.max(np.abs(sc[0].cpu().numpy() - s[ic]))))
        # rerank and prompt
        for rec in checked:
            cand = np.concatenate([resp["chunk_ids"] for resp in rec.responses]).astype(np.int64)
            toks, types = T.pack_pairs(ref.query_row(_words_of(schedule, rec)), ref.chunk_rows[cand])
            toks, types = torch.as_tensor(toks, device=dev), torch.as_tensor(types, device=dev)
            s = R.score_pairs(ref.m["reranker"], ref.w["reranker"], toks, types, f32).cpu().numpy()
            pos = {int(c): j for j, c in enumerate(cand)}
            ctx_ids = np.asarray(rec.context["chunk_ids"]).astype(np.int64)
            chosen = np.asarray([pos.get(int(c), -1) for c in ctx_ids])
            g = _gap(s, chosen)
            o = out["program"]
            o["rerank_gap"] = max(o["rerank_gap"], g)
            o["rerank_err"] = max(o["rerank_err"], BAD if g == BAD else float(
                np.max(np.abs(np.asarray(rec.context["scores"], np.float64) - s[chosen]))))
            query_ids = ref.pool_ids[_words_of(schedule, rec)].tolist()
            want = T.build_prompt(ref.chunk_rows[ctx_ids], query_ids, width)
            if rec.prompt is None or not np.array_equal(np.asarray(rec.prompt), want):
                o["prompt_mismatch"] += 1
            if control:
                sc = R.score_pairs(ref.m["reranker"], ref.w["reranker"], toks, types, fp8).cpu().numpy()
                top = np.argsort(-sc, kind="stable")[: len(ctx_ids)]
                o = out["control"]
                o["rerank_gap"] = max(o["rerank_gap"], _gap(s, top))
                o["rerank_err"] = max(o["rerank_err"], float(np.max(np.abs(sc[top] - s[top]))))
        # answers
        gm, gw = ref.m["generator"], ref.w["generator"]
        sums = {k: 0.0 for k, _ in precs}
        n_tok = 0
        for rec in picked:
            ans = np.asarray(rec.answer).astype(np.int64)
            seq = torch.as_tensor(np.concatenate([np.asarray(rec.prompt), ans[:-1]]), device=dev)
            lg = ref.decoder_logits(gm, gw, seq, len(ans), f32)
            served = lg[torch.arange(len(ans), device=dev), torch.as_tensor(ans, device=dev)]
            gaps = (lg.max(-1).values - served).cpu().numpy()
            out["program"]["answer_gap"] = max(out["program"]["answer_gap"], float(gaps.max()))
            sums["program"] += float(gaps.sum())
            n_tok += len(ans)
            if control:
                pick = ref.decoder_logits(gm, gw, seq, len(ans), fp8).argmax(-1)
                cg = (lg.max(-1).values - lg[torch.arange(len(ans), device=dev), pick]).cpu().numpy()
                out["control"]["answer_gap"] = max(out["control"]["answer_gap"], float(cg.max()))
                sums["control"] += float(cg.sum())
            del lg
        for k in sums:
            out[k]["answer_gap_mean"] = sums[k] / max(n_tok, 1)
    return out
