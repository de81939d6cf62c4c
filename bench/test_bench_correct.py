"""``correct`` comes out false for the control and for each fault a cell
can have: the whole run drives the CPU at smoke size, the harness's look
for a card skipped, with each cell's own limits.

- the control: the reference in float8 in the program's place;
- a token altered where it is produced (the mixed step's logits push
  every answer's first token to one id);
- a step that leaves its state unchanged (the paged attention writes its
  K/V into a copy of the pool, so later steps read the stale pool);
- half the batch left out (each provider answers the first half of a
  collect batch and copies those answers to the rest).

The cells are BENCHMARK.json's own, so a cell added there is held here
from its files alone.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(BENCH), str(BENCH.parent / "src")) if p not in sys.path]

from fedbench import cell  # noqa: E402
from fedbench.testing import WINDOW_S, shrink  # noqa: E402

CELL = "qwen3-4b.mcq-offline"
OTHER_CELLS = [w["name"] for w in cell.load_spec()["workloads"] if w["name"] != CELL]


def _run(workload=CELL, control=False):
    res = shrink(cell.resolve(cell.load_spec(), workload))
    out = cell.execute(res, seed=2**31 + 5, seconds=WINDOW_S, trace=False, device="cpu", control=control,
                       log=lambda *a, **k: None)
    assert out["n_checked"][0] > 0  # the window finished requests, so the check has something to judge
    return res, out


def _control_fails(workload):
    res, out = _run(workload, control=True)
    prog, ctrl = out["readings"]["program"], out["readings"]["control"]
    assert [k for k, lim in res["limits"].items() if ctrl[k] > lim], out["readings"]
    for k in ("topk_gap", "topk_err", "rerank_gap", "rerank_err"):
        assert prog[k] < ctrl[k], (k, out["readings"])


def test_the_control_fails_where_the_program_reads_low():
    _control_fails(CELL)


@pytest.mark.parametrize("workload", OTHER_CELLS)
def test_the_control_fails_in_the_other_cells(workload):
    _control_fails(workload)


def _altered_answer(monkeypatch):
    from repro_torch.models import lm as LM

    mixed_step = LM.mixed_step

    def altered(*a, **kw):  # the first token of every answer comes out as id 9
        logits = mixed_step(*a, **kw)
        logits[..., 9] += 1e4
        return logits

    monkeypatch.setattr(LM, "mixed_step", altered)


def _state_unchanged(monkeypatch):
    from repro_torch.models import layers as L

    for name in ("attn_mixed_paged", "attn_decode_paged"):
        inner = getattr(L, name)

        def stale(cfg, p, x, k_pool, v_pool, *a, _inner=inner, **kw):
            return _inner(cfg, p, x, k_pool.clone(), v_pool.clone(), *a, **kw)

        monkeypatch.setattr(L, name, stale)


def _half_batch(monkeypatch):
    from repro_torch.core import provider as P

    retrieve = P.DataProvider.retrieve

    def half(self, query_tokens, m):
        q = np.asarray(query_tokens)
        if q.ndim == 2 and len(q) > 1:
            out = retrieve(self, q[: (len(q) + 1) // 2], m)
            rows = np.arange(len(q)) % ((len(q) + 1) // 2)
            return {k: (v[rows] if k != "provider" else v) for k, v in out.items()}
        return retrieve(self, query_tokens, m)

    monkeypatch.setattr(P.DataProvider, "retrieve", half)


FAULTS = {"answer_altered": (_altered_answer, "answer"), "state_unchanged": (_state_unchanged, "answer"),
          "half_batch": (_half_batch, "topk_gap")}
CASES = [(w, f) for w in [CELL] + OTHER_CELLS for f in FAULTS]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f if w == CELL else f"{w}-{f}" for w, f in CASES])
def test_each_fault_is_not_correct(monkeypatch, workload, fault):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    res, out = _run(workload)
    if number == "answer":  # the cell's answer number: the widest gap, or the mean where the cell compares it
        number = "answer_gap" if "answer_gap" in res["limits"] else "answer_gap_mean"
    line = cell.result_line(cell.load_spec(), res, out, False, "cpu", 1)
    assert line["correct"] is False
    assert line["checks"][number]["value"] > line["checks"][number]["limit"], line["checks"]
