"""The benchmark's plain reference against the program, at smoke width on
the CPU and in float32 (the only file that imports both).  Every
configuration of BENCHMARK.json's generator is held, at its own smoke cut,
to its own reference file."""
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(BENCH), str(BENCH.parent / "src")) if p not in sys.path]

from fedbench import cell, load_file  # noqa: E402
from fedbench.system import make_weights, model_config  # noqa: E402
from fedbench.testing import smoke_generator  # noqa: E402
from reference import models as R  # noqa: E402
from reference import retrieval as RT  # noqa: E402
from reference import text as T  # noqa: E402
from repro_torch.core.orchestrator import Orchestrator  # noqa: E402
from repro_torch.data.tokenizer import HashTokenizer  # noqa: E402
from repro_torch.kernels.retrieval_topk.ops import retrieval_topk  # noqa: E402
from repro_torch.models import cross_encoder as CE  # noqa: E402
from repro_torch.models import dual_encoder as DE  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402

SMOKE = dict(n_layers=2, d_model=64, n_heads=4, head_dim=16, d_ff=128, dtype="float32")
SPEC = cell.load_spec()
UNTIED = "medrag-qwen3-4b"  # held with an untied head too
CASES = [case for c in SPEC["configs"]
         for case in [(c["name"], {})] + ([(c["name"], {"tie_embeddings": False})] if c["name"] == UNTIED else [])]


def _config(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    return json.loads((BENCH.parent / entry["file"]).read_text())


@pytest.mark.parametrize("name,kw", CASES)
def test_decoder_matches_the_program(name, kw):
    cfg = _config(name)
    m = dict(smoke_generator(cfg["generator"]), dtype="float32", **kw)
    decoder = load_file(cell.generator_files(cfg)["reference"], "test_reference_generator").decoder_logits
    w = make_weights(LM.param_specs(model_config(m)), 3, "cpu")
    tokens = torch.randint(8, 512, (1, 37), generator=torch.Generator().manual_seed(0))
    want, _ = LM.forward(model_config(m), w, {"tokens": tokens})
    got = decoder(m, w, tokens[0], 37, R.F32)
    torch.testing.assert_close(got, want[0].float(), atol=2e-4, rtol=1e-4)


def _encoder(name):
    m = json.loads((BENCH / "configs" / "medrag-qwen3-4b.json").read_text())[name]["model"]
    m.update(SMOKE, n_kv_heads=4)
    return m


def test_encoders_match_the_program():
    e, r = _encoder("embedder"), _encoder("reranker")
    we = make_weights(DE.param_specs(model_config(e)), 4, "cpu")
    wr = make_weights(CE.param_specs(model_config(r)), 5, "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(8, 8192, (6, 20), generator=g)
    toks[:, 15:] = 0  # PAD tail
    torch.testing.assert_close(R.embed_texts(e, we, toks, batch=4), DE.encode(model_config(e), we, toks),
                               atol=1e-5, rtol=1e-5)
    types_ = (torch.arange(20)[None, :] >= 7).long().expand(6, 20)
    torch.testing.assert_close(R.score_pairs(r, wr, toks, types_), CE.score_pairs(model_config(r), wr, toks, types_),
                               atol=1e-4, rtol=1e-4)
    q, c = torch.randn(3, 16, generator=g), torch.randn(50, 16, generator=g)
    s, i = RT.topk(q, c, 5)
    ps, pi = retrieval_topk(q, c, 5)
    torch.testing.assert_close(s, ps)
    assert torch.equal(i.to(torch.int32), pi)


def test_text_matches_the_program():
    tok = HashTokenizer()
    words = [f"w{i}" for i in range(40)]
    ids = [T.word_id(w, 8192) for w in words]
    assert ids == [tok.token(w) for w in words]
    np.testing.assert_array_equal(T.encode_ids(ids[:30], 24), tok.encode(" ".join(words[:30]), max_len=24))
    np.testing.assert_array_equal(T.encode_ids(ids[:5], 24), tok.encode(" ".join(words[:5]), max_len=24))
    orch = types.SimpleNamespace(tok=tok, query_reserve=32)
    rows = np.stack([tok.encode(" ".join(words[i : i + 9 + i]), max_len=32) for i in range(6)])
    for width, q in ((300, words[:12]), (60, words[:40]), (40, words[:3])):
        want = Orchestrator.build_prompt(orch, " ".join(q), {"chunk_tokens": rows}, max_len=width)[0]
        np.testing.assert_array_equal(T.build_prompt(rows, [T.word_id(w, 8192) for w in q], width), want)
    qrow = tok.encode(" ".join(words[:10]), max_len=24)
    for a, b in zip(T.pack_pairs(qrow, rows), CE._pack_pairs(qrow, rows, 64)):
        np.testing.assert_array_equal(a, b)


def test_fp8_control_rounds_to_e4m3():
    x = torch.tensor([[1.0, 0.3, -0.0625, 448.0]])
    y = R.Prec("fp8").round(x, -1)
    assert torch.equal(y, x.to(torch.float8_e4m3fn).float())  # amax 448: no rescale
    assert not torch.equal(R.Prec("fp8").round(torch.tensor([[1.0, 1.01]]), -1), torch.tensor([[1.0, 1.01]]))
