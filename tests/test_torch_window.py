"""Sliding-window attention and YaRN RoPE in the port (Mellum2-12B-A2.5B's
layers), on the CPU at small shapes.

- The plain windowed ``mixed_prefill`` (packed and padded) and
  ``paged_decode`` against a naive masked oracle in f64, with windows
  below, at and above the rows' lengths: 1e-5 (f32 sums in another order).
- The port's ``mixed_step`` / ``decode_step`` logits against the
  benchmark's plain reference ``bench/reference/mellum2.py`` on seeded
  random weights, with fills split over steps so that the window's edge
  falls inside a chunk, then decode through the pool: 1e-4 absolute on
  logits of order 5 (f32 in another order of sums over 4 layers: the
  paged softmax over gathered blocks against the reference's masked one,
  the routed experts' index_add against the port's grouped loop).
- YaRN's inverse frequencies against an independent transcription of HF's
  ``_compute_yarn_parameters`` (f32 like HF: 1e-6 relative), index 18
  kept and index 35 at 1/16, and the attention factor on cos and sin.
- A window that never bites gives bitwise the window-0 path, on the
  qwen3 smoke config: the window only adds a mask term.
- Every path without a window refuses a windowed model: the contiguous
  engine, ``lm.prefill`` / ``lm.forward`` past the window, the sharded pool.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [p for p in (str(ROOT / "bench"),) if p not in sys.path]

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels.chunked_prefill import ops as cp  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServeEngine  # noqa: E402
from _lanes import pack_rows  # noqa: E402

CONFIG = json.loads((ROOT / "bench" / "configs" / "medrag-mellum2-12b-a2.5b.json").read_text())


def _reference():
    from fedbench import load_file

    return load_file(ROOT / "bench" / "reference" / "mellum2.py", "test_window_reference_mellum2")


def _smoke_block(**kw) -> dict:
    """Mellum2's model block at smoke width: 4 layers (one period, the full
    layer last), 8 experts top 2, a window of 12 keys, f32."""
    m = dict(CONFIG["generator"]["model"])
    m.update(n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16, vocab_size=512, n_experts=8,
             moe_top_k=2, moe_d_ff=32, window=12, dtype="float32", **kw)
    return m


# ---------------------------------------------------------------- plain kernels


def _oracle_mixed(q, kp, vp, tables, desc, window):
    """Padded q (R, W, H, dh), desc (R, 4): each live lane's softmax over
    the pool positions it sees, in f64, one lane at a time."""
    r, w, h, dh = q.shape
    bs, kv = kp.shape[1], kp.shape[2]
    out = torch.zeros(q.shape, dtype=torch.float64)
    for i, (slot, q0, ql, kl) in enumerate(desc.tolist()):
        for j in range(ql):
            p = q0 + j
            keys = [k for k in range(min(p + 1, kl)) if window <= 0 or k > p - window]
            if not keys:
                continue
            blk = [int(tables[slot, k // bs]) for k in keys]
            kk = torch.stack([kp[b, k % bs] for b, k in zip(blk, keys)]).double()  # (n, KV, dh)
            vv = torch.stack([vp[b, k % bs] for b, k in zip(blk, keys)]).double()
            for hh in range(h):
                g = hh // (h // kv)
                s = kk[:, g] @ q[i, j, hh].double() / math.sqrt(dh)
                out[i, j, hh] = torch.softmax(s, 0) @ vv[:, g]
    return out


def _mixed_case(seed, r=4, w=20, h=4, kv=2, dh=16, bs=4, n_t=12):
    g = torch.Generator().manual_seed(seed)
    n_pool = r * n_t + 1
    q = torch.randn(r, w, h, dh, generator=g)
    kp, vp = torch.randn(n_pool, bs, kv, dh, generator=g), torch.randn(n_pool, bs, kv, dh, generator=g)
    tables = torch.randperm(n_pool - 1, generator=g)[: r * n_t].view(r, n_t).int()
    # a cold fill, a chunk resuming mid-prompt, a decode row, a short chunk past 40 positions
    desc = torch.tensor([(0, 0, 20, 20), (1, 17, 13, 30), (2, 44, 1, 45), (3, 30, 7, 37)], dtype=torch.int32)
    return q, kp, vp, tables, desc


@pytest.mark.parametrize("window", [1, 5, 13, 30, 45, 100])
def test_windowed_mixed_prefill_plain_matches_the_oracle(window):
    """Windows of one key, inside a chunk, at a row's length (30, 45) and
    past every row's; padded and packed."""
    q, kp, vp, tables, desc = _mixed_case(window)
    want = _oracle_mixed(q, kp, vp, tables, desc, window)
    got = cp.mixed_prefill_attention_plain(q, kp, vp, tables, desc, window)
    live = torch.arange(q.shape[1])[None, :] < desc[:, 2:3]
    torch.testing.assert_close(got[live].double(), want[live], atol=1e-5, rtol=1e-5)
    assert (got[~live] == 0).all()
    qp, d5, rows, lanes = pack_rows(q, desc)
    packed = cp.mixed_prefill_attention(qp, kp, vp, tables, d5, window=window)
    torch.testing.assert_close(packed, got[torch.as_tensor(rows), torch.as_tensor(lanes)], atol=0, rtol=0)
    if window >= 45:  # past every lane's prefix: the window-0 result, bitwise
        assert torch.equal(got, cp.mixed_prefill_attention_plain(q, kp, vp, tables, desc))


@pytest.mark.parametrize("window", [1, 7, 29, 45, 64])
def test_windowed_paged_decode_plain_matches_the_oracle(window):
    g = torch.Generator().manual_seed(window)
    b, h, kv, dh, bs, n_t = 5, 4, 2, 16, 4, 12
    n_pool = b * n_t + 1
    q = torch.randn(b, h, dh, generator=g)
    kp, vp = torch.randn(n_pool, bs, kv, dh, generator=g), torch.randn(n_pool, bs, kv, dh, generator=g)
    tables = torch.randperm(n_pool - 1, generator=g)[: b * n_t].view(b, n_t).int()
    lens = torch.tensor([1, 8, 29, 45, 48], dtype=torch.int32)
    got = da.paged_decode_attention(q, kp, vp, tables, lens, window=window)
    desc = torch.stack([torch.arange(b), lens - 1, torch.ones(b, dtype=torch.int32), lens], 1).int()
    want = _oracle_mixed(q[:, None], kp, vp, tables, desc, window)[:, 0]
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)
    if window >= 48:
        assert torch.equal(got, da.paged_decode_attention(q, kp, vp, tables, lens))


def test_windowed_cost_counts_only_the_window():
    """The cost hook counts the keys each lane sees, and the positions and
    table entries from each row's first lane's window start on."""
    q, kp, vp, tables, desc = _mixed_case(0)
    r, w, h, dh = q.shape
    kv, bs, es = kp.shape[2], kp.shape[1], 4
    rows = desc.tolist()
    flops, nbytes = cp.cost(q, kp, vp, tables, desc, desc_host=rows, window=5)
    pairs = sum(min(q0 + j + 1, kl) - max(0, q0 + j + 1 - 5) for _, q0, ql, kl in rows for j in range(ql))
    reach = [(max(0, q0 - 4), min(kl, q0 + ql)) for _, q0, ql, kl in rows]
    n_q = sum(ql for _, _, ql, _ in rows)
    want = (n_q * h * dh * es + r * w * h * dh * es + 2 * sum(hi - lo for lo, hi in reach) * kv * dh * es
            + r * 4 * 4 + sum(-(-hi // bs) - lo // bs for lo, hi in reach) * 4)
    assert flops == {"float32": 4 * h * dh * pairs} and nbytes == want


# ---------------------------------------------------------------- YaRN


def _hf_yarn(dim, base, factor, original_max, beta_fast, beta_slow):
    """HF transformers' ``_compute_yarn_parameters`` (truncate=True), in f32
    as HF computes it, with ``attention_factor`` from its default formula."""
    def find_correction_dim(num_rotations):
        return (dim * math.log(original_max / (num_rotations * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(find_correction_dim(beta_fast)), 0)
    high = min(math.ceil(find_correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float) / dim)
    inv_freq_extrapolation = 1.0 / pos_freqs
    inv_freq_interpolation = 1.0 / (factor * pos_freqs)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    extrapolation_factor = 1 - ramp
    inv_freq = inv_freq_interpolation * (1 - extrapolation_factor) + inv_freq_extrapolation * extrapolation_factor
    return inv_freq, 0.1 * math.log(factor) + 1.0, (low, high)


def test_yarn_frequencies_follow_hf():
    m = CONFIG["generator"]["model"]
    want, attn_factor, (low, high) = _hf_yarn(128, m["rope_theta"], m["yarn_factor"], m["yarn_original_max"],
                                              m["yarn_beta_fast"], m["yarn_beta_slow"])
    got = torch.as_tensor(L.yarn_freqs(128, m["rope_theta"], m["yarn_factor"], m["yarn_original_max"],
                                       m["yarn_beta_fast"], m["yarn_beta_slow"]))
    assert (low, high) == (18, 35)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    plain = torch.as_tensor(L.rope_freqs(128, m["rope_theta"]))
    torch.testing.assert_close(got[: low + 1], plain[: low + 1], rtol=1e-6, atol=0)  # index 18 kept
    torch.testing.assert_close(got[high:], plain[high:] / 16, rtol=1e-6, atol=0)  # index 35 on at 1/16
    ramp, base = got[low + 1 : high], plain[low + 1 : high]
    assert (ramp < base).all() and (ramp > base / 16).all()
    assert m["yarn_attn_factor"] == pytest.approx(attn_factor, rel=1e-15)


def test_yarn_scales_cos_and_sin_on_the_full_layers_only():
    cfg = ModelConfig(**_smoke_block())
    assert [cfg.attn_window(i) for i in range(8)] == [12, 12, 12, 0] * 2
    assert [cfg.rope_yarn(i) is not None for i in range(4)] == [False, False, False, True]
    x = torch.randn(1, 3, 2, 16)
    pos = torch.zeros(1, 3, dtype=torch.int32)  # angle 0: cos 1, sin 0
    torch.testing.assert_close(L.apply_rope(x, pos, cfg.rope_theta, cfg.rope_yarn(3)), x * cfg.yarn_attn_factor)
    assert torch.equal(L.apply_rope(x, pos, cfg.rope_theta, cfg.rope_yarn(0)), x)


# ---------------------------------------------------------------- the model against the reference


def _served_logits(cfg, params, tokens, chunks, bs=4):
    """The fills of ``chunks`` tokens through ``mixed_step`` (every lane
    read), then the rest one token a ``decode_step`` through the pool."""
    s = len(tokens)
    n_blk = -(-s // bs) + 1
    cache = LM.init_paged_cache(cfg, n_blk + 1, bs, dtype=torch.float32, device="cpu")
    tables = np.arange(n_blk)[None, :]
    tab = torch.as_tensor(tables, dtype=torch.int32)
    outs, pos = [], 0
    for c in chunks:
        a = LM.pack_lanes([pos], [c], [c], tables, bs)
        lanes = LM.Lanes(*(torch.as_tensor(a[f]) for f in LM.Lanes._fields))
        outs.append(LM.mixed_step(cfg, params, tokens[pos : pos + c], cache, tab, lanes))
        pos += c
    for t in range(pos, s):
        lg = LM.decode_step(cfg, params, cache, tokens[t : t + 1][None], torch.tensor([t], dtype=torch.int32),
                            block_tables=tab, block_size=bs)
        outs.append(lg[:, 0])
    return torch.cat(outs)


@pytest.mark.parametrize("chunks", [(17, 9, 14), (5, 20, 1, 11), (40,)], ids=["edge-in-chunks", "ragged", "one-fill"])
def test_mixed_and_decode_steps_match_the_reference(chunks):
    """A 46-token sequence, far past the window of 12: the fills split so
    that positions 12 and 24 (a window's length from lanes of the chunk)
    fall inside chunks, then 6 decode tokens through the pool."""
    m = _smoke_block()
    cfg = ModelConfig(**m)
    params = init_params(LM.param_specs(cfg), torch.Generator().manual_seed(11), device="cpu")
    tokens = torch.randint(8, 512, (46,), generator=torch.Generator().manual_seed(len(chunks)))
    got = _served_logits(cfg, params, tokens, chunks)
    ref = _reference()
    want = ref.decoder_logits(m, params, tokens, len(tokens))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    # the window and YaRN both move the logits: dropping either is far outside that
    for off in ({"window": 0}, {"yarn_factor": 0.0}):
        other = ref.decoder_logits(dict(m, **off), params, tokens, len(tokens))
        assert (other - want).abs().max() > 1e-2, off


# ---------------------------------------------------------------- the window-0 path


def test_a_window_that_never_bites_is_the_window0_path_bitwise():
    """qwen3's smoke config with no window and with a window longer than
    every position: the same logits bit for bit, fills and decode."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    wide = dataclasses.replace(cfg, window=10**6)
    assert cfg.attn_window(0) == 0 and wide.attn_window(0) == 10**6 and cfg.scan_period == wide.scan_period
    params = init_params(LM.param_specs(cfg), torch.Generator().manual_seed(2), device="cpu")
    tokens = torch.randint(8, 256, (30,), generator=torch.Generator().manual_seed(3))
    a = _served_logits(cfg, params, tokens, (11, 13))
    b = _served_logits(wide, params, tokens, (11, 13))
    assert torch.equal(a, b)


# ---------------------------------------------------------------- refusals


def test_paths_without_a_window_refuse_a_windowed_model():
    cfg = ModelConfig(**_smoke_block())
    params = init_params(LM.param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="window of 12"):
        ServeEngine(cfg, params, ServeConfig(max_batch=2, max_prompt_len=32, paged=False), device="cpu")
    with pytest.raises(ValueError, match="window of 12"):
        ServeEngine(cfg, params, ServeConfig(max_batch=2, max_prompt_len=32, paged=True, block_size=4, shards=2),
                    device="cpu")
    long = {"tokens": torch.randint(8, 512, (1, 20))}
    for fn in (LM.prefill, LM.forward):
        with pytest.raises(ValueError, match="last 12 positions"):
            fn(cfg, params, long)
    LM.forward(cfg, params, {"tokens": long["tokens"][:, :12]})  # no longer than the window: exact, allowed
    with pytest.raises(ValueError, match="last 12 positions"):
        LM.prefill(cfg, params, {"tokens": long["tokens"][:, :8]}, cache_len=16)  # its cache runs past it
    pools = LM.init_paged_cache(cfg, 5, 4, dtype=torch.float32, device="cpu", n_shards=2)["pos0"]
    pp = LM._layer_params(params, 0, 0)["attn"]
    a = LM.pack_lanes([0], [3], [1], np.zeros((1, 2), np.int64), 4)
    lanes = LM.Lanes(*(torch.as_tensor(a[f]) for f in LM.Lanes._fields))
    with pytest.raises(ValueError, match="sharded pool"):
        L.attn_mixed_paged(cfg, pp, torch.zeros(3, 64), LM._layer_pool(pools["k"], 0),
                           LM._layer_pool(pools["v"], 0), lanes, torch.zeros((1, 2), dtype=torch.int32))
