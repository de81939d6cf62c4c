"""The port's roofline tools against the JAX package's: ``model_flops_for``
and ``ssd_correction`` exactly for every assigned arch and shape; the
``Roofline`` terms on the H100's peaks (``tests/test_roofline.py``'s
check); the cost counter's categories on small programs with exact byte
counts (the counterpart of the reference's HLO parsers); every kernel's
cost hook at ``chip_smoke.py`` phase 3's shapes against the bound column
PERF.md prints; and ``report``'s tables against the reference's text."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS as R_ARCHS, SHAPES as R_SHAPES, get_config as r_get  # noqa: E402
from repro.launch import report as r_report  # noqa: E402
from repro.launch import roofline as r_roofline  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.kernels.chunked_prefill import ops as cp  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.retrieval_topk import ops as rt  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ss  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW, LINK_BW, PEAK_FLOPS, CostCounter, Roofline, model_flops_for, ssd_correction,
)
from repro_torch.runtime.compat import gather  # noqa: E402

CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]


def test_assigned_archs_and_shapes_are_the_references():
    assert ASSIGNED_ARCHS == R_ARCHS and list(SHAPES) == list(R_SHAPES)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_ssd_correction_equal_the_references(arch, shape):
    cfg, r_cfg = get_config(arch), r_get(arch)
    assert model_flops_for(cfg, SHAPES[shape]) == r_roofline.model_flops_for(r_cfg, R_SHAPES[shape])
    assert ssd_correction(cfg, SHAPES[shape]) == r_roofline.ssd_correction(r_cfg, R_SHAPES[shape])


def test_h100_constants():
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)


def test_roofline_terms_math():
    r = Roofline(
        arch="x", shape="train_4k", mesh="single", n_chips=256,
        hlo_flops=256 * PEAK_FLOPS,  # exactly 1s of compute
        hlo_bytes=256 * HBM_BW * 0.5,  # 0.5s memory
        collective_bytes=256 * LINK_BW * 2.0,  # 2s collective
        collective_detail={}, model_flops=256 * PEAK_FLOPS * 0.8,
        memory_per_device=1,
    )
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(2.0)
    assert r.dominant == "collective"
    assert r.step_bound_s == pytest.approx(2.0)
    assert r.mfu_bound == pytest.approx(0.8 / 2.0)
    assert r.useful_flops_frac == pytest.approx(0.8)
    assert set(r.to_dict()) >= {"compute_s", "memory_s", "collective_s", "dominant", "step_bound_s",
                                "useful_flops_frac", "mfu_bound"}


# --- the counter's categories (tests/test_roofline.py's HLO, as torch programs) ---


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_collective_bytes_per_kind(device):
    shards = [torch.zeros(128, 256, dtype=torch.bfloat16, device=device) for _ in range(16)]
    with CostCounter() as c:
        gather(shards, device)
        gather([torch.zeros(2048, 256, device=device)], device, "all-reduce")
    assert c.collectives["all-gather"] == 16 * 128 * 256 * 2  # every shard's operand
    assert c.collectives["all-reduce"] == 2048 * 256 * 4
    assert c.collectives["collective_count"] == 2
    with pytest.raises(ValueError):
        c.record_collective("psum", shards)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_convert_bytes(device):
    x = torch.zeros(2048, 256, dtype=torch.bfloat16, device=device)
    with CostCounter() as c:
        x.to(torch.float32)
        x.to(torch.bfloat16)  # no cast: no op
    # bf16 -> f32 convert of 2048x256: 4B out + 2B in per elem
    assert c.convert_bytes == 2048 * 256 * (4 + 2) == c.bytes


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_dus_bytes(device):
    leaf = torch.zeros(2048, 256, device=device)
    new = torch.ones(2048, 4, device=device)
    with CostCounter() as c:
        c.mark_cache({"k": leaf})
        leaf[:, :4] = new  # in place: no copy of the buffer
    assert c.dus_bytes == 0
    with CostCounter() as c:
        c.mark_cache({"k": leaf})
        leaf.index_copy(1, torch.arange(4, device=device), new)  # out of place: the whole buffer again
    assert c.dus_bytes == 2048 * 256 * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_flops_bytes_views_and_live_bytes(device):
    a, b = torch.zeros(64, 32, device=device), torch.zeros(32, 16, device=device)
    with CostCounter() as c:
        assert c.track(a, b, a) == (64 * 32 + 32 * 16) * 4  # each storage once
        o = a @ b
        a.t().reshape(-1)[:8].view(2, 4)  # views (the reshape of a transpose copies)
        del o
        s = torch.zeros(64, 16, device=device).expand(3, 64, 16).sum(0)
    assert c.flops == 2 * 64 * 32 * 16
    copy = 64 * 32 * 4 * 2  # the reshape's clone: read and written
    mm = (64 * 32 + 32 * 16 + 64 * 16) * 4
    zeros, expand_sum = 64 * 16 * 4, 64 * 16 * 4 * 2  # the broadcast dim read once
    assert c.bytes == mm + copy + zeros + expand_sum
    assert c.peak_bytes == (64 * 32 + 32 * 16) * 4 + 64 * 32 * 4 + 64 * 16 * 4  # args, the clone, o
    assert s.shape == (64, 16)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_counts_a_kernel_by_its_hook_alone(device):
    q = torch.randn(2, 32, 4, 16, device="cpu").to(device)
    k = torch.randn(2, 32, 2, 16, device="cpu").to(device)
    with CostCounter() as c:
        out = fa.flash_attention(q, k, k, causal=True)
    flops, nbytes = fa.cost(q, k, k, True)
    assert c.kernels == {"flash_attention": 1}
    assert (c.flops, c.bytes) == (sum(flops.values()), nbytes)
    assert out.shape == q.shape and out.device.type == device and out.is_contiguous()


# --- the kernels' cost hooks at chip_smoke.py phase 3's shapes ---------------


def _bound_ms(cost):
    """chip_smoke.py's bound: the larger of the bytes' time and the
    FLOPs' time, each part at its dtype's peak, in ms."""
    peak = {"float32": 67e12, "bfloat16": 989e12}
    flops, nbytes = cost
    t_b, t_o = nbytes / 3.35e12 * 1e3, sum(f / peak[dt] for dt, f in flops.items()) * 1e3
    return (round(t_b, 6), "bytes") if t_b >= t_o else (round(t_o, 6), "operations")


def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


R, W, BS, NT = 8, 256, 32, 9
DESC = [(0, 0, 180, 180), (1, 100, 76, 176)] + [(r, 120 + 25 * r, 1, 121 + 25 * r) for r in range(2, 7)] + [(7, 0, 0, 0)]
LENS = [288, 17, 200, 64, 250, 131, 99, 1]
LENS_C = [272, 17, 200, 64, 250, 131, 99, 1]


def _warm_case():
    """Phase 3's warm admission: (descriptors, tables as lists)."""
    warm_len = [200, 231, 257, 287, 192, 150, 95, 288]
    chain = {0: list(range(0, NT)), 1: list(range(NT, 2 * NT))}
    nxt, trash = 2 * NT, R * NT
    tables = [[trash] * NT for _ in range(R)]
    desc = []
    for r, ln in enumerate(warm_len):
        n_sh, cow = ln // BS, ln % BS == 0
        own = chain[r // 4][: n_sh - cow]
        for c in range(-(-ln // BS)):
            if c < len(own):
                tables[r][c] = own[c]
            else:
                tables[r][c], nxt = nxt, nxt + 1
        q0 = ln - 1 if cow else n_sh * BS
        desc.append((r, q0, ln - q0, ln))
    return desc, tables


# qwen3-4b's admission step, packed: one fill of 1,057 lanes beside 31 decode rows
DESC4 = [(0, 0, 1057, 1057)] + [(r, 1057 + (37 * r) % 63, 1, 1058 + (37 * r) % 63) for r in range(1, 32)]
DESC4 = [(*d, 0 if r == 0 else 1057 + r - 1) for r, d in enumerate(DESC4)]


def _ssd(b, l, h, hd, ds, g, dtype=torch.bfloat16):
    x = _m(b, l, h, hd, dtype=dtype)
    bg = _m(b, l, g, ds, dtype=dtype)
    bg = bg.expand(b, l, h, ds) if g == 1 else bg.repeat_interleave(h // g, 2)
    return ss.cost(x, bg, bg, _m(b, l, h, dtype=torch.float32), _m(h, dtype=torch.float32))


HOOK_ROWS = [
    # (PERF.md section 6 row, its bound column, the hook at that row's shape)
    ("retrieval_topk provider f32", (0.320530, "bytes"),
     lambda: rt.cost(_m(32, 256, dtype=torch.float32), _m(1 << 20, 256, dtype=torch.float32), 8)),
    ("retrieval_topk served D=256", (0.000050, "bytes"),
     lambda: rt.cost(_m(16, 256, dtype=torch.float32), _m(147, 256, dtype=torch.float32), 8)),
    ("retrieval_topk served D=768", (0.000150, "bytes"),
     lambda: rt.cost(_m(16, 768, dtype=torch.float32), _m(147, 768, dtype=torch.float32), 8)),
    ("mixed_prefill step mix", (0.004610, "bytes"),
     lambda: cp.cost(_m(R, W, 16, 128), _m(73, BS, 8, 128), None, _m(R, NT), _m(R, 4), desc_host=DESC)),
    ("mixed_prefill G=1", (0.006396, "bytes"),
     lambda: cp.cost(_m(R, W, 16, 128), _m(73, BS, 16, 128), None, _m(R, NT), _m(R, 4), desc_host=DESC)),
    ("mixed_prefill warm admission", (0.003455, "bytes"),
     lambda: cp.cost(_m(R, W, 16, 128), _m(73, BS, 8, 128), None, _m(R, NT), _m(R, 4),
                     desc_host=_warm_case()[0], tables_host=_warm_case()[1])),
    ("mixed_prefill packed, qwen3-4b admission", (0.047895, "bytes"),
     lambda: cp.cost(_m(1088, 32, 128), _m(1121, BS, 8, 128), None, _m(32, 35), _m(32, 5), desc_host=DESC4)),
    ("mixed_prefill partials, owned", (0.007192, "bytes"),
     lambda: cp.cost(_m(R, W, 16, 128), _m(73, BS, 8, 128), None, _m(R, NT), _m(R, 4), owned=_m(R, NT),
                     partials=True, desc_host=DESC)),
    ("paged_decode", (0.001303, "bytes"),
     lambda: da.paged_cost(_m(R, 16, 128), _m(73, BS, 8, 128), None, _m(R, NT), None, lengths_host=LENS)),
    ("paged_decode G=1", (0.002587, "bytes"),
     lambda: da.paged_cost(_m(R, 16, 128), _m(73, BS, 16, 128), None, _m(R, NT), None, lengths_host=LENS)),
    ("flash_attention rerank", (0.030049, "bytes"),
     lambda: fa.cost(_m(256, 64, 12, 64), _m(256, 64, 12, 64), None, False)),
    ("flash_attention chunk index", (0.010784, "bytes"),
     lambda: fa.cost(_m(147, 40, 12, 64), _m(147, 40, 12, 64), None, False)),
    ("flash_attention admit prefill", (0.007512, "bytes"),
     lambda: fa.cost(_m(8, 256, 16, 128), _m(8, 256, 8, 128), None, True)),
    ("flash_attention G=1", (0.010016, "bytes"),
     lambda: fa.cost(_m(8, 256, 16, 128), _m(8, 256, 16, 128), None, True)),
    ("flash_attention jamba G=8", (0.022537, "bytes"),
     lambda: fa.cost(_m(8, 256, 64, 128), _m(8, 256, 8, 128), None, True)),
    ("flash_attention one of 4 data shards", (0.001878, "bytes"),
     lambda: fa.cost(_m(2, 256, 16, 128), _m(2, 256, 8, 128), None, True)),
    ("flash_attention HuBERT dh 80", (0.003130, "bytes"),
     lambda: fa.cost(_m(4, 256, 16, 80), _m(4, 256, 16, 80), None, False)),
    ("flash_decode", (0.001284, "bytes"),
     lambda: da.decode_cost(_m(R, 16, 128), _m(R, 272, 8, 128), None, None, lengths_host=LENS_C)),
    ("flash_decode G=1", (0.002548, "bytes"),
     lambda: da.decode_cost(_m(R, 16, 128), _m(R, 272, 16, 128), None, None, lengths_host=LENS_C)),
    ("flash_decode jamba G=8", (0.001343, "bytes"),
     lambda: da.decode_cost(_m(R, 64, 128), _m(R, 272, 8, 128), None, None, lengths_host=LENS_C)),
    ("flash_decode partials, one of 4 shards", (0.000311, "bytes"),
     lambda: da.decode_cost(_m(R, 16, 128), _m(R, 68, 8, 128), None, None, return_partials=True,
                            lengths_host=[68, 0, 0, 0, 68, 63, 31, 0])),
    ("ssd_chunk", (0.064297, "operations"), lambda: _ssd(8, 256, 64, 64, 128, 1)),
    ("ssd_chunk jamba", (0.146915, "operations"), lambda: _ssd(8, 256, 256, 64, 16, 8)),
    ("ssd_chunk one of 2 data shards", (0.032149, "operations"), lambda: _ssd(4, 256, 64, 64, 128, 1)),
]


@pytest.mark.parametrize("row,want,hook", HOOK_ROWS, ids=[r[0] for r in HOOK_ROWS])
def test_kernel_cost_hooks_give_perf_mds_bounds(row, want, hook):
    assert _bound_ms(hook()) == want


def test_shape_only_hooks_take_the_whole_cache():
    """Without the lengths (a meta call has none) the decode hooks count
    every cache position: the same as lengths at the full stripe."""
    q, k = _m(R, 16, 128), _m(R, 272, 8, 128)
    assert da.decode_cost(q, k, None, None) == da.decode_cost(q, k, None, None, lengths_host=[272] * R)
    pool, tables = _m(73, BS, 8, 128), _m(R, NT)
    assert da.paged_cost(q, pool, None, tables, None) == da.paged_cost(q, pool, None, tables, None,
                                                                       lengths_host=[NT * BS] * R)


def test_a_window_halves_the_bytes_of_a_steps_attention():
    """A sliding window counts only the positions it reads: a step of 8
    decode rows at 2,048 positions with a window of 1,024 reads half the
    K/V and half the block-table entries (bs 32) and does half the FLOPs,
    through ``paged_decode`` and through ``mixed_prefill`` alike; the rest
    (q, the output, the lengths or descriptors) stays."""
    q, pool, tables = _m(8, 32, 128), _m(8 * 64 + 1, 32, 8, 128), _m(8, 64)
    half = (2 * 8 * 2048 * 8 * 128 * 2 + 8 * 64 * 4) // 2  # K/V and table entries, halved
    f_full, b_full = da.paged_cost(q, pool, None, tables, None, lengths_host=[2048] * 8)
    f_win, b_win = da.paged_cost(q, pool, None, tables, None, lengths_host=[2048] * 8, window=1024)
    assert b_full - b_win == half and f_win["bfloat16"] * 2 == f_full["bfloat16"]
    desc = [(i, 2047, 1, 2048, i) for i in range(8)]
    f_full, b_full = cp.cost(q, pool, None, tables, _m(8, 5), desc_host=desc)
    f_win, b_win = cp.cost(q, pool, None, tables, _m(8, 5), desc_host=desc, window=1024)
    assert b_full - b_win == half and f_win["bfloat16"] * 2 == f_full["bfloat16"]


# --- report ----------------------------------------------------------------


def _results():
    rows = []
    for i, (dom, arch) in enumerate([("compute", "qwen3-4b"), ("collective", "qwen2-moe-a2.7b"),
                                     ("memory", "smollm-360m")]):
        rows.append({
            "arch": arch, "shape": "train_4k", "mesh": "single", "status": "ok", "compile_s": 1.5 + i,
            "compute_s": [2.0, 1e-3, 1e-3][i], "memory_s": [1e-3, 1e-3, 0.5][i], "collective_s": [1e-3, 3.0, 1e-3][i],
            "dominant": dom, "step_bound_s": [2.0, 3.0, 0.5][i], "useful_flops_frac": 0.5, "mfu_bound": 0.25,
            "collective_detail": {"all-reduce": 10, "all-to-all": 20, "collective_count": 3},
            "memory_analysis": {"peak_bytes_per_device": [10 * 2**30, 20 * 2**30, 90 * 2**30][i]},
        })
    rows.append({"arch": "qwen3-4b", "shape": "long_500k", "mesh": "single", "status": "skip",
                 "reason": "long_500k needs sub-quadratic attention (ssm/hybrid only)"})
    return rows


def test_report_tables_are_the_references():
    res = _results()
    tpu_fix = "fuse attention/SSD softmax chain into Pallas kernel (VMEM-resident)"
    gpu_fix = "fuse attention/SSD softmax chain into a hand-written CUDA kernel (on-chip resident)"
    assert report.roofline_table(res) == r_report.roofline_table(res).replace(tpu_fix, gpu_fix)
    assert gpu_fix in report.roofline_table(res)
    assert report.skip_table(res) == r_report.skip_table(res)
    ours, theirs = report.dryrun_table(res).splitlines(), r_report.dryrun_table(res).splitlines()
    assert ours[0] == theirs[0].replace("fits 16G v5e", "fits 80G H100")
    # 10 GiB fits both; 20 GiB fits only the H100; 90 GiB neither
    assert [line.rsplit("|", 2)[1].strip() for line in ours[2:]] == ["yes", "yes", "NO"]
    assert [line.rsplit("|", 2)[1].strip() for line in theirs[2:]] == ["yes", "NO", "NO"]
    assert [line.rsplit("|", 2)[0] for line in ours[2:]] == [line.rsplit("|", 2)[0] for line in theirs[2:]]
