"""Kernels: device time of the paged attention kernels (mixed_prefill, paged_decode) per engine step, in the slice."""
from fedbench.readers import sliced


def read(run):
    return sliced(run, lambda s: 1e3 * s.attn_s / s.engine_steps if s.engine_steps else None)
