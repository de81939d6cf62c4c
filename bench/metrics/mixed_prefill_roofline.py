"""Kernels: the slice's mixed_prefill launches' roofline bound (``fedbench/window.py``, from the engine steps' read counters, windowed and full layers apart) over their device time, in %."""
from fedbench import window


def read(run):
    return window.mixed_prefill_roofline(run)
