"""Kernels: key positions one windowed attention layer read over those one full layer read, summed over the window's engine steps, in % (the program's ``engine.step`` counters ``kv_read_window`` and ``kv_read_full``)."""
from fedbench import ring, window


def read(run):
    return window.read_share(ring.window_spans(run))
