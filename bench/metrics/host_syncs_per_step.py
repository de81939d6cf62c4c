"""Model step: device-to-host reads on the engine's thread per engine step in the window (the program's span counts)."""
from fedbench import ring


def read(run):
    return ring.host_syncs_per_step(ring.window_spans(run))
