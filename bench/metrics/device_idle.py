"""Device: share of the profiled slice in which no device operation ran, in %."""
from fedbench.readers import sliced


def read(run):
    return sliced(run, lambda s: 100.0 * (1.0 - s.busy_s / s.window_s))
