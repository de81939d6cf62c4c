"""Engine: device operations in the profiled slice over the engine steps it holds."""
from fedbench.readers import sliced


def read(run):
    return sliced(run, lambda s: s.launches / s.engine_steps if s.engine_steps else None)
