"""Expert loop: device time of kernels launched under moe_expert_loop over device busy, in the slice, in %."""
from fedbench.readers import sliced


def read(run):
    return sliced(run, lambda s: None if s.loop_s is None or not s.busy_s else 100.0 * s.loop_s / s.busy_s)
