"""Model step: the window's model FLOPs over the H100's bf16 peak, in %."""
from fedbench.readers import mfu_percent


def read(run):
    return mfu_percent(run)
