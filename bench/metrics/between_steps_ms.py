"""Engine: mean host time between one step's readback and the next step's launch in the window (the program's spans)."""
from fedbench import ring


def read(run):
    return ring.between_steps_ms(ring.window_spans(run))
