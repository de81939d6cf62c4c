"""Engine: median time from a request's submission to its first token in the window (the program's spans)."""
from fedbench import ring


def read(run):
    return ring.first_token_ms(ring.window_spans(run))
