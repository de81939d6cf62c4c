"""Engine: live query lanes over the lanes the window's engine steps ran, in % (the program's ``engine.step`` spans)."""
from fedbench import ring


def read(run):
    return ring.live_lane_share(ring.window_spans(run))
