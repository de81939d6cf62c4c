"""Answered requests retired inside the window, over the window."""
from fedbench.readers import window_requests


def read(run):
    return sum(r.status == "done" for r in window_requests(run)) / run.seconds
