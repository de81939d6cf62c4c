"""Answer tokens of the requests retired inside the window, over the window."""
from fedbench.readers import window_requests


def read(run):
    return sum(len(r.answer) for r in window_requests(run) if r.status == "done") / run.seconds
