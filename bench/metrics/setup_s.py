"""Process start to the window opening: imports, the kernels (built on a
checkout's first run, loaded after), corpus, weights, index, warm-up and
the stream's ramp."""


def read(run):
    return run.setup_s
