"""Process start to the first timed sweep: imports, CUDA set-up, the
simulator library (built on a checkout's first run), the columns and the
warm-up of the cell's own shapes."""


def read(ctx):
    return ctx["setup_s"]
