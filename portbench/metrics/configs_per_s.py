"""Configs of every sweep finished in the window over the host seconds
from the window's start to the end of its last sweep."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return ctx["sweeps"] * ctx["configs_per_sweep"] / ctx["window_s"]
