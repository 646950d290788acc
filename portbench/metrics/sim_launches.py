"""Simulator kernel launches a sweep in the traced window, from the
wrappers' own counters (every shard's launches count)."""


def read(ctx):
    n = ctx.get("launches")
    return None if not n else n / ctx["sweeps"]
