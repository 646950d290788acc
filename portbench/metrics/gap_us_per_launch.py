"""The device's idle microseconds a simulator launch: idle seconds of the
traced window (averaged over the cards) over the launches a card made."""


def read(ctx):
    tr, n = ctx.get("trace") or {}, ctx.get("launches")
    if not tr or not n:
        return None
    chips = ctx["chips"]
    busy = sum(tr["busy_s"].get(d, 0.0) for d in range(chips)) / chips
    return (tr["window_s"] - busy) / (n / chips) * 1e6
