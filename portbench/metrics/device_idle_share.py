"""1 - (union of the device's busy intervals) / (the traced window),
averaged over the cards used, in percent."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr or tr["window_s"] <= 0:
        return None
    chips = ctx["chips"]
    busy = sum(tr["busy_s"].get(d, 0.0) for d in range(chips)) / chips
    return (1.0 - busy / tr["window_s"]) * 100.0
