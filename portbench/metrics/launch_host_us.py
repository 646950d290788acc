"""Mean microseconds of the program's ``wrappers.launch`` span: K1's
wrapper on the host (checks, 17 fresh outputs, pointer arrays, the
ctypes launch), the host's side of each gap between blocks
(``repro_torch.trace``; ``None`` where the program has no such span)."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    s = trace.session()
    launch = s.stats().get("wrappers.launch") if s is not None else None
    return None if not launch else launch["total_ns"] / launch["count"] * 1e-3
