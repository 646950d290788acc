"""Mean microseconds of the program's ``rollout.flag`` span: a shard's
count of converged rows read back after a block, the host blocked on K1
and the reduction (``repro_torch.trace``; ``None`` where the program has
no such span)."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    s = trace.session()
    flag = s.stats().get("rollout.flag") if s is not None else None
    return None if not flag else flag["total_ns"] / flag["count"] * 1e-3
