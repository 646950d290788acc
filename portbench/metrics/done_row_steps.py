"""Share of K1's row-steps spent on rows that had already completed
``target_cs`` when their block started: the program's counters
``rollout.done_row_steps`` over ``rollout.row_steps``, in percent
(``repro_torch.trace``; ``None`` where the program has no such counters)."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    s = trace.session()
    c = s.counters if s is not None else {}
    if not c.get("rollout.row_steps") or "rollout.done_row_steps" not in c:
        return None
    return c["rollout.done_row_steps"] / c["rollout.row_steps"] * 100.0
