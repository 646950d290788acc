"""Host milliseconds a sweep in the stream layer: the program's
``stream.sweep`` spans less the ``rollout.core`` spans inside them (plan,
encode, copy-in, copy-back, the reduction), over the sweeps
(``repro_torch.trace``; ``None`` where the program has no such spans)."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    s = trace.session()
    st = s.stats() if s is not None else {}
    sweep, core = st.get("stream.sweep"), st.get("rollout.core")
    if not sweep or not core:
        return None
    return (sweep["total_ns"] - core["total_ns"]) / sweep["count"] * 1e-6
