"""The least time of the work the sweeps' inputs need (portbench.roofline:
planned horizons in whole blocks times active threads, at the data
sheet's SIMT lane rate; bytes once at HBM's rate) over the device seconds
of every kernel in the traced window, in percent."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr or tr.get("kernel_s", 0.0) <= 0.0:
        return None
    return ctx["work"]["seconds"] * ctx["sweeps"] / tr["kernel_s"] * 100.0
