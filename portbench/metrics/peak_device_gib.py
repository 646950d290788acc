"""torch.cuda.max_memory_allocated over the window, the fullest card, in
GiB (the stream layer's chunks, encoded columns and summaries)."""


def read(ctx):
    peak = ctx.get("peak_bytes")
    return None if not peak else peak / 2 ** 30
