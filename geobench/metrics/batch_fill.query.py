"""Queries a fused dispatch carried over the window: the scheduler's
geomesa.serving.batched_queries over geomesa.serving.batches (serving)."""


def read(ctx):
    s = ctx.get("serving")
    if s is None or s["counters"]["batches"] <= 0:
        return None
    return s["counters"]["batched_queries"] / s["counters"]["batches"]
