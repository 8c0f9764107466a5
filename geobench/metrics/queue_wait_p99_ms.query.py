"""p99 of the time a query waited behind the scheduler's micro-batch
window: the geomesa.serving.queue_wait histogram's growth over the window
(serving)."""


def read(ctx):
    s = ctx.get("serving")
    if s is None or s["queue_wait"] is None or s["queue_wait"].count == 0:
        return None
    return s["queue_wait"].quantile(0.99) * 1e3
