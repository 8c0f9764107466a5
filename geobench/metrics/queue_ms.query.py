"""Time a query waited in the scheduler's queue, per query: PhaseClock's
queue (enqueue to the dispatcher's drain, the micro-batch window and the
previous batch's dispatch included) over the window's queries
(serving)."""


def read(ctx):
    p = ctx.get("phase_s")
    if not p or "queue" not in p or ctx["n_queries"] == 0:
        return None
    return p["queue"] / ctx["n_queries"] * 1e3
