"""The scheduler's dispatcher thread's busy time per query: PhaseClock's
dispatcher (each batch's dispatch, pull, decode, refine and post) over
the window's queries (serving). Times query_rate / 1000, the thread's
busy share."""


def read(ctx):
    p = ctx.get("phase_s")
    if not p or "dispatcher" not in p or ctx["n_queries"] == 0:
        return None
    return p["dispatcher"] / ctx["n_queries"] * 1e3
