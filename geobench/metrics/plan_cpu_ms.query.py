"""Planning CPU time per query: PhaseClock's plan.cpu (each client
thread's time.thread_time over its planning) over the window's queries
(planner). plan_ms minus this is the wait for the interpreter lock and
the OS."""


def read(ctx):
    p = ctx.get("phase_s")
    if not p or "plan.cpu" not in p or ctx["n_queries"] == 0:
        return None
    return p["plan.cpu"] / ctx["n_queries"] * 1e3
