"""The process's CPU time per query: PhaseClock's cpu (time.process_time
from the clock's arming to its settle, every thread, the profiler's own
host work included) over the window's queries (host runtime). Read in
traced runs only: compare it between traced runs. Times query_rate /
1000, the cores the process keeps busy."""


def read(ctx):
    p = ctx.get("phase_s")
    if not p or "cpu" not in p or ctx["n_queries"] == 0:
        return None
    return p["cpu"] / ctx["n_queries"] * 1e3
