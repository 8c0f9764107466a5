"""Planning time per query: PhaseClock's plan seconds over the window's
queries (planner: filter parse, index choice, range decomposition)."""


def read(ctx):
    if not ctx.get("phase_s") or ctx["n_queries"] == 0:
        return None
    return ctx["phase_s"].get("plan", 0.0) / ctx["n_queries"] * 1e3
