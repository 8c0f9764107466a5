"""f64 refinement time per query: PhaseClock's refine seconds over the
window's queries (refinement)."""


def read(ctx):
    p = ctx.get("phase_s")
    if not p or ctx["n_queries"] == 0:
        return None
    return p.get("refine", 0.0) / ctx["n_queries"] * 1e3
