"""Post-processing time per query: PhaseClock's post (visibility,
sample, sort, page, projection) over the window's queries (decode and
gather)."""


def read(ctx):
    p = ctx.get("phase_s")
    if not p or "post" not in p or ctx["n_queries"] == 0:
        return None
    return p["post"] / ctx["n_queries"] * 1e3
