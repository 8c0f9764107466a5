"""Device-to-host and decode time per query: PhaseClock's d2h (CUDA
events) and decode (bit planes to rows, gather) seconds over the window's
queries (decode and gather)."""


def read(ctx):
    p = ctx.get("phase_s")
    if not p or ctx["n_queries"] == 0:
        return None
    return (p.get("d2h", 0.0) + p.get("decode", 0.0)) / ctx["n_queries"] * 1e3
