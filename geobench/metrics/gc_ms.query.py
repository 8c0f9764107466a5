"""The garbage collector's pauses per query: PhaseClock's gc (every
collection while the clock was armed, from gc.callbacks) over the
window's queries (host runtime)."""


def read(ctx):
    p = ctx.get("phase_s")
    if not p or "gc" not in p or ctx["n_queries"] == 0:
        return None
    return p["gc"] / ctx["n_queries"] * 1e3
