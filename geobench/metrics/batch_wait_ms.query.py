"""Time a member of a fused batch waited for its turn in the
dispatcher's pull loop, per query: PhaseClock's batch.wait over the
window's queries (serving)."""


def read(ctx):
    p = ctx.get("phase_s")
    if not p or "batch.wait" not in p or ctx["n_queries"] == 0:
        return None
    return p["batch.wait"] / ctx["n_queries"] * 1e3
