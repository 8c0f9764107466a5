"""Scan kernel launches per query: PhaseClock's n.launch.single (K1, the
fused path's single-query route included) + n.launch.fused (K2) over the
window's queries (table and pruning)."""


def read(ctx):
    p = ctx.get("phase_s") or {}
    keys = ("n.launch.single", "n.launch.fused")
    if not any(k in p for k in keys) or ctx["n_queries"] == 0:
        return None
    return sum(p.get(k, 0) for k in keys) / ctx["n_queries"]
