"""Share of scan-config lookups the planner's memo answered: PhaseClock's
n.memo.hit over n.memo.hit + n.memo.miss (planner)."""


def read(ctx):
    p = ctx.get("phase_s") or {}
    total = p.get("n.memo.hit", 0) + p.get("n.memo.miss", 0)
    if total == 0:
        return None
    return 100.0 * p.get("n.memo.hit", 0) / total
