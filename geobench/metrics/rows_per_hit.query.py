"""Rows the scan kernels were handed per row that matched: PhaseClock's
n.rows.scanned (the candidate blocks' rows) over n.rows.matched (rows
after refinement) (table and pruning)."""


def read(ctx):
    p = ctx.get("phase_s") or {}
    if not p.get("n.rows.matched") or "n.rows.scanned" not in p:
        return None
    return p["n.rows.scanned"] / p["n.rows.matched"]
