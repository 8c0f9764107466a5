"""Share of the traced window in which no operation ran on the card: 1 -
the union of the profiler's device activity intervals over the window
(device)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
