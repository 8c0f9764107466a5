"""K1 and K2 against their roofline over the window: the launches' bounds
summed (roofline.scan_launch / multi_launch, each max(bytes / 3.35 TB/s,
operations / 67 TOP/s)) over the device time of those kernels in the
profiler's trace (kernels). Nothing where a launch carried polygon legs,
whose operations its arguments do not give (no cell sends polygons yet)."""

from geobench import roofline

KERNELS = ("block_scan", "block_scan_multi")


def read(ctx):
    launches = [x for x in ctx.get("launches") or () if x["kernel"] in KERNELS]
    trace = ctx.get("trace")
    if not launches or trace is None:
        return None
    if any(x.get("modelled") is False for x in launches):
        return None
    device_s = sum(trace["kernel_s"].get(k, 0.0) for k in KERNELS)
    if device_s <= 0:
        return None
    bound_s = sum(roofline.bound(x["bytes"], x["ops"])["bound_ms"] for x in launches) / 1e3
    return 100.0 * bound_s / device_s
