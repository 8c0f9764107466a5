"""The device trace of a traced window, reduced to numbers in memory.

``torch.profiler`` traces the card's activity (kernels, copies, sets) and
the host's ``phase.*`` ranges (``recorders.shared_phase_clock``) over the
window; nothing is written to disk. ``reduce`` gives:

- ``busy_s``: the union of the device's activity intervals;
- ``kernel_s``: device seconds per kernel of the program, by name;
- ``device_ops``: the ten device operations that took most time;
- ``idle_gaps``: the device's idle time between activities, summed by the
  host phase that overlapped each gap most ("other" where none did),
  the ten largest.
"""

from __future__ import annotations

from collections import defaultdict

# the kernels the roofline readers read, by their CUDA function names (csrc/*.cu)
KERNEL_NAMES = {
    "block_scan": "gm_block_scan_kernel",
    "block_scan_multi": "gm_block_scan_multi_kernel",
}


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        # the host ranges of every thread, not only the one that starts it
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        config = None
    prof = profile(activities=activities, experimental_config=config)
    prof.start()
    return prof


def _span_ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = int(e.start_ns())
        return s, s + int(e.duration_ns())
    s = int(e.start_us()) * 1000
    return s, s + int(e.duration_us()) * 1000


def kernel_of(name: str) -> "str | None":
    for k, fn in KERNEL_NAMES.items():
        if fn in name:
            return k
    return None


def merge(intervals: list) -> list:
    """Sorted, disjoint union of [start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(prof) -> dict:
    """Numbers of a stopped profiler's trace (see the module's doc)."""
    from torch.autograd import DeviceType

    device, phases = [], []
    t_lo = t_hi = None
    for e in prof.profiler.kineto_results.events():
        s, t = _span_ns(e)
        t_lo = s if t_lo is None else min(t_lo, s)
        t_hi = t if t_hi is None else max(t_hi, t)
        if e.device_type() == DeviceType.CUDA:
            device.append((s, t, e.name()))
        elif e.name().startswith("phase."):
            phases.append((s, t, e.name()[len("phase."):]))
    kernel_s: dict = defaultdict(float)
    by_name: dict = defaultdict(float)
    for s, t, name in device:
        by_name[name] += (t - s) / 1e9
        k = kernel_of(name)
        if k is not None:
            kernel_s[k] += (t - s) / 1e9
    busy = merge([[s, t] for s, t, _ in device])
    busy_s = sum(t - s for s, t in busy) / 1e9
    gaps = []
    if t_lo is not None:
        edges = [t_lo] + [v for iv in busy for v in iv] + [t_hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
    per_phase: dict = defaultdict(list)
    for s, t, name in phases:
        per_phase[name].append([s, t])
    # each gap's overlap with each phase's merged ranges, by one sweep
    overlap = [defaultdict(int) for _ in gaps]
    for name, ivs in per_phase.items():
        ivs = merge(ivs)
        j = 0
        for k, (g0, g1) in enumerate(gaps):
            while j < len(ivs) and ivs[j][1] <= g0:
                j += 1
            i = j
            while i < len(ivs) and ivs[i][0] < g1:
                overlap[k][name] += min(ivs[i][1], g1) - max(ivs[i][0], g0)
                i += 1
    idle: dict = defaultdict(float)
    for (g0, g1), share in zip(gaps, overlap):
        idle[max(share, key=share.get) if share else "other"] += (g1 - g0) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "kernel_s": dict(kernel_s),
        "device_ops": [[n[:120], v] for n, v in top],
        "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }
