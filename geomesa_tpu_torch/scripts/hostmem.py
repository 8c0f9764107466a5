"""Host-memory helpers of the scale drivers (``run_pod_scale``,
``validate_1b``): the port's own copies of the reference benchmark's
``_rss_bytes``, ``_malloc_trim``, ``_RssSampler`` and
``_ingest_column_set_bytes`` (bench.py in the JAX package's tree), so no
driver imports that benchmark.

- :func:`rss_bytes`: this process's resident set size, from /proc.
- :func:`peak_rss_bytes`: its lifetime high-water mark (``ru_maxrss``).
- :func:`malloc_trim`: hand freed allocator arenas back before a
  baseline reading.
- :func:`mem_total_bytes`: the host's memory; :func:`rows_cut`: a
  driver's ``reduced`` entry for a cut of rows, with the reason read
  from the run's own peak RSS.
- :class:`RssSampler`: a thread that samples the peak RSS of one phase.
- :func:`column_set_bytes`: the bytes of one type's column set, the
  reference's sum; on a CUDA store the tables' columns are device
  memory, not host RAM, so :func:`column_set_split` also gives the two
  halves.

Not a driver: it has no ``main``. The drivers import it.
"""

from __future__ import annotations

import ctypes
import os
import resource
import threading

import numpy as np


def rss_bytes() -> int:
    """Current resident set size of this process (Linux /proc)."""
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def peak_rss_bytes() -> int:
    """This process's peak resident set size so far (``ru_maxrss``, KiB
    on Linux)."""
    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024


def mem_total_bytes() -> int:
    """The host's memory (``MemTotal`` of /proc/meminfo)."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemTotal")


def rows_cut(n: int, n_reference: int, rss_start: int) -> list:
    """``reduced``'s entry for a run of ``n`` rows where the reference
    runs ``n_reference``, with its reason from this run's own reading:
    the peak RSS over ``rss_start`` a row, and what the reference's rows
    would need at that rate beside the host's memory. Empty when nothing
    was cut."""
    if n >= n_reference:
        return []
    peak = peak_rss_bytes()
    per_row = (peak - rss_start) / n
    need = rss_start + per_row * n_reference
    return [f"rows {n:,} of the reference's {n_reference:,}: peak host RSS "
            f"{peak / 1e9:.1f} GB ({per_row:.0f} B a row over {rss_start / 1e9:.1f} GB at "
            f"the start), so {n_reference:,} rows would need about {need / 1e9:.0f} GB of "
            f"this host's {mem_total_bytes() / 1e9:.1f} GB"]


def malloc_trim() -> None:
    """Release freed-but-retained allocator arenas before a baseline RSS
    reading, so the ratios compare live bytes rather than glibc's
    retention. Never called while a phase's peak is sampled."""
    ctypes.CDLL("libc.so.6").malloc_trim(0)


class RssSampler:
    """Background peak-RSS sampler over one phase (``ru_maxrss`` is the
    process's lifetime high-water mark, which cannot scope a phase)."""

    def __init__(self, interval_s: float = 0.02):
        self.interval_s = interval_s
        self.peak = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, name="rss-sampler", daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, rss_bytes())
            self._stop.wait(self.interval_s)

    def __enter__(self):
        self.peak = rss_bytes()
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, rss_bytes())


def column_set_split(ds, type_name: str) -> dict:
    """One type's column set in two halves: ``host`` (feature columns and
    ids, every index's write keys, each table's sorted keys and
    permutation) and ``device`` (the tables' scan columns, on the
    store's device)."""
    from geomesa_tpu_torch.ingest.pipeline import _chunk_nbytes

    host = sum(_chunk_nbytes(fc, {}) for fc in ds._chunks.get(type_name, []))
    for (t, _), parts in ds._key_chunks.items():
        if t == type_name:
            for k in parts:
                host += int(k.bins.nbytes) + int(k.zs.nbytes)
                host += sum(int(v.nbytes) for v in k.device_cols.values())
    device = 0
    for (t, _), table in ds._tables.items():
        if t == type_name:
            device += int(table.nbytes_device)
            host += sum(int(np.asarray(a).nbytes) for a in (table.perm, table.bins, table.zs))
    return {"host": host, "device": device}


def column_set_bytes(ds, type_name: str) -> int:
    """The reference's column-set bytes: both halves of
    :func:`column_set_split` summed (on a CPU store the tables' columns
    are RAM too)."""
    split = column_set_split(ds, type_name)
    return split["host"] + split["device"]
