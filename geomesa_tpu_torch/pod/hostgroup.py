"""Host groups: which devices belong to which host, behind two drivers.

The port of geomesa_tpu/pod/hostgroup.py. A :class:`HostGroup` is the pod
tier's layout authority: H hosts, each contributing a fixed slice of
devices, every slice backing one per-host shard mesh (the same
``parallel.mesh.host_major_slices`` order the flat ``make_multihost_mesh``
axis uses, so the two views agree on which host owns which device). Two
drivers produce the slices:

- ``distributed``: a torch.distributed world, one host per process
  (``torch.distributed.is_initialized()`` and its world size, where the
  JAX package reads ``jax.process_count()``). Each process names its own
  cards: host h's slice reads, in process h, as that process's devices.
  In a single-process
  world :func:`make_host_group` raises :class:`PodUnsupported` with the
  reason :func:`probe_capability` gives, from the port's two-process gloo
  probe (``geomesa_tpu_torch/scripts/probe_multiprocess.py --json``).
- ``sim``: in-process simulation: the given devices (or the visible
  cards) slice host-major into H hosts. A device list may repeat a
  device (``["cpu"] * 8``, ``["cuda:0"] * 8``), the counterpart of the
  JAX package's virtual CPU mesh. Every pod code path (per-host shard
  builds, cross-host fused dispatch, per-host WAL and standing shards)
  runs as it would across hosts.

The group also owns the per-host link profile: :meth:`probe_links`
measures each host's pull RTT, :meth:`set_link_profile` derives one fused
slot cap per host through the shared ``derive_link_constants`` rule, and
``PodIndexTable`` stamps each shard's ``_slot_cap`` from it, so a slow
host pays its own bigger bucket and its peers keep theirs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import torch

from geomesa_tpu_torch import conf
from geomesa_tpu_torch.parallel.mesh import (
    SHARD_AXIS, Mesh, host_major_slices, visible_devices, world_size,
)

#: the probe's subprocess timeout: its launcher bounds its workers well
#: inside it, so this only catches a hung launcher
PROBE_TIMEOUT_S = 120


class PodUnsupported(RuntimeError):
    """The requested host-group driver cannot run in this environment
    (carries the capability probe's reason)."""


#: memoized capability verdict: the probe starts three processes, so one
#: verdict serves the whole process
_PROBE_MEMO: dict = {}


def _probe_script() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts", "probe_multiprocess.py",
    )


def probe_capability(refresh: bool = False) -> dict:
    """The machine-readable multi-process collective verdict:
    ``{"supported": bool, "verdict": "supported"|"UNSUPPORTED"|"error",
    "reason": str}`` from the port's ``probe_multiprocess.py --json``
    (memoized: the probe starts real processes)."""
    if not refresh and "verdict" in _PROBE_MEMO:
        return _PROBE_MEMO["verdict"]
    script = _probe_script()
    if not os.path.exists(script):
        v = {"supported": False, "verdict": "error", "reason": f"probe script missing: {script}"}
    else:
        try:
            out = subprocess.run(
                [sys.executable, script, "--json"],
                capture_output=True, text=True, timeout=PROBE_TIMEOUT_S,
            )
            lines = [ln for ln in out.stdout.splitlines() if ln.strip().startswith("{")]
            v = (
                json.loads(lines[-1]) if lines
                else {"supported": False, "verdict": "error",
                      "reason": f"no verdict line (rc={out.returncode})"}
            )
        except (OSError, subprocess.SubprocessError, ValueError) as e:
            v = {"supported": False, "verdict": "error", "reason": f"probe run failed: {e}"}
    _PROBE_MEMO["verdict"] = v
    return v


class HostGroup:
    """H hosts and their device slices; per-host shard meshes on demand.

    Construct through :func:`make_host_group` (driver and knob
    resolution): the constructor only records a settled layout."""

    def __init__(self, driver: str, slices: list):
        if not slices or not slices[0]:
            raise ValueError("a host group needs >= 1 host with >= 1 device")
        widths = {len(s) for s in slices}
        if len(widths) != 1:
            raise ValueError(f"ragged host slices: {sorted(widths)}")
        self.driver = driver
        self.hosts = len(slices)
        self.devices_per_host = len(slices[0])
        self.device_slices = tuple(tuple(torch.device(d) for d in s) for s in slices)
        self._meshes: dict = {}
        self._flat_mesh = None
        from geomesa_tpu_torch.lockwitness import witness

        self._probe_lock = witness(threading.Lock(), "HostGroup._probe_lock")
        self.link_rtts_ms: list = [None] * self.hosts  # guarded-by: _probe_lock
        self.slot_caps: list = [None] * self.hosts     # guarded-by: _probe_lock

    @property
    def devices(self) -> tuple:
        """Every device of the group, host-major (a mesh's ``devices``)."""
        return tuple(d for s in self.device_slices for d in s)

    # -- meshes ----------------------------------------------------------
    def mesh(self, h: int) -> Mesh:
        """Host h's 1-D shard mesh over its own device slice (cached): the
        mesh each per-host DistributedIndexTable shard runs on."""
        if h not in self._meshes:
            self._meshes[h] = Mesh(self.device_slices[h], SHARD_AXIS)
        return self._meshes[h]

    def flat_mesh(self) -> Mesh:
        """One host-major mesh over every device of the group: the flat
        DistributedIndexTable view of the same devices (the baseline the
        pod table is held bit-identical to)."""
        if self._flat_mesh is None:
            self._flat_mesh = Mesh(self.devices, SHARD_AXIS)
        return self._flat_mesh

    # -- per-host link profile -------------------------------------------
    def set_link_profile(self, rtts_ms: list, pull_mb_s: "list | None" = None) -> list:
        """Install per-host measured link RTTs and derive each host's
        fused slot cap through ``derive_link_constants``, per host, so one
        slow host's bigger amortization bucket never inflates its peers'
        pad-slot work. Returns the derived caps (None keeps the
        process-wide default for that host)."""
        from geomesa_tpu_torch.scan import block_kernels as bk

        if len(rtts_ms) != self.hosts:
            raise ValueError(f"need {self.hosts} RTTs, got {len(rtts_ms)}")
        caps = []
        for h, rtt in enumerate(rtts_ms):
            if rtt is None:
                caps.append(None)
                continue
            mbps = None if pull_mb_s is None else pull_mb_s[h]
            caps.append(int(bk.derive_link_constants(rtt, mbps)["fused_chunk_slots"]))
        with self._probe_lock:
            self.link_rtts_ms = list(rtts_ms)
            self.slot_caps = caps
        return caps

    def probe_links(self, samples: int = 3) -> list:
        """Measure each host's device->host pull RTT (the least of
        ``samples`` small round trips against the host's first device) and
        install the profile. Off by default (``geomesa.pod.link.probe``),
        so tests keep the compiled shapes."""
        rtts = []
        for h in range(self.hosts):
            buf = torch.zeros(1024, dtype=torch.float32, device=self.device_slices[h][0])
            best = None
            for _ in range(max(1, samples)):
                t0 = time.perf_counter()
                buf.cpu()
                dt = (time.perf_counter() - t0) * 1e3
                best = dt if best is None else min(best, dt)
            rtts.append(best)
        self.set_link_profile(rtts)
        return rtts

    def slot_cap(self, h: int) -> "int | None":
        with self._probe_lock:
            return self.slot_caps[h]

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"HostGroup(driver={self.driver!r}, hosts={self.hosts}, "
                f"devices_per_host={self.devices_per_host})")


def make_host_group(
    hosts: "int | None" = None,
    devices_per_host: "int | None" = None,
    driver: "str | None" = None,
    devices=None,
) -> HostGroup:
    """Resolve a host group from arguments and the ``geomesa.pod.*``
    knobs. ``driver`` is ``"distributed"``, ``"sim"`` or ``"auto"``
    (default: the ``geomesa.pod.driver`` knob): auto picks distributed
    only in a torch.distributed world of more than one process.
    ``devices``: the devices to slice (default: the visible cards).
    Raises :class:`PodUnsupported` when the distributed driver is asked
    for but cannot run here, and where too few devices back the hosts."""
    driver = (driver or conf.POD_DRIVER.get() or "auto").lower()
    if driver not in ("auto", "sim", "distributed"):
        raise ValueError(f"unknown pod driver {driver!r}")
    procs = world_size()
    if driver == "auto":
        driver = "distributed" if procs > 1 else "sim"
    devs = list(devices) if devices is not None else visible_devices()

    if driver == "distributed":
        if procs <= 1:
            verdict = probe_capability()
            if verdict.get("supported"):
                raise PodUnsupported(
                    "multi-process collectives work here, but this process is not "
                    "in a torch.distributed world of more than one process "
                    "(start one process per host, init_process_group, then "
                    "driver=distributed)"
                )
            raise PodUnsupported(
                "multi-process collectives unavailable: "
                f"{verdict.get('reason', 'probe verdict missing')}"
            )
        hosts = int(hosts or conf.POD_HOSTS.get() or procs)
        if hosts != procs:
            raise ValueError(f"distributed driver: hosts={hosts} != world size {procs}")
        dph = int(devices_per_host or conf.POD_DEVICES_PER_HOST.get() or len(devs))
        if dph <= 0 or dph > len(devs):
            raise PodUnsupported(f"distributed driver: {len(devs)} local devices, need {dph}")
        # every process names its own cards: host h's slice, as rank h sees it
        slices = [devs[:dph]] * hosts
    else:
        hosts = int(hosts or conf.POD_HOSTS.get() or 0)
        if hosts <= 0:
            raise ValueError(
                "sim driver needs an explicit host count (hosts= or the geomesa.pod.hosts knob)"
            )
        dph = int(devices_per_host or conf.POD_DEVICES_PER_HOST.get() or 0)
        if dph <= 0:
            if len(devs) < hosts:
                raise PodUnsupported(
                    f"sim driver: {len(devs)} devices cannot back {hosts} one-device hosts"
                )
            dph = len(devs) // hosts
        slices = host_major_slices(devs, hosts, dph)

    group = HostGroup(driver, slices)
    if conf.POD_LINK_PROBE.get():
        group.probe_links()
    return group
