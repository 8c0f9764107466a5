"""Device mesh helpers for the distributed scan path.

The port of geomesa_tpu/parallel/mesh.py. The reference spreads hot
ranges over tablet servers with a shard prefix and fans scans out over
server-side RPC; here a 1-D :class:`Mesh` names D torch devices, the
table's scan blocks are dealt round-robin over them (parallel.dtable),
every shard launches its own kernel on its own device, and the host
merges the shards' planes and partial aggregates.

The mesh is single-controller: one process drives every shard, as one
JAX process drives a ``shard_map``, so no collective library is needed.
A mesh's devices may repeat: ``make_mesh(devices=["cpu"] * 8)`` is the
counterpart of the JAX package's virtual 8-device CPU mesh (torch has no
virtual device count), and ``["cuda:0"] * 8`` deals eight shards onto
one card, each shard its own kernel launches. ``make_mesh(n)`` takes the
first n visible cards and raises when fewer exist.

The JAX module's ``shard_spec`` / ``replicated_spec`` (``NamedSharding``
constructors) have no counterpart: a shard's tensors are placed on its
device when the table deals them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

SHARD_AXIS = "shard"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: D torch devices (repeats allowed) under one axis name."""

    devices: tuple
    axis: str = SHARD_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        """The one device type of every shard (a mesh never mixes them)."""
        return self.devices[0].type


def visible_devices() -> list:
    """The CUDA devices this process can address, in ordinal order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh(devs, axis: str) -> Mesh:
    devs = tuple(torch.device(d) for d in devs)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    types = {d.type for d in devs}
    if len(types) != 1:
        raise ValueError(f"a mesh mixes device types {sorted(types)}")
    return Mesh(devs, axis)


def make_mesh(n_devices: int | None = None, devices=None, axis: str = SHARD_AXIS) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible cards, or over the
    explicit ``devices`` list (which may repeat a device: the virtual
    mesh). Raises when fewer devices exist than asked for."""
    devs = list(devices) if devices is not None else visible_devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"asked for {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return _mesh(devs, axis)


def world_size() -> int:
    """Processes in the torch.distributed world (1 outside one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def make_multihost_mesh(
    hosts: int | None = None,
    devices_per_host: int | None = None,
    axis: str = SHARD_AXIS,
    devices=None,
) -> Mesh:
    """A 1-D scan mesh over a multi-host group, devices ordered
    host-major: every contiguous ``devices_per_host`` run of the axis is
    one host's, so a merge crosses hosts once per host group. ``hosts``
    defaults to the torch.distributed world size (1 outside one);
    single-process runs slice the given or visible devices into hosts."""
    devs = list(devices) if devices is not None else visible_devices()
    if hosts is None:
        hosts = world_size()
    if devices_per_host is None:
        if len(devs) % hosts:
            raise ValueError(f"{len(devs)} devices do not divide over {hosts} hosts")
        devices_per_host = len(devs) // hosts
    return _mesh(_host_major(devs, hosts, devices_per_host), axis)


def host_major_slices(devs, hosts: int, devices_per_host: int) -> list:
    """Per-host device slices, host-major: ``out[h]`` is host h's
    ``devices_per_host`` devices. Devices that carry a ``process_index``
    group by it (one host per process); otherwise the one process's
    devices slice into synthetic hosts. The shared layout authority:
    ``make_multihost_mesh`` concatenates the slices into one flat axis,
    and the pod tier (pod.hostgroup) builds one per-host shard mesh from
    each slice, so both see the same device-to-host assignment."""
    by_host: dict = {}
    for d in devs:
        by_host.setdefault(getattr(d, "process_index", 0), []).append(d)
    if len(by_host) >= hosts > 1:
        out = []
        for h in sorted(by_host)[:hosts]:
            hd = by_host[h]
            if len(hd) < devices_per_host:
                raise ValueError(f"host {h} has {len(hd)} devices, need {devices_per_host}")
            out.append(hd[:devices_per_host])
        return out
    n = hosts * devices_per_host
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    return [list(devs[h * devices_per_host : (h + 1) * devices_per_host]) for h in range(hosts)]


def _host_major(devs, hosts: int, devices_per_host: int) -> list:
    """Flat host-major device order (see ``host_major_slices``)."""
    return [d for hd in host_major_slices(devs, hosts, devices_per_host) for d in hd]
