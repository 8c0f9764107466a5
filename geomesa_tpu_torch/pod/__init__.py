"""Multi-host pod tier: a host-group layer over the mesh scan path.

The port of geomesa_tpu/pod. A :class:`~geomesa_tpu_torch.pod.hostgroup.
HostGroup` names H hosts and their per-host device slices behind two
drivers (a torch.distributed world, or an in-process simulation over
device slices); a :class:`~geomesa_tpu_torch.pod.table.PodIndexTable`
deals the sorted table's blocks host-major, so each host owns one
contiguous shard and a selective query launches only on owning hosts; a
:class:`~geomesa_tpu_torch.pod.store.PodStore` shards the streaming tier:
per-host WAL and hot tier with host-local acks, host-local bulk ingest
and per-host standing-subscription shards.
"""

from geomesa_tpu_torch.pod.hostgroup import (
    HostGroup,
    PodUnsupported,
    make_host_group,
    probe_capability,
)
from geomesa_tpu_torch.pod.store import PodStore
from geomesa_tpu_torch.pod.table import PodIndexTable

__all__ = [
    "HostGroup",
    "PodIndexTable",
    "PodStore",
    "PodUnsupported",
    "make_host_group",
    "probe_capability",
]
