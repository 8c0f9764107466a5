"""Multi-device execution: a shard mesh and host-merged shard scans.

The port of geomesa_tpu/parallel: the reference's shard fan-out is a
round-robin deal of scan blocks over a 1-D mesh of torch devices, and its
coprocessor aggregation a host merge of the shards' planes, counts,
grids and bounds (parallel.dtable).
"""

from geomesa_tpu_torch.parallel.dtable import DistributedIndexTable
from geomesa_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, make_mesh, make_multihost_mesh

__all__ = ["DistributedIndexTable", "Mesh", "make_mesh", "make_multihost_mesh", "SHARD_AXIS"]
