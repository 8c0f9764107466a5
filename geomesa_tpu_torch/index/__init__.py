"""Index layer: key spaces mapping features to sort keys and filters to
scan configurations (the port's Z3 and Z2 point indexes, the opt-in S3
and S2 point indexes, its XZ3 and XZ2 extent indexes, and the attribute
index)."""

from geomesa_tpu_torch.index.api import IndexKeySpace, ScanConfig, WriteKeys
from geomesa_tpu_torch.index.attribute import AttributeIndex
from geomesa_tpu_torch.index.s2 import S2Index, S3Index
from geomesa_tpu_torch.index.xz2 import XZ2Index
from geomesa_tpu_torch.index.xz3 import XZ3Index
from geomesa_tpu_torch.index.z2 import Z2Index
from geomesa_tpu_torch.index.z3 import Z3Index

__all__ = [
    "AttributeIndex", "IndexKeySpace", "S2Index", "S3Index", "ScanConfig", "WriteKeys",
    "XZ2Index", "XZ3Index", "Z2Index", "Z3Index",
]
