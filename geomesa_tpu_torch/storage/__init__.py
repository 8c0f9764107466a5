"""Storage: the sorted index tables, the delta tier, the adapter seam,
the catalog and persistence."""

from geomesa_tpu_torch.storage.table import IndexTable

__all__ = ["IndexTable"]
