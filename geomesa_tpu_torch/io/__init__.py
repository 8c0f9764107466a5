"""IO tier: exporters, ingest converters, and storage formats (the
geomesa-features exporters + geomesa-convert + geomesa-fs Parquet
analogue, SURVEY.md §2.3/§2.4/§2.5).

The port's copy of geomesa_tpu/io. The Arrow, Parquet and ORC modules
import pyarrow inside their functions, so this package imports without
it."""

from geomesa_tpu_torch.io.converters import Converter, dbapi_records, infer_schema
from geomesa_tpu_torch.io.exporters import export

__all__ = ["export", "Converter", "dbapi_records", "infer_schema"]
