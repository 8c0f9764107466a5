"""SQL-style spatial analytics: the geomesa-spark analogue.

- ``functions``: the ST_* function library (spark-jts UDFs,
  geomesa-spark/geomesa-spark-jts/.../udf/)
- ``join``: grid-partitioned spatial join (GeoMesaJoinRelation,
  geomesa-spark/geomesa-spark-sql/.../GeoMesaRelation.scala:69-91)

The port's copy of geomesa_tpu/sql/__init__.py,
held to it by the CPU parity tests.
"""

from geomesa_tpu_torch.sql.functions import FUNCTIONS, st_call
from geomesa_tpu_torch.sql.join import spatial_join, spatial_join_indexed
from geomesa_tpu_torch.sql.query import sql_query

__all__ = ["FUNCTIONS", "st_call", "spatial_join", "spatial_join_indexed", "sql_query"]
