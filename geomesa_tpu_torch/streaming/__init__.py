"""geomesa_tpu_torch.streaming: the streaming tier's write path.

The port's copy of geomesa_tpu/streaming/, as far as it is ported:

- :class:`StreamingFeatureCache` — the thread-safe live hot tier
  (upsert / expiry / listeners over a bucket grid; the
  KafkaFeatureCacheImpl analogue);
- :class:`StreamFlusher` / :class:`StreamConfig` — the persistent
  pipelined flush engine: warm parse/key/shard-sort workers, a bounded
  admission window, ``geomesa.stream.*`` metrics, one atomic publish per
  flush into ``DataStore.fold_upsert``;
- :class:`LambdaStore` — the hot/cold hybrid (reference LambdaDataStore):
  exact hot-wins-by-id reads under concurrent flushes, scheduler-admitted
  cold scans, WAL-backed durability and crash recovery;
- :class:`WriteAheadLog` / :class:`WalConfig` — the segmented,
  checksummed write-ahead log under the hot tier;
- :class:`FeatureStream` — derived-view topologies over a change stream.

Read replicas and WAL shipping (ROADMAP A10b) and standing queries
(A10c) are not ported yet.
"""

from geomesa_tpu_torch.streaming.cache import StreamingFeatureCache
from geomesa_tpu_torch.streaming.flush import StreamConfig, StreamFlusher
from geomesa_tpu_torch.streaming.store import LambdaStore, RecordApplier
from geomesa_tpu_torch.streaming.stream import FeatureStream
from geomesa_tpu_torch.streaming.wal import WalConfig, WalError, WriteAheadLog

__all__ = [
    "StreamingFeatureCache", "StreamConfig", "StreamFlusher",
    "LambdaStore", "RecordApplier", "FeatureStream", "WalConfig", "WalError",
    "WriteAheadLog",
]
