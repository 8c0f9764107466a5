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
- :class:`FeatureStream` — derived-view topologies over a change stream;
- :class:`StandingQueryEngine` / :class:`SubscriptionIndex` /
  :class:`Subscription` — standing queries: an inverted index over
  millions of persistent geofence / proximity / tube subscriptions,
  matched per arriving batch (the fused matcher launches K2 on a CUDA
  store), alerts into a bounded :class:`AlertQueue`, continuous
  :class:`WindowedAggregator` windows (:class:`WindowSpec`);
- :class:`SegmentShipper` / :class:`ReplicaStore` — WAL shipping to read
  replicas with bounded-staleness reads and term-fenced failover
  (:class:`PipeTransport`, :class:`SocketTransport`).
"""

from geomesa_tpu_torch.streaming.cache import StreamingFeatureCache
from geomesa_tpu_torch.streaming.flush import StreamConfig, StreamFlusher
from geomesa_tpu_torch.streaming.replica import (
    PipeTransport, ReplicaError, ReplicaStore, SegmentShipper, SocketTransport, StaleRead,
)
from geomesa_tpu_torch.streaming.standing import (
    AlertQueue, StandingConfig, StandingQueryEngine, Subscription, SubscriptionIndex,
    WindowedAggregator, WindowSpec,
)
from geomesa_tpu_torch.streaming.store import LambdaStore, RecordApplier
from geomesa_tpu_torch.streaming.stream import FeatureStream
from geomesa_tpu_torch.streaming.wal import WalConfig, WalError, WriteAheadLog

__all__ = [
    "StreamingFeatureCache", "StreamConfig", "StreamFlusher",
    "LambdaStore", "RecordApplier", "FeatureStream", "WalConfig", "WalError",
    "WriteAheadLog", "Subscription", "SubscriptionIndex", "StandingConfig",
    "StandingQueryEngine", "WindowSpec", "WindowedAggregator", "AlertQueue",
    "PipeTransport", "SocketTransport", "SegmentShipper", "ReplicaStore",
    "ReplicaError", "StaleRead",
]
