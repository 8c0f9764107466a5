"""Continuous derived computation over a feature change stream.

The port's copy of geomesa_tpu/streaming/stream.py (reference: the
geomesa-kafka streams tier, GeoMesaStreamsBuilder and GeoMesaMessage).
"""

from __future__ import annotations

from typing import Callable

from geomesa_tpu_torch.streaming.cache import StreamingFeatureCache


class FeatureStream:
    """Build a topology over a StreamingFeatureCache:

        FeatureStream.wrap(cache).filter(pred).map(fn).to(sink)

    - ``filter(fn)``: keep events where ``fn(row) -> bool`` (delete /
      expire events always propagate — a derived view must not retain
      rows its source dropped);
    - ``map(fn)``: ``fn(row) -> row`` transforms upserted rows;
    - ``to(sink)``: terminal stage. A StreamingFeatureCache or
      LambdaStore receives upsert/delete mirrors; a callable receives
      ``(action, fid, row)`` messages ("upsert" | "delete").

    Stages apply to every FUTURE cache event (the topology subscribes a
    listener); existing cache contents replay into the sink at wiring
    time so a late-built view starts complete, like a streams app
    reading a compacted topic from the beginning.
    """

    def __init__(self, source: StreamingFeatureCache):
        self.source = source
        self._stages: list[tuple[str, Callable]] = []

    @staticmethod
    def wrap(cache: StreamingFeatureCache) -> "FeatureStream":
        return FeatureStream(cache)

    def filter(self, fn: Callable) -> "FeatureStream":
        self._stages.append(("filter", fn))
        return self

    def map(self, fn: Callable) -> "FeatureStream":
        self._stages.append(("map", fn))
        return self

    def _apply(self, row: "dict | None"):
        """Run the stage pipeline; None = dropped."""
        if row is None:
            return None
        for kind, fn in self._stages:
            if kind == "filter":
                if not fn(row):
                    return None
            else:
                row = fn(dict(row))
        return row

    def to(self, sink) -> "FeatureStream":
        """Terminal: replay current state, then mirror future events.
        Sinks: a StreamingFeatureCache (upsert/delete), a LambdaStore
        (write; deletes drop the HOT copy — already-persisted cold rows
        are the flush's business), or a callable ``(action, fid, row)``."""
        if hasattr(sink, "upsert"):
            def emit(action, fid, row):
                if action == "upsert":
                    sink.upsert([row], ids=[fid])
                else:
                    sink.delete([fid])
        elif hasattr(sink, "write"):
            hot = getattr(sink, "hot", None)

            def emit(action, fid, row):
                if action == "upsert":
                    sink.write([row], ids=[fid])
                elif hot is not None:
                    hot.delete([fid])
        elif callable(sink):
            emit = sink
        else:
            raise TypeError(
                f"unsupported stream sink {type(sink).__name__}: needs "
                "upsert()/write() or a callable"
            )

        def on_event(event, fid, row):
            if event in ("removed", "expired"):
                emit("delete", fid, None)
                return
            out = self._apply(dict(row) if row is not None else None)
            if out is not None:
                emit("upsert", fid, out)
            elif event == "updated":
                # the update filtered OUT a previously-passing row: the
                # derived view must drop it
                emit("delete", fid, None)

        for fid, row in self.source.snapshot_rows():
            out = self._apply(dict(row))
            if out is not None:
                emit("upsert", fid, out)
        self.source.listeners.append(on_event)
        return self
