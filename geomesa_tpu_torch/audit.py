"""Query audit log: per-query events with plan + timing + hit counts.

The port's copy of geomesa_tpu/audit.py (reference AuditWriter.scala:31-63
and AuditedEvent).
The reference writes asynchronously to a backend table; here events append
to an in-process ring (bounded) and can be drained as dicts — the hook for
any external sink.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class AuditedEvent:
    """One query's audit record (reference QueryEvent). ``trace_id``
    cross-references the observability tier (docs/observability.md):
    when tracing is armed it carries the query's trace id, the same id
    the slow-query ring and the Chrome export (``pid``) use — so an
    audit row, a slow capture and a trace lane join on one key."""

    type_name: str
    filter: str
    strategy: str
    n_ranges: int
    hits: int
    planning_ms: float
    scanning_ms: float
    timestamp: float = field(default_factory=time.time)
    trace_id: "int | None" = None

    def to_json(self) -> dict:
        return {
            "typeName": self.type_name,
            "filter": self.filter,
            "strategy": self.strategy,
            "ranges": self.n_ranges,
            "hits": self.hits,
            "planTimeMillis": round(self.planning_ms, 3),
            "scanTimeMillis": round(self.scanning_ms, 3),
            "date": self.timestamp,
            "traceId": self.trace_id,
        }


class AuditWriter:
    """Bounded in-memory audit sink (drop-oldest)."""

    def __init__(self, capacity: int = 10_000):
        self.events: deque[AuditedEvent] = deque(maxlen=capacity)

    def write(self, event: AuditedEvent) -> None:
        self.events.append(event)

    def peek(self, type_name: "str | None" = None) -> list[dict]:
        """Non-destructive read of the ring (oldest first), optionally
        filtered by schema — the ops plane's ``/debug/audit`` body
        (``drain`` clears; a monitoring scrape must not). Safe against
        concurrent writers: iterating a deque a query thread is
        appending to raises RuntimeError, so the snapshot retries until
        it lands between appends (appends themselves are atomic)."""
        while True:
            try:
                events = list(self.events)
                break
            except RuntimeError:  # resized mid-iteration: retry
                continue
        return [
            e.to_json() for e in events
            if type_name is None or e.type_name == type_name
        ]

    def drain(self) -> list[dict]:
        out = [e.to_json() for e in self.events]
        self.events.clear()
        return out


class FileAuditWriter(AuditWriter):
    """Audit sink persisted as JSON lines (reference AuditWriter.scala:
    31-63 writes audited events to a backend table; the Accumulo variant
    persists QueryEvents — here one JSONL file plays that role). Events
    also stay in the in-memory ring for drain()."""

    def __init__(self, path: str, capacity: int = 10_000):
        super().__init__(capacity)
        self.path = path
        self._fh = open(path, "a", encoding="utf-8")

    def write(self, event: AuditedEvent) -> None:
        super().write(event)
        import json

        self._fh.write(json.dumps(event.to_json()) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def read(path: str) -> list[dict]:
        """Load persisted events back (analysis/inspection helper)."""
        import json

        with open(path, encoding="utf-8") as fh:
            return [json.loads(line) for line in fh if line.strip()]
