"""The ops plane: ``/health`` + ``/metrics`` endpoints over one store.

The port's copy of geomesa_tpu/obs/ops.py. ``DataStore.serve_ops(port)``
mounts a dependency-free threaded HTTP endpoint (stdlib ``http.server``,
loopback by default) exposing what the observability layer computes
in-process:

| path | serves |
|---|---|
| ``/metrics`` | Prometheus text exposition (``render_prometheus``) |
| ``/health`` | composite ready/degraded/unhealthy verdict + reasons |
| ``/stats`` | per-type StatsStore sketches as JSON |
| ``/debug/slow?type=&n=`` | the slow-query ring (filterable) |
| ``/debug/trace`` | Chrome trace-event export of retained traces |
| ``/debug/vars?window=`` | TelemetryRecorder time-series rings |
| ``/debug/audit?n=`` | the audit ring (trace-id cross-referenced) |
| ``/debug/tuning`` | the tuning tier's report (``DataStore.tuning_report``) |

The **health state machine** (:class:`HealthMonitor`): each check
contributes zero or more machine-readable reasons ``{"reason": code,
"severity": "degraded"|"unhealthy", "detail": ...}`` and the verdict is
the worst severity present — ``ready`` with no reasons (HTTP 200),
``degraded`` (still 200: serving, with caveats), ``unhealthy`` (503: load
balancers stop routing). Checks:

- ``store.quarantine`` (degraded): partitions quarantined at load (and
  damage a WAL replay quarantined);
- ``wal.needs_recovery`` (unhealthy): the attached LambdaStore's WAL
  holds mutation records past its last checkpoint cover — continuing
  would let a checkpoint retire acknowledged-but-unapplied records;
- ``slo.breach`` (degraded): an attached SLO objective's windowed
  quantile is over threshold (one reason per objective, burn rate in
  the detail);
- ``hot.occupancy`` (degraded): the streaming hot tier holds more than
  ``HOT_OCCUPANCY_FACTOR`` x ``fold_rows`` pending rows — flushes are
  falling behind;
- ``scheduler.shedding`` (degraded): queries were shed since the
  previous evaluation; ``scheduler.queue`` (degraded) past half the
  bounded queue; ``scheduler.saturated`` (unhealthy) at a FULL queue;
- ``standing.drops`` (degraded): the counter moved since the previous
  evaluation;
- ``replica.staleness`` (degraded): a follower's measured staleness
  watermark is over ``geomesa.replica.staleness.max.ms``, or unmeasured
  (no leader mark yet);
- ``replica.ship.giveup`` (degraded): the leader's SegmentShipper
  exhausted its retry budget (``geomesa.replica.giveup.s``) for a
  follower;
- ``stats.stale`` (degraded): a (type, index) p90 estimate error over
  ``geomesa.plan.estimate.stale.p90``.

The streaming reasons read the LambdaStore passed as ``lam``
(``LambdaStore.serve_ops`` passes itself); the verdict then also carries
a ``hot`` section (rows, fold_rows), and on a follower
(``ReplicaStore.serve_ops``) a ``replica`` section (staleness_ms,
replayed, term). The replica reasons read ``lam.replica`` (a follower's
backref) and ``lam.shipper`` (a leader's).

Counter-rate checks compare against the PREVIOUS evaluation's snapshot,
seeded at construction; the swap is one reference assignment, so
concurrent scrapes race only to report the same delta twice.

The **TelemetryRecorder** is the history half: a daemon thread sampling
the registry every ``geomesa.obs.ops.sample.ms`` into bounded rings
(every gauge, every counter, every histogram's p50/p99), so
``/debug/vars?window=120`` answers "what did p99 do over the last two
minutes" without an external store. Memory is bounded at series x
``geomesa.obs.ops.history`` points.

Nothing here launches device work: every route reads host state (the
registry, the sketches, the rings, the trace buffers).

Locking: ``TelemetryRecorder._lock`` guards only the rings; a sample
takes the registry snapshot BEFORE taking it, so it nests under nothing.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from geomesa_tpu_torch import conf
from geomesa_tpu_torch.metrics import resolve

#: pending hot-tier rows over this multiple of the fold threshold flag
#: ``hot.occupancy``: the overlay outgrew what one fold was sized to absorb
HOT_OCCUPANCY_FACTOR = 2.0


class TelemetryRecorder:
    """Background sampler writing bounded time-series rings of the
    registry's gauges, counters and histogram quantiles."""

    def __init__(self, metrics, interval_ms: "float | None" = None,
                 history: "int | None" = None):
        from geomesa_tpu_torch.lockwitness import witness

        self.metrics = resolve(metrics)
        self.interval_ms = float(
            interval_ms if interval_ms is not None else conf.OBS_OPS_SAMPLE_MS.get()
        )
        self.history = max(int(history if history is not None else conf.OBS_OPS_HISTORY.get()), 2)
        self._lock = witness(threading.Lock(), "TelemetryRecorder._lock")
        self._rings: dict = {}  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- sampling ---------------------------------------------------------
    def sample(self, now: "float | None" = None) -> int:
        """Take one sample (the loop body; tests drive it directly) and
        return the number of series touched. The registry snapshot and its
        quantiles are computed BEFORE the ring lock is taken."""
        t = time.time() if now is None else now
        snap = self.metrics.snapshot()
        points: list = [(k, v) for k, v in snap["gauges"].items()]
        points += [(k, float(v)) for k, v in snap["counters"].items()]
        for k, h in snap["histograms"].items():
            points.append((f"{k}.p50", h["p50_s"]))
            points.append((f"{k}.p99", h["p99_s"]))
        with self._lock:
            for name, value in points:
                ring = self._rings.get(name)
                if ring is None:
                    ring = self._rings[name] = deque(maxlen=self.history)
                ring.append((t, value))
        return len(points)

    def series(self, window_s: "float | None" = None, now: "float | None" = None) -> dict:
        """The ``/debug/vars`` payload: per series ``{"t": [...], "v":
        [...]}`` over the last ``window_s`` seconds (None = the whole
        retained ring)."""
        t_now = time.time() if now is None else now
        cutoff = None if window_s is None else t_now - float(window_s)
        with self._lock:
            snap = {k: list(r) for k, r in self._rings.items()}
        out = {}
        for name, pts in sorted(snap.items()):
            if cutoff is not None:
                pts = [p for p in pts if p[0] >= cutoff]
            if pts:
                out[name] = {
                    "t": [round(p[0], 3) for p in pts],
                    "v": [round(float(p[1]), 6) for p in pts],
                }
        return {"interval_ms": self.interval_ms, "history": self.history, "series": out}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "TelemetryRecorder":
        if self._thread is None:
            # restartable: stop() leaves the event set, and a fresh loop
            # must not see it and exit before its first sample
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, name="geomesa-telemetry",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        interval = max(self.interval_ms, 1.0) / 1e3
        while not self._stop.wait(interval):
            self.sample()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


class HealthMonitor:
    """The composite health state machine (module docstring) over one
    store."""

    #: counters the rate checks watch between evaluations
    RATE_COUNTERS = ("geomesa.serving.shed", "geomesa.standing.dropped")

    def __init__(self, store, lam=None):
        self.store = store
        self.lam = lam
        # the previous counter snapshot, SEEDED with the current totals:
        # the first evaluation measures "since this monitor existed", so
        # a shed storm from before serve_ops does not degrade the first
        # scrape. Replaced whole (one reference assignment)
        self._prev_counters: dict = self._counter_totals()

    def _counter_totals(self) -> dict:
        metrics = getattr(self.store, "metrics", None)
        if metrics is None:
            return {n: 0 for n in self.RATE_COUNTERS}
        return {n: metrics.counter_value(n) for n in self.RATE_COUNTERS}

    def _counter_deltas(self) -> dict:
        current = self._counter_totals()
        prev = self._prev_counters
        deltas = {n: current[n] - prev.get(n, 0) for n in current}
        self._prev_counters = current
        return deltas

    def evaluate(self) -> dict:
        reasons: list = []

        def add(reason: str, severity: str, detail: str) -> None:
            reasons.append({"reason": reason, "severity": severity, "detail": detail})

        store = self.store
        # store damage (partitions quarantined at load)
        health = getattr(store, "health", None)
        if health is not None and not health.ok:
            add(
                "store.quarantine", "degraded",
                f"{len(health.damage)} quarantined partition(s) over "
                f"types {sorted(health.degraded_types())}",
            )
        # streaming tier: WAL recovery debt and hot-tier occupancy
        lam = self.lam
        if lam is not None:
            wal = getattr(lam, "wal", None)
            if wal is not None and getattr(wal, "needs_recovery", False):
                add(
                    "wal.needs_recovery", "unhealthy",
                    "WAL holds mutation records past its last checkpoint "
                    "cover — open through LambdaStore.recover() before "
                    "serving writes",
                )
            hot_rows = len(lam.hot)
            fold_rows = max(int(lam.config.fold_rows), 1)
            if hot_rows > HOT_OCCUPANCY_FACTOR * fold_rows:
                add(
                    "hot.occupancy", "degraded",
                    f"hot tier holds {hot_rows} rows > "
                    f"{HOT_OCCUPANCY_FACTOR:g}x the {fold_rows}-row fold "
                    "threshold — flushes are falling behind ingest",
                )
            # replication: a follower's measured staleness watermark
            # against its bound, and the leader-side shipper's bounded
            # give-up
            replica = getattr(lam, "replica", None)
            if replica is not None:
                limit = float(conf.REPLICA_STALENESS_MAX_MS.get())
                st = replica.staleness_ms()
                if limit > 0 and (st is None or st > limit):
                    detail = (
                        "staleness unmeasured — no leader mark received "
                        "yet" if st is None
                        else f"measured staleness {st:.0f}ms > {limit:g}ms"
                    )
                    add(
                        "replica.staleness", "degraded",
                        f"{detail} (geomesa.replica.staleness.max.ms): "
                        f"replayed seqno {replica.replayed} lags the "
                        "leader — reads here answer from the past",
                    )
            shipper = getattr(lam, "shipper", None)
            if shipper is not None:
                stuck = shipper.gave_up_report()
                if stuck:
                    add(
                        "replica.ship.giveup", "degraded",
                        "segment shipping exhausted its retry budget "
                        f"(geomesa.replica.giveup.s) for follower(s) "
                        f"{sorted(stuck)} — they fall stale until the "
                        "transport recovers",
                    )
        # SLO objectives
        slo = store.slo_report()
        for row in slo["objectives"]:
            if not row["ok"]:
                add(
                    "slo.breach", "degraded",
                    f"{row['objective']}: {row['metric']} "
                    f"p{int(row['quantile'] * 100)} "
                    f"{row['value_ms']}ms > {row['threshold_ms']}ms "
                    f"(burn rate {row['burn_rate']})",
                )
        # serving tier: queue depth now, shed rate since the last evaluation
        deltas = self._counter_deltas()
        sched = getattr(store, "scheduler", None)
        scheduler_info = None
        if sched is not None and not sched.closed:
            depth = sched.queue_depth
            qmax = max(int(sched.conf.queue_max), 1)
            scheduler_info = {"queue_depth": depth, "queue_max": qmax}
            if depth >= qmax:
                add(
                    "scheduler.saturated", "unhealthy",
                    f"admission queue full ({depth}/{qmax}): new queries "
                    "only backpressure or shed",
                )
            elif depth >= (qmax + 1) // 2:
                add("scheduler.queue", "degraded", f"admission queue {depth}/{qmax} (over half)")
        if deltas["geomesa.serving.shed"] > 0:
            add(
                "scheduler.shedding", "degraded",
                f"{deltas['geomesa.serving.shed']} queries shed since "
                "the previous health evaluation",
            )
        if deltas["geomesa.standing.dropped"] > 0:
            add(
                "standing.drops", "degraded",
                f"{deltas['geomesa.standing.dropped']} standing alerts "
                "dropped from the bounded queue since the previous "
                "health evaluation",
            )
        # planner estimate accountability
        accuracy = getattr(store, "accuracy", None)
        estimates = accuracy.report() if accuracy is not None else None
        if accuracy is not None:
            for tname, iname, p90 in accuracy.stale():
                add(
                    "stats.stale", "degraded",
                    f"stats stale — re-analyze: {tname}/{iname} p90 "
                    f"estimate error {p90}x > "
                    f"{float(conf.PLAN_ESTIMATE_STALE_P90.get()):g}x "
                    f"(run analyze_stats({tname!r}))",
                )
        severities = {r["severity"] for r in reasons}
        status = (
            "unhealthy" if "unhealthy" in severities
            else "degraded" if reasons
            else "ready"
        )
        out = {"status": status, "reasons": reasons, "slo": slo, "estimates": estimates}
        if scheduler_info is not None:
            out["scheduler"] = scheduler_info
        if lam is not None:
            out["hot"] = {"rows": len(lam.hot), "fold_rows": int(lam.config.fold_rows)}
            replica = getattr(lam, "replica", None)
            if replica is not None:
                out["replica"] = {
                    "staleness_ms": replica.staleness_ms(),
                    "replayed": replica.replayed,
                    "term": replica.term,
                }
        return out


def stats_payload(store) -> dict:
    """The ``/stats`` payload: per-type sketch summaries
    (``StatsStore.to_json``)."""
    out = {}
    for tname in store.type_names():
        stats = store.stats_for(tname)
        out[tname] = None if stats is None else stats.to_json()
    return out


def ops_report(store, lam=None, monitor: "HealthMonitor | None" = None,
               slow_n: int = 10) -> dict:
    """One-shot ops snapshot without HTTP: the health verdict and
    reasons (SLO report and estimate accuracy inside) and the top-N slow
    queries."""
    if monitor is None:
        monitor = HealthMonitor(store, lam=lam)
    health = monitor.evaluate()
    slow = store.slow_queries()
    slow.sort(key=lambda e: e.get("wall_ms", 0.0), reverse=True)
    return {
        "health": health,
        "slow_queries": [
            {
                "wall_ms": e["wall_ms"],
                "fingerprint": e.get("fingerprint", {}),
                "trace_id": e.get("trace", {}).get("trace_id"),
            }
            for e in slow[:max(int(slow_n), 0)]
        ],
    }


class OpsRoutes:
    """The ops-plane route table without a socket: monitor, telemetry
    recorder and the ``handle()`` dispatch. :class:`OpsServer` wraps one
    for the ops port; the data plane (serving/http.py) mounts one on its
    own port, so a single listener serves data and ops."""

    #: paths this table answers (the data server's dispatch check)
    PATHS = (
        "/metrics", "/health", "/stats", "/debug/slow", "/debug/trace",
        "/debug/vars", "/debug/audit", "/debug/tuning",
    )

    def __init__(self, store, lam=None, audit=None):
        self.store = store
        self.lam = lam
        self.audit = audit if audit is not None else getattr(store, "audit", None)
        self.monitor = HealthMonitor(store, lam=lam)
        self.recorder = TelemetryRecorder(getattr(store, "metrics", None))

    def handle(self, path: str, query: dict):
        """Route one GET: returns (http status, content type, payload).
        Unknown paths 404."""
        metrics = resolve(getattr(self.store, "metrics", None))
        metrics.counter("geomesa.obs.ops.scrapes")
        if path == "/metrics":
            # the registry the serving path counts into (a store without
            # its own registry counts into the process-global one)
            return 200, "text/plain; version=0.0.4", metrics.render_prometheus()
        if path == "/health":
            report = self.monitor.evaluate()
            code = 503 if report["status"] == "unhealthy" else 200
            return code, "application/json", _json_dump(report)
        if path == "/stats":
            return 200, "application/json", _json_dump(stats_payload(self.store))
        if path == "/debug/slow":
            tname = _first(query, "type")
            n = int(_first(query, "n") or 0)
            slow = self.store.slow_queries(type_name=tname)
            if n > 0:
                slow = slow[-n:]
            return 200, "application/json", _json_dump(slow)
        if path == "/debug/trace":
            from geomesa_tpu_torch.obs.trace import tracer

            return 200, "application/json", _json_dump(tracer().chrome_payload())
        if path == "/debug/vars":
            window = _first(query, "window")
            return 200, "application/json", _json_dump(
                self.recorder.series(window_s=float(window) if window else None)
            )
        if path == "/debug/audit":
            if self.audit is None:
                return 200, "application/json", "[]"
            events = self.audit.peek()
            n = int(_first(query, "n") or 0)
            if n > 0:
                events = events[-n:]
            return 200, "application/json", _json_dump(events)
        if path == "/debug/tuning":
            # the self-tuning tier's audit surface: controller values,
            # bounds and readings, the plan factor table, the burn gate
            # and the decision ring with reasons
            return 200, "application/json", _json_dump(
                self.store.tuning_report()
                if hasattr(self.store, "tuning_report")
                else {"enabled": False, "controllers": [], "decisions": []}
            )
        return 404, "application/json", _json_dump({"error": f"unknown path {path!r}"})


class OpsServer:
    """The threaded HTTP ops endpoint over one store (module docstring).
    ``DataStore.serve_ops()`` builds, starts and attaches one; close()
    releases the socket and joins the serve and telemetry threads —
    idempotent, and called by ``DataStore.close()``."""

    def __init__(self, store, lam=None, host: "str | None" = None, port: int = 0,
                 audit=None):
        self.store = store
        self.lam = lam
        self.routes = OpsRoutes(store, lam=lam, audit=audit)
        self.audit = self.routes.audit
        self.monitor = self.routes.monitor
        self.recorder = self.routes.recorder
        self.host = host if host is not None else str(conf.OBS_OPS_HOST.get())
        self._httpd = _Httpd((self.host, int(port)), _handler_class(self))
        self._thread: "threading.Thread | None" = None
        self._closed = False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def closed(self) -> bool:
        return self._closed

    def start(self) -> "OpsServer":
        if self._thread is None:
            self._thread = threading.Thread(target=self._httpd.serve_forever, name="geomesa-ops",
                                            daemon=True)
            self._thread.start()
            self.recorder.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting, close the listening socket (the port rebinds at
        once: reuse-addr is set), join the serve thread (bounded), stop
        the telemetry sampler. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            # shutdown() waits for serve_forever to return: only once started
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.recorder.stop(timeout)

    def __enter__(self) -> "OpsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def handle(self, path: str, query: dict):
        """Route one GET (delegates to the route table)."""
        return self.routes.handle(path, query)


class _Httpd(ThreadingHTTPServer):
    # without reuse-addr a close-then-reopen on the same port fails with
    # EADDRINUSE while the old socket lingers in TIME_WAIT
    allow_reuse_address = True
    daemon_threads = True


def _handler_class(server: OpsServer):
    """A BaseHTTPRequestHandler bound to one OpsServer (a closure, so two
    mounted stores never share state)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib naming)
            url = urlparse(self.path)
            try:
                code, ctype, payload = server.handle(url.path, parse_qs(url.query))
            except BrokenPipeError:  # the client went away mid-handle
                return
            except Exception as e:  # a failed route answers 500 with its error
                code, ctype, payload = 500, "application/json", _json_dump(
                    {"error": f"{type(e).__name__}: {e}"}
                )
            body = payload.encode() if isinstance(payload, str) else payload
            try:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass

        def log_message(self, *args) -> None:  # scrapes stay out of stderr
            pass

    return Handler


def _first(query: dict, key: str):
    vals = query.get(key)
    return vals[0] if vals else None


def _json_dump(payload) -> str:
    return json.dumps(payload, default=str)
