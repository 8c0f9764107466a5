"""The port's lock model: registry, acquisition graph, rank order.

The port of geomesa_tpu/analysis/lockmodel.py, aimed at the port's
lock-bearing modules (the same classes, the same locks, the same
ranks). The hard bugs of the JAX package's concurrent tiers were races
(the WAL/checkpoint acknowledged-loss races a chaos harness caught, the
``_take_staged`` write-back and ``_rotate`` sync-horizon races). The
reference delegates this bug class to the JVM memory model and
battle-tested region-server code; this build owns its lock-bearing
modules outright, so — following the
lock-guarded-mutation precedent — the locking DESIGN itself becomes a
machine-checked artifact:

- :data:`LOCKS` — the registry, ONE entry per production lock: dotted
  ``Class.attr`` name, declared **rank** (locks may only be acquired in
  strictly increasing rank order — the FindBugs-era GoodLock discipline),
  a **hot** flag (scopes holding a hot lock must never block on IO,
  futures or sleeps — the blocking-under-lock rule), and the **guarded
  fields** the ``# guarded-by:`` annotations declare (cross-checked both
  directions);
- :data:`DECLARED_EDGES` — acquisition-order edges real control flow
  takes through CALLBACKS the AST cannot resolve (the hot tier's
  WAL/unstage hooks, fault points consulting a chaos schedule). Each
  carries its justification and still must respect the rank order;
- :class:`LockModel` — the compositional analysis (the RacerD move:
  per-method lock-acquisition summaries joined to a fixpoint, one level
  of ``self.attr`` type inference from constructor assignments): every
  lock construction site discovered, every statically visible
  acquisition edge derived with its witness location.

The model is consumed three ways: the ``analysis/rules/concurrency.py``
rule family (static tier), ``tests/test_torch_lockwitness.py`` (the
dynamic tier proves observed runtime edges are a subgraph of the model
and that every registered lock is actually witnessed — both directions,
the way ``fault-point-unknown`` proves fault points are reached), and
``tests/test_torch_analysis.py`` (registry hygiene: unique ranks, every
entry constructed through the witness under its own name).

Locks outside the concurrent tiers (a module-level memo lock with no
nesting, e.g. ``planning/planner.py``'s config-memo lock) are still
DISCOVERED and participate in cycle checks, but only locks in
:data:`ENFORCED_SCOPES` must carry a registry entry. Fixtures and
adopter code can declare ranks inline instead: a trailing
``# lock-rank: <N>`` (optionally ``# lock-rank: <N> hot``) comment on
the lock construction line, mirroring ``# guarded-by:``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Optional

from geomesa_tpu_torch.analysis.core import (
    Project,
    SourceFile,
    call_name,
    const_str,
    self_attr,
)

#: mutual-exclusion constructors the model tracks (Semaphore/Event are
#: deliberately out: they are signaling primitives, not critical-section
#: owners, and the ordering discipline does not apply to them)
LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}

#: the witness wrapper (geomesa_tpu_torch/lockwitness.py): construction sites
#: read ``witness(threading.RLock(), "<Class.attr>")`` — the model (and
#: the lock-guarded-mutation rule) look through it
WITNESS_WRAPPER = "witness"

_RANK_RE = re.compile(r"#\s*lock-rank:\s*(\d+)(\s+hot)?")
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*(?:self\.)?(\w+)")
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*(?:self\.)?(\w+)")


@dataclass(frozen=True)
class LockDecl:
    """One registry entry: the declared half of the lock model."""

    name: str            # "Class.attr" (the witness name, the doc name)
    path: str            # module that constructs it
    rank: int            # strict acquisition order: lower acquires first
    hot: bool = False    # hot-path lock: no blocking calls while held
    fields: tuple = ()   # the `# guarded-by:` fields it protects
    doc: str = ""


def _d(name, path, rank, hot=False, fields=(), doc=""):
    return LockDecl(name, path, rank, hot, tuple(fields), doc)


#: THE lock registry — single source of truth for rank order, hot-path
#: classification and guarded-field coverage across the concurrent
#: tiers. Rank numbers are sparse on purpose (new locks slot between
#: neighbors without renumbering). Outermost (lowest rank) first.
LOCKS: dict[str, LockDecl] = {d.name: d for d in [
    _d("HostGroup._probe_lock", "geomesa_tpu_torch/pod/hostgroup.py", 6,
       fields=("link_rtts_ms", "slot_caps"),
       doc="per-host link profile (probed RTTs + derived fused slot "
           "caps): a LEAF acquired before any store/table lock — "
           "profiles install at group construction, before tables "
           "build, and shard builds only READ the caps after release"),
    _d("PodStore._route_lock", "geomesa_tpu_torch/pod/store.py", 8,
       fields=("_next_id",),
       doc="pod-level id assignment for ownership routing: ranks BELOW "
           "every host store's locks (DataStore._write_lock 10 up) "
           "because a routed write next descends into one host's "
           "LambdaStore; held only around the id counter, never across "
           "host calls"),
    _d("DataStore._write_lock", "geomesa_tpu_torch/datastore.py", 10,
       fields=("_publish_seq", "_fold_progress"),
       doc="store mutation lock: writes/compactions/folds serialize; "
           "outermost by design (long holds around device builds)"),
    _d("DataStore._id_lock", "geomesa_tpu_torch/datastore.py", 12,
       doc="per-chunk id-index entry cache only; readers skip the "
           "write lock"),
    _d("SegmentShipper._lock", "geomesa_tpu_torch/streaming/replica.py", 14,
       fields=("_followers", "_gave_up", "_seq"),
       doc="shipper bookkeeping only (follower table, give-up report, "
           "attach ids); never held across WAL reads, transport sends "
           "or metrics — the pump snapshots under it then ships "
           "outside"),
    _d("ReplicaStore._apply_lock", "geomesa_tpu_torch/streaming/replica.py", 16,
       fields=("_replayed", "_term", "_marks"),
       doc="follower watermark state (replayed seqno, witnessed term, "
           "staleness marks); pure bookkeeping — apply/promote do all "
           "store, WAL and file work OUTSIDE it"),
    _d("QueryScheduler._cond", "geomesa_tpu_torch/serving/scheduler.py", 20,
       hot=True,
       fields=("_queues", "_depth", "_closed", "_thread"),
       doc="admission queue condition: every submit/dispatch crosses it "
           "(per-tenant deques + the shared depth counter)"),
    _d("TenantRegistry._lock", "geomesa_tpu_torch/serving/tenancy.py", 22,
       fields=("_tenants",),
       doc="multi-tenant fairness table (weights, quotas, accounting): "
           "a LEAF by design — the scheduler reads quotas/weights "
           "BEFORE taking its condition, accounting lands after locks "
           "release, and per-tenant SLO observations go through each "
           "tenant's own SloTracker lock after this one releases"),
    _d("BulkLoader._cv", "geomesa_tpu_torch/ingest/pipeline.py", 24,
       fields=("_chunks", "_rows_staged", "_closed", "_error", "_writer"),
       doc="staged-chunk condition between producers and the ordered "
           "writer"),
    _d("BulkLoader._stage_lock", "geomesa_tpu_torch/ingest/pipeline.py", 26,
       fields=("_stage_s", "_peak_chunk_bytes"),
       doc="stage wall-time accounting"),
    _d("StreamingFeatureCache._lock", "geomesa_tpu_torch/streaming/cache.py", 30,
       hot=True,
       fields=("index", "_rows", "_ingest_ms", "_next_id", "_ids_version",
               "_live_cache", "_replaying"),
       doc="THE hot-tier lock: every streaming write, snapshot and "
           "query serializes here; WAL/unstage hooks run under it"),
    _d("StreamFlusher._stage_lock", "geomesa_tpu_torch/streaming/flush.py", 34,
       fields=("_staged", "_staged_rows"),
       doc="pre-staged fold chunks; acquired under the hot lock by the "
           "delete/expire unstage hooks, so it ranks above it"),
    _d("StreamFlusher._pool_lock", "geomesa_tpu_torch/streaming/flush.py", 36,
       fields=("_pool",),
       doc="flush worker-pool lifecycle"),
    _d("LambdaStore._sub_lock", "geomesa_tpu_torch/streaming/store.py", 38,
       fields=("_sub_records",),
       doc="standing-subscription registry vs checkpoint re-log "
           "(streaming/store.py): subscribe/unsubscribe and the "
           "checkpoint's live-set re-log serialize so an acknowledged "
           "unsubscribe's rm record can never be outrun by a re-logged "
           "registration on replay; held AROUND the WAL appends and "
           "SubscriptionIndex mutations those paths make (rank above)"),
    _d("WriteAheadLog._sync_lock", "geomesa_tpu_torch/streaming/wal.py", 40,
       fields=("_synced_seq", "_last_sync_t", "_durable_bytes"),
       doc="commit (write+fsync) order; fsync happens HERE, never under "
           "the append lock"),
    _d("WriteAheadLog._lock", "geomesa_tpu_torch/streaming/wal.py", 42,
       hot=True,
       fields=("_buffer", "_pending", "_closed", "_fd", "_active_path",
               "_active_start", "_active_bytes", "_last_seq", "_term"),
       doc="append buffer/seqno/fd state: every acknowledged write "
           "crosses it, so nothing may block while holding it"),
    _d("SubscriptionIndex._lock", "geomesa_tpu_torch/streaming/standing.py", 44,
       hot=True,
       fields=("_ids", "_by_id", "_alive", "_alive_arr", "_kind_l",
               "_attrs", "_edges_l", "_bbox_l", "_rect_l", "_prox",
               "_tube", "_rast", "_csr", "_overlay", "_overlay_n",
               "_bulk", "_arrays", "_kernel_blocks"),
       doc="the inverted subscription index: registrations, the CSR "
           "routing tables and the kernel-block memo; route() snapshots "
           "under it then expands candidates outside (pure numpy only "
           "while held — it sits on every batch's match path)"),
    _d("_MatchGate._lock", "geomesa_tpu_torch/streaming/standing.py", 45,
       hot=True,
       fields=("_host", "_fused"),
       doc="fused/host cost-gate EWMAs: read by every batch's candidate "
           "pick and updated after every matcher path runs — pure "
           "arithmetic under it, no other lock ever held"),
    _d("WindowedAggregator._lock", "geomesa_tpu_torch/streaming/standing.py", 46,
       hot=True,
       fields=("_panes",),
       doc="continuous-window pane partials: folded per batch on the "
           "match path, and under the hot-tier lock when the aggregator "
           "is wired as a FeatureStream sink (listeners fire under it)"),
    _d("AlertQueue._lock", "geomesa_tpu_torch/streaming/standing.py", 48,
       hot=True,
       fields=("_q", "_n", "_dropped"),
       doc="bounded alert queue: producers enqueue on the match path, "
           "consumers drain concurrently; overflow drops under the "
           "lock, counters record after it releases"),
    _d("ResultCache._lock", "geomesa_tpu_torch/cache/result.py", 50,
       hot=True,
       fields=("_entries", "_inflight", "_bytes"),
       doc="result-cache LRU + single-flight bookkeeping (probed at "
           "admission by the serving tier)"),
    _d("TileAggregateCache._lock", "geomesa_tpu_torch/cache/tiles.py", 52,
       fields=("_tiles", "_scan_s", "_compose_s", "_probe"),
       doc="tile LRU + adaptive cost-gate EWMAs"),
    _d("TilePyramid._lock", "geomesa_tpu_torch/tiles/pyramid.py", 54,
       fields=("_deltas", "_dirty_leaves", "_leaf_scan_s"),
       doc="pyramid delta accounting + leaf-scan cost EWMA: taken "
           "briefly by note_delta (under the store write lock) and "
           "after a leaf scan completes — never held across a scan or "
           "another cache tier's lock"),
    _d("GenerationTracker._lock", "geomesa_tpu_torch/cache/generations.py", 60,
       hot=True,
       fields=("_tick", "_types"),
       doc="generation bumps/staleness checks; acquired under the hot "
           "and cache locks on every mutation"),
    _d("ChaosSpec._lock", "geomesa_tpu_torch/fault.py", 70,
       hot=True,
       fields=("hits", "fired", "log"),
       doc="seeded chaos schedule state; consulted at fault points, "
           "which fire under arbitrary outer locks"),
    _d("EstimateAccuracy._lock", "geomesa_tpu_torch/obs/accuracy.py", 74,
       hot=True,
       fields=("_windows", "_analyzing"),
       doc="per-(type, index) estimate-vs-actual error windows: fed on "
           "every query's record path (possibly under the store write "
           "lock — modify_features queries in-lock), read by /health; "
           "only arithmetic runs under it and it acquires no other "
           "lock"),
    _d("Tracer._lock", "geomesa_tpu_torch/obs/trace.py", 76,
       hot=True,
       fields=("buffer", "slow", "_n_roots"),
       doc="trace retention rings + sampling counter: taken once per "
           "root begin/end, never per child span; nothing blocking "
           "runs under it and it acquires no other lock"),
    _d("TuningManager._lock", "geomesa_tpu_torch/tuning/manager.py", 77,
       fields=("_queries", "_pulses", "_pulsing", "_decisions"),
       doc="tuning pacing counters + the decision ring + the pulse "
           "claim flag: a LEAF by design — every sense/adjust step "
           "(metrics reads, accuracy report, SLO burn, conf writes) "
           "runs OUTSIDE it between claim and release; only arithmetic "
           "and the deque extend ever hold it"),
    _d("TelemetryRecorder._lock", "geomesa_tpu_torch/obs/ops.py", 79,
       fields=("_rings",),
       doc="telemetry history rings: the 1 Hz sampler appends points "
           "computed BEFORE the lock (the registry snapshot never runs "
           "under it), /debug/vars scrapes copy under it"),
    _d("SloTracker._lock", "geomesa_tpu_torch/obs/slo.py", 78,
       hot=True,
       fields=("_windows",),
       doc="SLO sliding windows: observations arrive via the registry "
           "observer hook (invoked OUTSIDE the registry lock) under "
           "arbitrary store locks, so it nests innermost-but-one"),
    _d("MetricsRegistry._lock", "geomesa_tpu_torch/metrics.py", 80,
       hot=True,
       fields=("counters", "gauges", "timers", "histograms"),
       doc="innermost by design: instruments are recorded under every "
           "other lock in the tree"),
]}

#: acquisition edges real control flow takes through callbacks the AST
#: cannot resolve statically (hooks, listeners, injected fault points).
#: Each entry: (source lock, acquired lock, justification). They are
#: part of the PREDICTED graph the dynamic witness checks against, and
#: the rank checker validates them like any AST-derived edge.
DECLARED_EDGES: list[tuple[str, str, str]] = [
    ("StreamingFeatureCache._lock", "WriteAheadLog._lock",
     "delete/expire log apply-then-record atomically under the hot lock "
     "via the after_remove/on_swept hooks (LambdaStore._removed_hook)"),
    ("StreamingFeatureCache._lock", "WriteAheadLog._sync_lock",
     "the hook's WAL append group-commits (sync=always) while the hot "
     "lock is held"),
    ("StreamingFeatureCache._lock", "StreamFlusher._stage_lock",
     "the delete/expire hooks unstage removed rows' pre-staged fold "
     "chunks under the hot lock"),
    ("StreamingFeatureCache._lock", "GenerationTracker._lock",
     "hot-tier mutations bump the wired cold-cache generations under "
     "the hot lock (_bump_gen)"),
    ("StreamingFeatureCache._lock", "MetricsRegistry._lock",
     "listener-error counters and hook-side instruments record under "
     "the hot lock"),
    ("StreamingFeatureCache._lock", "ChaosSpec._lock",
     "WAL fault points consulted by the hook path while the hot lock "
     "is held"),
    ("WriteAheadLog._sync_lock", "ChaosSpec._lock",
     "the stream.wal.sync fault point fires under the sync lock and "
     "consults an armed chaos schedule"),
    ("WriteAheadLog._lock", "ChaosSpec._lock",
     "the stream.wal.append fault point can re-fire inside retry paths "
     "holding the append lock"),
    ("DataStore._write_lock", "StreamingFeatureCache._lock",
     "fold/flush publishes run under the store write lock and snapshot "
     "or evict the hot tier"),
    ("DataStore._write_lock", "QueryScheduler._cond",
     "the sliced fold's pacer (fold_yield) waits for the scheduler's "
     "admission queue to drain between slices"),
    ("DataStore._write_lock", "StreamFlusher._stage_lock",
     "the fold consumes pre-staged chunks under the write lock"),
    ("DataStore._write_lock", "StreamFlusher._pool_lock",
     "the fold's commit path ensures the warm pool under the write lock"),
    ("DataStore._write_lock", "WriteAheadLog._sync_lock",
     "flush watermarks append (and group-commit) inside the publish"),
    ("DataStore._write_lock", "WriteAheadLog._lock",
     "flush watermarks append inside the publish"),
    ("DataStore._write_lock", "GenerationTracker._lock",
     "every committed mutation bumps generations"),
    ("DataStore._write_lock", "TileAggregateCache._lock",
     "mutation-side cache sweeps touch the tile tier"),
    ("DataStore._write_lock", "TilePyramid._lock",
     "every committed mutation's on_mutation forwards delta-to-tile "
     "accounting to the attached pyramid (note_delta) under the write "
     "lock"),
    ("DataStore._write_lock", "ResultCache._lock",
     "mutation-side cache sweeps touch the result tier"),
    ("DataStore._write_lock", "ChaosSpec._lock",
     "persist/flush fault points fire inside write-locked publishes"),
    ("DataStore._write_lock", "MetricsRegistry._lock",
     "publish/flush instruments record under the write lock"),
    ("QueryScheduler._cond", "MetricsRegistry._lock",
     "queue-full shed/backpressure counters record under the condition"),
    ("BulkLoader._cv", "MetricsRegistry._lock",
     "writer-loop stage accounting records under the condition"),
    ("DataStore._write_lock", "SloTracker._lock",
     "the sliced fold's per-slice histogram observation fans out to "
     "the attached SLO tracker through the registry observer hook "
     "(invoked after the registry lock releases, write lock still "
     "held)"),
    ("QueryScheduler._cond", "Tracer._lock",
     "a shed or closed-scheduler admission finishes the caller's trace "
     "root (Tracer.end retains it) while the condition is held"),
    ("DataStore._write_lock", "Tracer._lock",
     "maintenance ops that query inside their write-locked section "
     "(modify_features) begin/end the query's trace root there"),
    ("StreamingFeatureCache._lock", "SloTracker._lock",
     "the hook path's WAL fsync histogram observation reaches the SLO "
     "windows through the registry observer hook under the hot lock"),
    ("StreamingFeatureCache._lock", "WindowedAggregator._lock",
     "a WindowedAggregator wired as a FeatureStream sink folds rows "
     "inside the hot tier's listener callback, which fires under the "
     "hot lock (streaming/standing.py WindowedAggregator)"),
    ("LambdaStore._sub_lock", "SubscriptionIndex._lock",
     "subscribe/unsubscribe mutate the inverted index (register/"
     "unregister) while holding the subscription-registry lock — the "
     "lazily-attached engine is behind self.standing(), one hop past "
     "the AST's one-level attr inference"),
    ("LambdaStore._sub_lock", "ChaosSpec._lock",
     "the WAL append/sync fault points consult an armed chaos schedule "
     "inside log_subscribe/log_unsubscribe under the registry lock"),
    ("LambdaStore._sub_lock", "SloTracker._lock",
     "the subscribe-path WAL fsync histogram observation reaches the "
     "SLO windows through the registry observer hook under the "
     "registry lock"),
    ("DataStore._write_lock", "EstimateAccuracy._lock",
     "maintenance ops that query inside their write-locked section "
     "(modify_features) reach record_query's estimate-accountability "
     "record while the write lock is held"),
    # the one edge the port's model adds to the reference's: both
    # packages' runtimes take it (tests/test_torch_lockwitness.py holds
    # their observed edges equal), but the reference's witness workload
    # never promotes a follower, so its model never needed it
    ("ReplicaStore._apply_lock", "WriteAheadLog._lock",
     "ReplicaStore.promote reads the new WAL's term (WriteAheadLog.term "
     "takes the append lock) under the apply lock while it computes the "
     "promoted term; a read of one integer, nothing blocks"),
]

#: hot-lock blocking the design ACCEPTS, with its justification — the
#: witness excludes these (lock name, fault-point fnmatch pattern)
#: pairs from its no-blocking-under-hot-locks assertion; anything else
#: observed under a hot lock fails tier-1. Keep this list SHORT: every
#: entry is a documented latency cost on a hot path.
DECLARED_BLOCKING: list[tuple[str, str, str]] = [
    ("StreamingFeatureCache._lock", "stream.wal.*",
     "destructive ops (delete/expiry sweep) log APPLY-THEN-RECORD "
     "atomically under the hot lock — the WAL's documented durability "
     "asymmetry (streaming/store.py): a delete record can never outrun "
     "a later acknowledged re-upsert on replay. Deletes are rare next "
     "to writes, which log OUTSIDE the hot lock."),
]

#: production trees where every discovered lock MUST carry a LOCKS
#: entry (the concurrent tiers the model exists for). Locks discovered
#: elsewhere still join the graph; rank comes from inline annotations
#: when present.
ENFORCED_SCOPES = (
    "geomesa_tpu_torch/streaming/", "geomesa_tpu_torch/serving/", "geomesa_tpu_torch/cache/",
    "geomesa_tpu_torch/ingest/", "geomesa_tpu_torch/metrics.py", "geomesa_tpu_torch/fault.py",
    "geomesa_tpu_torch/datastore.py", "geomesa_tpu_torch/obs/", "geomesa_tpu_torch/pod/",
)

#: attribute-name type hints for cross-class call resolution where the
#: constructor assignment is opaque (wired post-construction, or built
#: through a factory): attr name -> owning class name
ATTR_TYPE_HINTS = {
    "metrics": "MetricsRegistry",
    "generations": "GenerationTracker",
    "hot": "StreamingFeatureCache",
    "flusher": "StreamFlusher",
    "wal": "WriteAheadLog",
    "scheduler": "QueryScheduler",
    "slo": "SloTracker",
    "accuracy": "EstimateAccuracy",
    "recorder": "TelemetryRecorder",
}

# the model's presence marker (the FaultPointRule convention: staged
# mini-repos without this file skip registry-side checks)
MODEL_PATH = "geomesa_tpu_torch/analysis/lockmodel.py"


@dataclass(frozen=True)
class LockSite:
    """One discovered lock construction."""

    name: str          # "Class.attr"
    cls: str
    attr: str
    path: str
    line: int
    kind: str          # lock | rlock | condition
    rank: Optional[int] = None    # inline `# lock-rank:` if any
    hot: bool = False             # inline annotation
    witness_name: Optional[str] = None  # the witness() name argument


@dataclass(frozen=True)
class LockEdge:
    """Lock ``dst`` acquired while ``src`` is statically held."""

    src: str
    dst: str
    path: str
    line: int
    via: str           # "" for direct nesting, else the resolved callee


def lock_ctor(node: ast.AST) -> "tuple[str, str | None] | None":
    """``(kind, witness_name)`` when ``node`` constructs a tracked lock:
    ``threading.RLock()`` directly, or wrapped as
    ``witness(threading.RLock(), "Class.attr")``."""
    if not isinstance(node, ast.Call):
        return None
    cn = call_name(node)
    if cn in LOCK_CTORS:
        return LOCK_CTORS[cn], None
    if cn == WITNESS_WRAPPER and node.args:
        inner = node.args[0]
        if isinstance(inner, ast.Call) and call_name(inner) in LOCK_CTORS:
            wname = (
                const_str(node.args[1]) if len(node.args) > 1 else None
            )
            return LOCK_CTORS[call_name(inner)], wname
    return None


def _class_methods(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class _ClassInfo:
    """Per-class analysis state."""

    def __init__(self, sf: SourceFile, node: ast.ClassDef):
        self.sf = sf
        self.node = node
        self.name = node.name
        self.locks: dict[str, LockSite] = {}      # attr -> site
        self.attr_types: dict[str, str] = {}      # attr -> class name
        self.guarded: dict[str, tuple[str, int]] = {}  # field -> (lock, line)
        self.methods: dict[str, ast.AST] = {
            m.name: m for m in _class_methods(node)
        }

    def lock_name(self, attr: str) -> str:
        return f"{self.name}.{attr}"


class LockModel:
    """The derived whole-repo lock model (cached per Project)."""

    def __init__(self):
        self.sites: dict[str, LockSite] = {}     # name -> site
        self.classes: dict[str, _ClassInfo] = {}
        self.edges: list[LockEdge] = []
        self._edge_keys: set[tuple[str, str]] = set()
        # per-(class, method) transitive acquisition summaries
        self._acquires: dict[tuple[str, str], set[str]] = {}

    # -- public surface ---------------------------------------------------
    @classmethod
    def of(cls, project: Project) -> "LockModel":
        cached = getattr(project, "_lint_lockmodel", None)
        if cached is not None:
            return cached
        model = cls()
        model._build(project)
        project._lint_lockmodel = model  # type: ignore[attr-defined]
        return model

    def rank_of(self, name: str) -> Optional[int]:
        d = LOCKS.get(name)
        if d is not None:
            return d.rank
        s = self.sites.get(name)
        return s.rank if s is not None else None

    def is_hot(self, name: str) -> bool:
        d = LOCKS.get(name)
        if d is not None:
            return d.hot
        s = self.sites.get(name)
        return bool(s is not None and s.hot)

    def predicted_edges(self) -> set[tuple[str, str]]:
        """The full predicted acquisition-order edge set: AST-derived
        plus declared (callback) edges — what the dynamic lock witness
        checks observed runtime edges against."""
        out = {(e.src, e.dst) for e in self.edges}
        out.update((a, b) for a, b, _ in DECLARED_EDGES)
        return out

    def cycles(self) -> list[list[str]]:
        """Elementary cycles (as lock-name paths) in the predicted
        graph, self-loops excluded (re-entrancy is checked separately).
        Deterministic order."""
        graph: dict[str, set[str]] = {}
        for a, b in self.predicted_edges():
            if a != b:
                graph.setdefault(a, set()).add(b)
        cycles: list[list[str]] = []
        seen_keys: set[tuple] = set()

        def dfs(start: str, node: str, path: list[str], on_path: set[str]):
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    cyc = path[:]
                    key = tuple(sorted(cyc))
                    if key not in seen_keys:
                        seen_keys.add(key)
                        cycles.append(cyc + [start])
                elif nxt not in on_path and nxt > start:
                    # canonical: only walk nodes ordered after the start,
                    # so each cycle is found once from its least node
                    on_path.add(nxt)
                    dfs(start, nxt, path + [nxt], on_path)
                    on_path.discard(nxt)

        for start in sorted(graph):
            dfs(start, start, [start], {start})
        return cycles

    # -- build ------------------------------------------------------------
    def _build(self, project: Project) -> None:
        for sf in project.python_files():
            if sf.tree is None:
                continue
            for node in sf.nodes:
                if isinstance(node, ast.ClassDef):
                    self._scan_class(sf, node)
        self._summarize()
        self._derive_edges()

    def _scan_class(self, sf: SourceFile, node: ast.ClassDef) -> None:
        info = _ClassInfo(sf, node)
        for method in _class_methods(node):
            locals_types: dict[str, str] = {}
            for stmt in ast.walk(method):
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = (
                    stmt.targets if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                value = stmt.value
                ctor = lock_ctor(value) if value is not None else None
                for t in targets:
                    attr = self_attr(t)
                    if attr is None:
                        # local typed from a project-class constructor:
                        # `wal = WriteAheadLog(...)` then `self.wal = wal`
                        if (
                            isinstance(t, ast.Name)
                            and isinstance(value, ast.Call)
                        ):
                            locals_types[t.id] = call_name(value)
                        continue
                    if ctor is not None:
                        kind, wname = ctor
                        line = sf.source_line(stmt.lineno)
                        m = _RANK_RE.search(line)
                        site = LockSite(
                            name=info.lock_name(attr), cls=info.name,
                            attr=attr, path=sf.relpath, line=stmt.lineno,
                            kind=kind,
                            rank=int(m.group(1)) if m else None,
                            hot=bool(m and m.group(2)),
                            witness_name=wname,
                        )
                        info.locks[attr] = site
                        # first site wins (same-named classes in
                        # fixtures shadow production entries only for
                        # their own synthetic class name)
                        self.sites.setdefault(site.name, site)
                        continue
                    # attribute type inference for call resolution
                    tname = None
                    if isinstance(value, ast.Call):
                        tname = call_name(value)
                    elif isinstance(value, ast.Name):
                        tname = locals_types.get(value.id)
                    if tname:
                        info.attr_types.setdefault(attr, tname)
                    gm = _GUARDED_RE.search(sf.source_line(stmt.lineno))
                    if gm:
                        info.guarded.setdefault(
                            attr, (gm.group(1), stmt.lineno)
                        )
        if info.locks or info.guarded:
            # same-named classes: production entry wins; fixtures use
            # unique class names by convention
            self.classes.setdefault(info.name, info)

    # -- method summaries (the compositional pass) ------------------------
    def _initial_held(self, info: _ClassInfo, method) -> set[str]:
        """Locks a method's BODY runs under by contract: `# holds-lock:`
        on or just under the def line, or the *_locked suffix when the
        class owns exactly one lock (multi-lock classes must annotate —
        guessing 'all locks' would fabricate edges from locks not
        actually held)."""
        held: set[str] = set()
        for attr in holds_lock_decls(info.sf, method):
            if attr in info.locks:
                held.add(info.lock_name(attr))
        if not held and method.name.endswith("_locked") and len(info.locks) == 1:
            held.add(info.lock_name(next(iter(info.locks))))
        return held

    def _resolve_call(self, info: _ClassInfo, node: ast.Call):
        """``(class name, method name)`` for self.m() / self.attr.m()
        calls the model can resolve, else None."""
        f = node.func
        if not isinstance(f, ast.Attribute):
            return None
        base = f.value
        if isinstance(base, ast.Name) and base.id == "self":
            if f.attr in info.methods:
                return (info.name, f.attr)
            return None
        attr = self_attr(base)
        if attr is not None:
            tname = info.attr_types.get(attr)
            if tname not in self.classes:
                # constructor assignment opaque (a factory like
                # `resolve(metrics)`, or wired post-construction):
                # fall back to the declared attribute-name hints
                tname = ATTR_TYPE_HINTS.get(attr)
            if tname in self.classes and f.attr in self.classes[tname].methods:
                return (tname, f.attr)
        return None

    def _direct_acquires(self, info: _ClassInfo, method) -> set[str]:
        out: set[str] = set()
        for node in ast.walk(method):
            if isinstance(node, ast.With):
                for item in node.items:
                    attr = self_attr(item.context_expr)
                    if attr is not None and attr in info.locks:
                        out.add(info.lock_name(attr))
        return out

    def _summarize(self) -> None:
        """Fixpoint over resolved calls: acquires*(C.m) = direct with-
        acquisitions plus the summaries of every resolvable callee."""
        calls: dict[tuple[str, str], set[tuple[str, str]]] = {}
        for cname, info in self.classes.items():
            for mname, method in info.methods.items():
                key = (cname, mname)
                self._acquires[key] = self._direct_acquires(info, method)
                callees = set()
                for node in ast.walk(method):
                    if isinstance(node, ast.Call):
                        r = self._resolve_call(info, node)
                        if r is not None and r != key:
                            callees.add(r)
                calls[key] = callees
        changed = True
        while changed:
            changed = False
            for key, callees in calls.items():
                acc = self._acquires[key]
                before = len(acc)
                for c in callees:
                    acc |= self._acquires.get(c, set())
                if len(acc) != before:
                    changed = True

    # -- edge derivation ---------------------------------------------------
    def _add_edge(self, src: str, dst: str, path: str, line: int, via: str):
        if (src, dst) in self._edge_keys:
            return
        self._edge_keys.add((src, dst))
        self.edges.append(LockEdge(src, dst, path, line, via))

    def _derive_edges(self) -> None:
        for cname in sorted(self.classes):
            info = self.classes[cname]
            resolve = _lock_resolver(info)
            for mname in sorted(info.methods):
                method = info.methods[mname]

                def on_with(stmt, held, acquired, reacquired,
                            info=info, method=method):
                    for name in sorted(acquired):
                        for h in held:
                            self._add_edge(
                                h, name, info.sf.relpath, stmt.lineno, "",
                            )
                    # calls in the with items evaluate PRE-acquire
                    for item in stmt.items:
                        for node in ast.walk(item.context_expr):
                            if isinstance(node, ast.Call):
                                self._note_call(info, method, node, held)

                def on_stmt(stmt, held, info=info, method=method):
                    for node in ast.walk(stmt):
                        if isinstance(node, ast.Call):
                            self._note_call(info, method, node, held)
                    return False  # keep descending: nested With blocks
                    #               re-note their calls under the
                    #               larger held set (edges dedup)

                walk_held(
                    method.body, resolve, on_with, on_stmt,
                    frozenset(self._initial_held(info, method)),
                )

    def _note_call(self, info, method, node: ast.Call, held: set[str]):
        if not held:
            return
        r = self._resolve_call(info, node)
        if r is None:
            return
        for dst in sorted(self._acquires.get(r, set())):
            if dst in held:
                continue
            for h in held:
                self._add_edge(
                    h, dst, info.sf.relpath, node.lineno, f"{r[0]}.{r[1]}",
                )


def _lock_resolver(info: "_ClassInfo"):
    """resolve() for :func:`walk_held` tracking a class's locks by
    their registry-style ``Class.attr`` name."""
    def resolve(expr):
        attr = self_attr(expr)
        if attr is not None and attr in info.locks:
            return info.lock_name(attr)
        return None

    return resolve


def walk_held(stmts, resolve, on_with=None, on_stmt=None,
              held: frozenset = frozenset()) -> None:
    """THE shared held-set traversal — every lock-scope walker in the
    model and the concurrency rules goes through here, so statement-
    shape handling (try/if/for/while bodies, handlers) is fixed in ONE
    place.

    ``resolve(expr) -> token | None`` identifies tracked lock
    acquisitions in With items (token: whatever the client tracks —
    lock name or attr). Per With statement,
    ``on_with(stmt, held, acquired, reacquired)`` fires (``acquired``:
    tokens newly held by the body; ``reacquired``: already-held tokens
    the With re-enters), then the body walks under ``held | acquired``.
    Per other statement, ``on_stmt(stmt, held)`` fires first — a truthy
    return stops descent into that statement's nested blocks (for
    clients that scan the whole subtree themselves)."""
    held = frozenset(held)
    for stmt in stmts:
        if isinstance(stmt, ast.With):
            acquired: set = set()
            reacquired: set = set()
            for item in stmt.items:
                token = resolve(item.context_expr)
                if token is None:
                    continue
                (reacquired if token in held else acquired).add(token)
            if on_with is not None:
                on_with(stmt, held, acquired, reacquired)
            walk_held(stmt.body, resolve, on_with, on_stmt,
                      held | acquired)
            continue
        if on_stmt is not None and on_stmt(stmt, held):
            continue
        for sub in ("body", "orelse", "finalbody"):
            inner = getattr(stmt, sub, None)
            if inner:
                walk_held(inner, resolve, on_with, on_stmt, held)
        for h in getattr(stmt, "handlers", []) or []:
            walk_held(h.body, resolve, on_with, on_stmt, held)


def holds_lock_decls(sf: SourceFile, method) -> list[str]:
    """``# holds-lock:`` declarations of a method: on the ``def`` line
    or on the first body line (both placements exist in the tree)."""
    out = []
    lines = [method.lineno]
    if getattr(method, "body", None):
        lines.append(method.body[0].lineno)
    for ln in lines:
        m = _HOLDS_RE.search(sf.source_line(ln))
        if m:
            out.append(m.group(1))
    return out


def registry_line(project: Project, name: str) -> int:
    """The LOCKS declaration line of one registered name (for
    registry-side findings), falling back to 1."""
    sf = project.files.get(MODEL_PATH)
    if sf is not None:
        needle = f'"{name}"'
        for i, line in enumerate(sf.lines, start=1):
            if needle in line:
                return i
    return 1


def annotated_guards(model: LockModel) -> dict[str, set[str]]:
    """lock name -> the fields `# guarded-by:` comments attach to it,
    aggregated across all scanned classes (the code-side view the
    registry's ``fields`` tuples cross-check against)."""
    out: dict[str, set[str]] = {}
    for cname, info in model.classes.items():
        for fieldname, (lock, _line) in info.guarded.items():
            out.setdefault(f"{cname}.{lock}", set()).add(fieldname)
    return out
