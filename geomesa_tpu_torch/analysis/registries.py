"""The shared name registries: knobs, metrics, schema user-data keys.

Every ``geomesa.*`` dotted name in this codebase belongs to exactly one
of three namespaces:

1. **configuration knobs** — declared as typed ``SystemProperty`` objects
   in ``geomesa_tpu_torch/conf.py`` (the GeoMesaSystemProperties analogue);
2. **metric instruments** — counter/gauge/timer names passed to
   ``MetricsRegistry`` methods (directly, or through one level of
   wrapper such as ``BulkLoader._count`` / ``ResultCache._drop_locked``,
   which this module infers from the AST);
3. **schema user-data keys** — per-SFT settings carried in
   ``FeatureType.user_data`` and interchange metadata (the reference's
   SimpleFeatureTypes configs), registered explicitly in
   :data:`USER_DATA_KEYS` below.

This module (the port of geomesa_tpu/analysis/registries.py) extracts
all three from the AST and is the ONE source of truth the lint rules
and docs comparisons use — so a knob or metric renamed in code without
its docs (or vice versa) fails the build instead of drifting. Each
table below holds exactly what the JAX package's does: the port
declares the same user-data keys, fault points and controllers.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from geomesa_tpu_torch.analysis.core import Project, SourceFile, call_name, const_str

# -- schema user-data / interchange metadata keys -------------------------
# The third namespace is small and deliberately explicit: unlike knobs
# (typed declarations) and metrics (instrument calls), user-data keys
# have no single declaration form in code, so the registry IS the
# declaration. A key listed here but never read is itself a finding
# (userdata-unused); a geomesa.* literal matching none of the three
# registries is an undeclared-name finding.
USER_DATA_KEYS: dict[str, str] = {
    "geomesa.crs": "coordinate reference system of the schema's geometries",
    "geomesa.geom": "default geometry field name (Avro/Arrow interchange)",
    "geomesa.sft.spec": "serialized FeatureType spec (Arrow/Parquet metadata)",
    "geomesa.sft.name": "feature type name (Arrow/Parquet metadata)",
    "geomesa.index.dtg": "override of the default time attribute",
    "geomesa.z3.interval": "Z3 time-binning period (day/week/month/year)",
    "geomesa.z3.packed-time": "opt the schema into the packed i32 time column",
    "geomesa.xz.precision": "XZ curve resolution (g in the XZ papers)",
    "geomesa.z.splits": "Z-index shard-bit count",
    "geomesa.attr.splits": "attribute-index shard-bit count",
    "geomesa.indices.enabled": "restrict which index types a schema builds",
    "geomesa.feature.expiry": "age-off TTL spec (reference age-off configs)",
    "geomesa.vis.field": "attribute carrying per-feature visibility labels",
}

# -- fault points ---------------------------------------------------------
# The FOURTH dotted-name namespace: every ``fault.fault_point``
# name in the tree. Like USER_DATA_KEYS, the registry IS the declaration
# — fault points have no typed declaration form in code — and the
# ``fault-point-unknown`` rule machine-checks three directions: a
# literal used in code must be registered here, a registered name must
# have a code use site, and a registered name must be exercised by at
# least one test (directly, or through an fnmatch pattern a test arms).
# ``fault.atomic_write(..., point="X")`` contributes the derived pair
# ``X.write`` / ``X.rename``.
FAULT_POINTS: dict[str, str] = {
    # crash-safe persistence (storage/persist.py)
    "persist.partition.write": "before a partition file's tmp write",
    "persist.partition.rename": "before a partition's atomic rename",
    "persist.partition.commit": "after the rename (durable bytes)",
    "persist.manifest.write": "before the manifest's tmp write",
    "persist.manifest.rename": "before the manifest commit rename",
    "persist.manifest.commit": "after the manifest commit (durable)",
    "persist.gc": "before post-commit garbage collection",
    "load.partition.read": "before reading a partition on load",
    # catalog metadata (storage/metadata.py FileMetadata)
    "metadata.write": "before a catalog KV tmp write",
    "metadata.rename": "before a catalog KV atomic rename",
    # index-table (re)build (storage/adapter.py)
    "adapter.create_table": "before an index table (re)build",
    # pipelined ingest (ingest/)
    "ingest.split.read": "before reading an input split",
    "ingest.parse": "before converting a split's records",
    "ingest.keys": "before a chunk's key encoding",
    "ingest.sort": "before a chunk's shard radix sort",
    "ingest.commit": "before a chunk's staged commit",
    "ingest.finalize": "before the one atomic ingest publish",
    # streaming flush (streaming/flush.py, store.py)
    "stream.flush.parse": "before a flush micro-chunk's parse stage",
    "stream.flush.keys": "before a flush micro-chunk's key stage",
    "stream.flush.sort": "before a flush micro-chunk's shard sort",
    "streaming.persist": "before the one atomic hot->cold publish",
    "streaming.evict": "between the cold commit and the hot eviction",
    # incremental sliced fold (datastore.fold_upsert)
    "stream.fold.stage": "before pre-staging update chunks at micro-flush",
    "stream.fold.slice": "before building one fold slice",
    "stream.fold.publish": "before a fold slice's atomic publish",
    # streaming WAL (streaming/wal.py)
    "stream.wal.append": "before a WAL record is encoded/buffered",
    "stream.wal.sync": "before a WAL fsync (group commit)",
    "stream.wal.rotate": "before sealing/rotating the active segment",
    "stream.wal.truncate": "before cutting a torn WAL tail",
    "stream.wal.replay": "before replaying a WAL segment on recovery",
    # standing-query matching (streaming/standing.py)
    "standing.match": "before a batch's route+match pipeline runs",
    "standing.deliver": "before a batch's alerts enqueue/windows fold",
    # WAL shipping / replication (streaming/replica.py)
    "replica.ship.segment": "before the shipper reads a segment chunk",
    "replica.apply": "before a follower appends+applies a shipped chunk",
    "replica.promote": "at the entry of a follower's promotion",
    "replica.fence": "before a stale-term shipment is refused",
    # map-tile pyramid (tiles/pyramid.py)
    "tiles.compose": "before a pyramid tile composes (leaf scan or child fold)",
    "tiles.leaf.scan": "before a leaf tile's backing row scan",
    # multi-host pod tier (pod/)
    "pod.dispatch": "before one host's scan/ingest leg is dispatched",
    "pod.join": "before per-host results merge at the coordinator",
    "pod.wal.route": "before a routed slice reaches its owning host's WAL",
    "pod.wal.replay": "before a killed host's WAL replay on rejoin",
}

# -- controllers ----------------------------------------------------------
# The FIFTH dotted-name namespace (tuning/): the store's
# AUTO-TUNED knob surface. A knob a controller writes online is a
# bigger contract than a knob an operator sets — it must declare hard
# bounds (the controller may never leave them) and an objective metric
# that actually exists (a controller optimizing a metric nobody
# records would hill-climb noise). Like USER_DATA_KEYS and
# FAULT_POINTS, this registry IS the declaration; the
# ``controller-registry`` rule machine-checks both directions (every
# ``ControllerSpec`` literal registered here, every name here backed
# by a spec) plus the per-spec contract: knob resolves in the knob
# registry, ``lo < hi`` present, objective resolves in the metrics
# registry.
CONTROLLERS: dict[str, str] = {
    "cache_min_cost": (
        "result-cache admission cost threshold, tuned against the "
        "cache-hit rate (cache/result.py admission gate)"
    ),
    "fused_chunk_slots": (
        "fused transfer chunk slot count, derived from measured link "
        "RTT on the doubling ladder (scan/block_kernels.py)"
    ),
    "fold_slice_rows": (
        "incremental fold slice size, tuned against the slice-pause "
        "p99 (datastore.fold_upsert)"
    ),
    "flush_chunk_rows": (
        "stream flush batch rows, tuned against flushed-row "
        "throughput (streaming/flush.py)"
    ),
}


# metric instrument methods on MetricsRegistry, by instrument kind
INSTRUMENT_METHODS = {
    "counter": "counter",
    "counter_value": "counter",
    "gauge": "gauge",
    "timer_update": "timer",
    "time": "timer",
    # the live-quantile instrument (obs/): observe()
    # records, histogram_quantile() reads — both name a histogram, so
    # convention/type-conflict/doc rules cover the family
    "observe": "histogram",
    "histogram_quantile": "histogram",
}

# reference-GeoMesa names the migration guide legitimately cites while
# mapping them to this build's equivalents — resolvable on purpose, so
# the doc rule doesn't force rewording honest reference citations
REFERENCE_NAMES: dict[str, str] = {
    "geomesa.table.partition": (
        "reference table-partitioning key (docs/migration.md maps it to "
        "the merge-compaction contiguous-segment design)"
    ),
}

# dotted-name extraction: geomesa.x[.y]*, optionally a `.*` family
# wildcard (docstrings say "the geomesa.ingest.* family"). Segments
# never end with punctuation (sentence dots stay out), and the negative
# lookbehind keeps matches out of URLs ("http://geomesa.org") and java
# namespaces ("org.geomesa.tpu").
DOTTED_RE = re.compile(
    r"(?<![a-z0-9_.\-/:])geomesa\.[a-z0-9_]+(?:[.\-][a-z0-9_]+)*(?:\.\*)?"
)


def extract_dotted(text: str) -> list[str]:
    """All geomesa.* dotted names in a text blob (a trailing ``.*``
    marks a family wildcard and is kept for the caller to classify)."""
    return [tok for tok in DOTTED_RE.findall(text) if "." in tok]


# -- knobs ----------------------------------------------------------------


@dataclass(frozen=True)
class Knob:
    name: str          # dotted property name
    var: str           # module-level variable in conf.py
    doc: str           # declaration doc text
    default_src: str   # source of the default expression
    line: int


@dataclass
class KnobRegistry:
    knobs: dict[str, Knob] = field(default_factory=dict)
    by_var: dict[str, Knob] = field(default_factory=dict)
    path: str = "geomesa_tpu_torch/conf.py"

    @classmethod
    def load(cls, project: Project) -> "KnobRegistry":
        reg = cls()
        sf = project.files.get(reg.path)
        if sf is None or sf.tree is None:
            return reg
        for node in sf.nodes:
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            if call_name(node.value) != "SystemProperty":
                continue
            args = node.value.args
            name = const_str(args[0]) if args else None
            if name is None:
                continue
            var = (
                node.targets[0].id
                if node.targets and isinstance(node.targets[0], ast.Name)
                else ""
            )
            doc = ""
            if len(args) > 3:
                doc = const_str(args[3]) or ""
            for kw in node.value.keywords:
                if kw.arg == "doc":
                    doc = const_str(kw.value) or ""
            default_src = ast.unparse(args[1]) if len(args) > 1 else ""
            knob = Knob(name, var, doc, default_src, node.lineno)
            reg.knobs[name] = knob
            if var:
                reg.by_var[var] = knob
        return reg

    def resolves(self, name: str) -> bool:
        return name in self.knobs


# -- metrics --------------------------------------------------------------


@dataclass(frozen=True)
class MetricUse:
    name: str         # concrete name, or prefix when is_prefix
    instrument: str   # counter | gauge | timer
    path: str
    line: int
    is_prefix: bool = False  # f-string family, e.g. geomesa.ingest.<stage>


@dataclass
class MetricRegistry:
    uses: list[MetricUse] = field(default_factory=list)

    @classmethod
    def collect(cls, project: Project) -> "MetricRegistry":
        reg = cls()
        wrappers = _infer_wrappers(project)
        for sf in project.python_files():
            if sf.tree is None:
                continue
            for node in sf.nodes:
                if not isinstance(node, ast.Call):
                    continue
                fname = call_name(node)
                instrument = INSTRUMENT_METHODS.get(fname)
                if instrument is not None:
                    candidates = [(instrument, 0)]
                else:
                    # wrapper call: same-named wrappers may disagree on
                    # the name-param position, and an attribute call may
                    # be a bound method (self consumed, args shift by 1)
                    # OR a module attribute (no shift) — try every
                    # candidate position, first geomesa literal wins
                    cands = wrappers.get(fname)
                    if not cands:
                        continue
                    candidates = []
                    for instr, pos in sorted(cands):
                        if isinstance(node.func, ast.Attribute):
                            candidates += [(instr, pos - 1), (instr, pos)]
                        else:
                            candidates.append((instr, pos))
                for instrument, arg_idx in candidates:
                    if not 0 <= arg_idx < len(node.args):
                        continue  # incl. bound-vs-bare mismatch (< 0)
                    use = _classify_name_arg(
                        node.args[arg_idx], instrument, sf, node
                    )
                    if use is not None:
                        reg.uses.append(use)
                        break
        return reg

    def names(self) -> set[str]:
        # memoized: resolves() runs once per geomesa.* occurrence over
        # the whole tree, and self.uses is frozen after collect()
        cached = getattr(self, "_names", None)
        if cached is None:
            cached = {u.name for u in self.uses if not u.is_prefix}
            self._names = cached
        return cached

    def prefixes(self) -> set[str]:
        cached = getattr(self, "_prefixes", None)
        if cached is None:
            cached = {u.name for u in self.uses if u.is_prefix}
            self._prefixes = cached
        return cached

    def resolves(self, name: str) -> bool:
        if name in self.names():
            return True
        return any(name.startswith(p) for p in self.prefixes())

    def by_name(self) -> dict[str, list[MetricUse]]:
        out: dict[str, list[MetricUse]] = {}
        for u in self.uses:
            out.setdefault(u.name, []).append(u)
        return out


def _classify_name_arg(arg, instrument, sf: SourceFile, node) -> "MetricUse | None":
    s = const_str(arg)
    if s is not None:
        if s.startswith("geomesa."):
            return MetricUse(s, instrument, sf.relpath, node.lineno)
        return None
    if isinstance(arg, ast.JoinedStr) and arg.values:
        head = const_str(arg.values[0])
        if head and head.startswith("geomesa."):
            return MetricUse(
                head, instrument, sf.relpath, node.lineno, is_prefix=True
            )
    return None


def _infer_wrappers(project: Project) -> dict[str, set]:
    """One level of wrapper inference: a function whose parameter is
    passed as the name argument of a direct instrument call is itself an
    instrument call site (``_count`` -> counter, ``_drop_locked``'s
    ``counter`` param -> counter). Maps func name -> set of
    (instrument, param position including self) — a SET because
    same-named wrappers in different classes may disagree on the
    position; call sites try every candidate."""
    out: dict[str, set] = {}
    for sf in project.python_files():
        if sf.tree is None:
            continue
        for fn in sf.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in fn.args.args]
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                instrument = INSTRUMENT_METHODS.get(call_name(node))
                if instrument is None or not node.args:
                    continue
                a0 = node.args[0]
                if isinstance(a0, ast.Name) and a0.id in params:
                    out.setdefault(fn.name, set()).add(
                        (instrument, params.index(a0.id))
                    )
    return out


# -- fault-point occurrences ----------------------------------------------


@dataclass(frozen=True)
class FaultPointUse:
    name: str
    path: str
    line: int
    via: str  # "fault_point" | "atomic_write"


def fault_point_uses(project: Project) -> list[FaultPointUse]:
    """Every literal fault-point name the production tree can fire:
    ``fault_point("X")`` first arguments, plus the ``X.write``/
    ``X.rename`` pair an ``atomic_write(..., point="X")`` call derives.
    Non-literal names (f-strings, variables) are skipped — they are
    covered at their literal call sites."""
    out: list[FaultPointUse] = []
    for sf in project.python_files():
        if sf.tree is None:
            continue
        for node in sf.nodes:
            if not isinstance(node, ast.Call):
                continue
            fname = call_name(node)
            if fname == "fault_point" and node.args:
                s = const_str(node.args[0])
                if s is not None:
                    out.append(
                        FaultPointUse(s, sf.relpath, node.lineno, fname)
                    )
            elif fname == "atomic_write":
                for kw in node.keywords:
                    if kw.arg == "point":
                        s = const_str(kw.value)
                        if s is not None:
                            for suffix in (".write", ".rename"):
                                out.append(FaultPointUse(
                                    s + suffix, sf.relpath,
                                    node.lineno, fname,
                                ))
    return out


def test_string_tokens(project: Project) -> set[str]:
    """Every quoted string token in the test tree that could name or
    match a fault point (contains a dot) — the coverage side of the
    fault-point-unknown rule. Cached on the project (one regex pass)."""
    cached = getattr(project, "_lint_test_tokens", None)
    if cached is not None:
        return cached
    tokens: set[str] = set()
    pattern = re.compile(r"[\"']([A-Za-z0-9_.*/:-]+)[\"']")
    for text in project.tests.values():
        for tok in pattern.findall(text):
            if "." in tok:
                tokens.add(tok)
    project._lint_test_tokens = tokens  # type: ignore[attr-defined]
    return tokens


# -- controller-spec occurrences ------------------------------------------


@dataclass(frozen=True)
class ControllerSpecUse:
    """One ``ControllerSpec(...)`` literal call site, with the fields
    the controller-registry rule checks. Non-literal field values come
    through as None and are reported as missing — a spec whose bounds
    are computed cannot be machine-checked, so it does not pass."""

    name: "str | None"
    knob: "str | None"
    lo: "float | None"
    hi: "float | None"
    objective: "str | None"
    path: str
    line: int


def _const_num(node) -> "float | None":
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        return float(node.value)
    return None


def controller_spec_uses(project: Project) -> list[ControllerSpecUse]:
    """Every ``ControllerSpec(...)`` call in the production tree with
    its literal name/knob/bounds/objective fields (keyword or
    positional, matching the dataclass field order)."""
    fields = ("name", "knob", "lo", "hi", "objective")
    out: list[ControllerSpecUse] = []
    for sf in project.python_files():
        if sf.tree is None:
            continue
        for node in sf.nodes:
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) != "ControllerSpec":
                continue
            got: dict = {f: None for f in fields}
            for i, arg in enumerate(node.args[:5]):
                f = fields[i]
                got[f] = _const_num(arg) if f in ("lo", "hi") else const_str(arg)
            for kw in node.keywords:
                if kw.arg in ("lo", "hi"):
                    got[kw.arg] = _const_num(kw.value)
                elif kw.arg in fields:
                    got[kw.arg] = const_str(kw.value)
            out.append(ControllerSpecUse(
                got["name"], got["knob"], got["lo"], got["hi"],
                got["objective"], sf.relpath, node.lineno,
            ))
    return out


# -- doc occurrences ------------------------------------------------------


@dataclass(frozen=True)
class DocName:
    name: str
    path: str
    line: int
    wildcard: bool  # "geomesa.ingest.*" family mention


def doc_names(project: Project) -> list[DocName]:
    """Every geomesa.* dotted name mentioned in the port's documents
    (``Project.DOC_ROOT``), with lines."""
    out = []
    for rel, doc in sorted(project.docs.items()):
        for i, line in enumerate(doc.text.splitlines(), start=1):
            for tok in extract_dotted(line):
                wildcard = tok.endswith(".*")
                out.append(DocName(tok[:-2] if wildcard else tok, rel, i, wildcard))
    return out


# -- the bundle rules share ----------------------------------------------


@dataclass
class Registries:
    knobs: KnobRegistry
    metrics: MetricRegistry

    @classmethod
    def of(cls, project: Project) -> "Registries":
        cached = getattr(project, "_lint_registries", None)
        if cached is not None:
            return cached
        reg = cls(
            knobs=KnobRegistry.load(project),
            metrics=MetricRegistry.collect(project),
        )
        project._lint_registries = reg  # type: ignore[attr-defined]
        return reg

    def resolves(self, name: str, wildcard: bool = False) -> bool:
        """Does a dotted name resolve in ANY namespace? Wildcards
        (``geomesa.ingest.*``) resolve when any registered name or
        family lives under the prefix; a bare family head (prose like
        "the geomesa.ingest stage timers", or an f-string prefix)
        resolves against registered prefix families the same way."""
        if wildcard:
            prefix = name if name.endswith(".") else name + "."
            return (
                any(k.startswith(prefix) for k in self.knobs.knobs)
                or any(m.startswith(prefix) for m in self.metrics.names())
                or any(p.startswith(prefix) or prefix.startswith(p)
                       for p in self.metrics.prefixes())
                or any(u.startswith(prefix) for u in USER_DATA_KEYS)
            )
        return (
            self.knobs.resolves(name)
            or self.metrics.resolves(name)
            or name in USER_DATA_KEYS
            or name in REFERENCE_NAMES
            or (name + ".") in self.metrics.prefixes()
        )
