"""QueryPlanner: pick an index, build a scan plan, execute, refine.

The port of the single-query and pipelined multi-query paths of
geomesa_tpu/planning/planner.py (reference QueryPlanner.scala:40-161,
StrategyDecider.scala:47-181): extract filter values -> per-index
ScanConfig -> cost selection -> block-pruned device scan (one launch per
query, or one fused launch per chunk of queries) -> host gather ->
refinement of the uncertain rows (always exact f64) -> limit.

A polygon filter on a point schema plans to a pruned index scan whose
kernel runs the point-in-polygon and raster legs; on an extent schema the
XZ scan's bbox-intersects mask is never exact (``geom_precise`` False),
so every hit refines in f64 and no aggregation pushes down. A filter no
single index serves plans as a union over its DNF disjuncts when each
disjunct has an index (``bbox(...) OR dtg DURING ...``: one scan per
disjunct, results deduplicated in first-seen order); otherwise (no
spatio-temporal constraint) it takes the full-table host scan, with
identical results. Explain says which. An id filter (``IN ('a', 'b')``)
plans ahead of every index as an id lookup: the sorted ids probe the
store's per-chunk id index, and the rows come back in sorted-id order.

Around the scan sit the reference's query controls: interceptors rewrite
the filter and guards inspect the plan (``DataStore.apply_interceptors``
/ ``apply_guards``); a deadline from the ``timeout`` hint or the store's
``query_timeout`` is checked at every stage boundary, never between a
kernel launch and the copy that ends it (QueryTimeout, counted in
``geomesa.query.timeout``); the ``loose`` hint accepts the widened device
plane where the mask decides the filter; ``_post`` samples, sorts, pages,
reprojects and transforms; every executed plan is recorded
(``DataStore.record_query``); and the phases open trace spans (``plan``,
``plan.probe``, ``plan.decompose``, ``dispatch``, ``scan``, ``decode``,
``probe``).

With a store configured with ``auths``, attribute visibility closes at
plan depth (a filter over a hidden attribute raises) and ``_post`` masks
rows by their visibility label and projects hidden attributes out,
before sample, sort and page; a union applies it once over the merged
rows. Every plan carries the stats sketch's row estimate
(``estimated_rows``) and, once executed, the rows it matched after
refinement (``actual_rows``), for the store's estimate accounting. With
a cache tier (``DataStore(cache=True)``) execution goes through the
result cache (``_execute_or_cached``; the ``cache`` hint bypasses or
pins), and the range decomposition is memoized per (index, canonical
filter) between mutations.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np

from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter import ecql
from geomesa_tpu_torch.filter.extract import extract_ids
from geomesa_tpu_torch.filter.predicates import Filter, Include
from geomesa_tpu_torch.index.api import ScanConfig
from geomesa_tpu_torch.obs.trace import span as _ospan
from geomesa_tpu_torch.obs.trace import tracer as _otracer
from geomesa_tpu_torch.planning.explain import Explainer, ExplainNull

# index selection priority (reference cost multipliers: z3 / xz3 = 1.1
# with bounded time, s3 = 1.2, z2 / xz2 = 2.0, s2 = 2.1, attribute
# indexes 2.5, id lookups 0.5). Lower = preferred.
INDEX_PRIORITY = {
    "z3": 1.1, "xz3": 1.1, "s3": 1.2,
    "z2": 2.0, "xz2": 2.0, "s2": 2.1,
    "attr": 2.5, "id": 0.5,
}


def index_priority(name: str) -> float:
    """Cost multiplier for an index name; attribute indexes are named
    ``attr_<attribute>`` and share the ``attr`` multiplier."""
    return INDEX_PRIORITY.get(name, INDEX_PRIORITY.get(name.split("_")[0], 3.0))


@dataclass
class QueryPlan:
    """A chosen execution strategy for one query."""

    type_name: str
    filter: Filter
    index: Optional[str]  # None = full-table host scan
    config: Optional[ScanConfig]
    ids: Optional[list] = None  # id-lookup plan
    limit: Optional[int] = None
    planning_s: float = 0.0
    # multi-index union plan (reference FilterSplitter OR options): each
    # sub-plan scans one DNF disjunct on its own index; results dedup-union
    union: Optional[list["QueryPlan"]] = None
    # degraded-mode notices (quarantined partitions excluded from results):
    # set at plan time from the store's health, counted by record_query
    warnings: Optional[list] = None
    # result-cache outcome for this execution ("hit" | "miss" |
    # "coalesced" | "partial" for a tile composition | None = the cache
    # was not consulted) and the time spent probing it, kept apart from
    # the scan time
    cache_status: Optional[str] = None
    cache_probe_s: float = 0.0
    # serving-tier attribution: the wall-clock seconds this plan waited
    # behind the scheduler's micro-batch window before its fused dispatch
    # (the geomesa.serving.queue_wait histogram), apart from scan time
    queue_wait_s: float = 0.0
    # estimate accountability: the stats-sketch row estimate resolved at
    # plan time (None = no sketch covered the filter, or
    # geomesa.plan.estimate.enabled off) and the rows the executed scan
    # matched after refinement, before limit and visibility
    estimated_rows: Optional[float] = None
    actual_rows: Optional[int] = None

    @property
    def strategy(self) -> str:
        if self.union is not None:
            return "union(" + "+".join(p.strategy for p in self.union) + ")"
        if self.ids is not None:
            return "id-lookup"
        return "full-scan" if self.index is None else self.index


# re-exported for importers of the planner; the definitions live in the
# leaf module planning.errors so the storage layer can use them too
from geomesa_tpu_torch.planning.errors import (  # noqa: E402
    QueryGuardError, QueryTimeout, check_deadline, deadline_from,
)


def _filter_leaf_kinds(
    f: Filter, geom_field: str | None, dtg_field: str | None
) -> set | None:
    """The set of predicate kinds ({"spatial", "temporal"}) this filter is
    built from, or None when any predicate is outside the indexable
    spatio-temporal subset (And of leaves; Or only of same-kind leaves)."""
    from geomesa_tpu_torch.filter.predicates import (
        And, BBox, Between, Cmp, During, Intersects, Or,
    )

    def leaf_kind(p) -> str | None:
        if isinstance(p, (BBox, Intersects)) and p.prop == geom_field:
            return "spatial"
        if isinstance(p, (During, Between)) and p.prop == dtg_field:
            return "temporal"
        if isinstance(p, Cmp) and p.prop == dtg_field and p.op in ("<", "<=", ">", ">=", "="):
            return "temporal"
        return None

    def walk(p) -> set | None:
        if isinstance(p, Include):
            return set()
        if isinstance(p, And):
            out: set = set()
            for c in p.filters:
                k = walk(c)
                if k is None:
                    return None
                out |= k
            return out
        if isinstance(p, Or):
            kinds = {leaf_kind(c) for c in p.filters}
            return kinds if len(kinds) == 1 and None not in kinds else None
        k = leaf_kind(p)
        return {k} if k else None

    return walk(f)


def mask_decides_filter(
    f: Filter, config: Optional[ScanConfig], sft, for_aggregation: bool = False
) -> bool:
    """True when the device scan mask decides this filter entirely, so
    refinement may skip certain rows and aggregations may run on device:
    every predicate is an indexable spatial/temporal leaf, the config is
    precise on both axes, and the chosen index enforces each kind present
    (z2 leaves ``windows=None`` and must not satisfy a temporal filter).
    Reference Z3IndexKeySpace.useFullFilter, Z3IndexKeySpace.scala:240-254.

    ``for_aggregation``: the gather-free aggregation kernels (count
    estimate, density, bounds) evaluate the box wide plane only, so a
    polygon config (``poly`` or ``rast``), which decides the filter for
    row scans through the certainty vector and host refinement of the
    residue, does not decide it for them: they would count the whole
    bbox."""
    if config is None or not (config.geom_precise and config.time_precise):
        return False
    if for_aggregation and (config.poly is not None or config.rast is not None):
        return False
    kinds = _filter_leaf_kinds(f, sft.geom_field, sft.dtg_field)
    if kinds is None:
        return False
    if "spatial" in kinds and config.boxes is None:
        return False
    if "temporal" in kinds and config.windows is None:
        return False
    return True


def _referenced_props(f: Filter) -> set:
    """Every attribute name a filter tree references (``prop`` fields of
    leaf predicates, recursing into And/Or/Not)."""
    from geomesa_tpu_torch.filter.predicates import And, Not, Or

    out: set = set()
    if isinstance(f, (And, Or)):
        for c in f.filters:
            out |= _referenced_props(c)
    elif isinstance(f, Not):
        out |= _referenced_props(f.filter)
    else:
        prop = getattr(f, "prop", None)
        if prop is not None:
            out.add(prop)
    return out


# scan-config memo bound: repeated dashboard queries plan again and
# again, the range decomposition is the dominant planning cost and a pure
# function of (index instance, filter) between mutations
_CONFIG_MEMO_MAX = 4096


class QueryPlanner:
    """Plans and runs queries for one DataStore."""

    def __init__(self, store):
        self.store = store
        # (index instance, canonical filter key) -> ScanConfig | None,
        # LRU-bounded. Keyed by the index object, so a dropped and
        # recreated schema can never serve a stale decomposition; the
        # lock makes concurrent plan() calls safe
        self._config_memo: "OrderedDict" = OrderedDict()
        self._memo_lock = threading.Lock()
        self._memo_epoch = 0  # bumped by every invalidation
        # plan-feedback hook: an armed tuning tier installs its
        # IndexReweighter here; None (the default, and the disarmed state)
        # keeps cost() on the static multipliers. Reads are lock-free
        # (immutable table swap).
        self.reweighter = None

    @property
    def mutation_epoch(self) -> int:
        """Monotonic count of committed mutations (config-memo
        invalidations)."""
        return self._memo_epoch

    def invalidate_config_memo(self) -> None:
        """Drop every memoized scan config. The store calls this after
        every committed mutation: scan_config is pure only between
        mutations (bin_range clamping depends on the data). Bumping the
        epoch stops a decomposition computed before the mutation
        (outside the lock) from being inserted after it."""
        with self._memo_lock:
            self._memo_epoch += 1
            self._config_memo.clear()

    # -- planning --------------------------------------------------------
    def plan(
        self,
        type_name: str,
        f: "Filter | str",
        limit: Optional[int] = None,
        explain: Explainer | None = None,
        intercept: bool = True,
        guard: "bool | None" = None,
    ) -> QueryPlan:
        """``intercept=False`` skips the interceptor rewrite: for internal
        maintenance scans (delete_features, age_off), which guards must
        not reject either (``guard`` defaults to ``intercept``), and for
        callers that already applied the rewrite (pass ``guard=True`` to
        keep guarding those)."""
        if guard is None:
            guard = intercept
        t0 = time.perf_counter()
        exp = explain or ExplainNull()
        clock = self.store.clock
        with _ospan("plan", type=type_name), clock.host("plan"), clock.thread_cpu("plan.cpu"):
            if isinstance(f, str):
                f = ecql.parse(f)
            from geomesa_tpu_torch.filter.predicates import normalize_antimeridian

            f = normalize_antimeridian(f)
            if intercept:
                f = self.store.apply_interceptors(type_name, f)
                # attribute-level visibility closes at plan depth: a
                # predicate over a hidden attribute would evaluate against
                # the hidden values, letting unauthorized auths
                # reconstruct them by probing
                self._check_attr_visibility(type_name, f)
            exp(f"Planning query on '{type_name}': {type(f).__name__}")
            plan = self._select(type_name, f, limit, exp)
            self._estimate_rows(plan, exp)
            if guard:
                self.store.apply_guards(plan)
            # degraded mode: a store that quarantined damaged partitions at
            # load answers from the survivors and warns instead of raising
            health = getattr(self.store, "health", None)
            if health is not None:
                w = health.warning_for(type_name)
                if w is not None:
                    plan.warnings = [w]
                    exp.warn(w)
        plan.planning_s = time.perf_counter() - t0
        return plan

    def _estimate_rows(self, plan: QueryPlan, exp) -> None:
        """Resolve the stats-sketch row estimate of a finished plan: the
        marginal-histogram product first, the z-prefix sketch of the
        chosen index as the fallback (the two tiers ``estimate_count``
        trusts). Skipped for id lookups (exact by construction) and
        disjoint plans (nothing scans)."""
        from geomesa_tpu_torch import conf

        if not conf.PLAN_ESTIMATE.get():
            return
        if plan.ids is not None or (plan.config is not None and plan.config.disjoint):
            return
        stats = self.store.stats_for(plan.type_name)
        if stats is None:
            return
        if isinstance(plan.filter, Include):
            est = float(stats.total_count())
        else:
            sft = self.store.get_schema(plan.type_name)
            est = stats.estimate_filter(sft, plan.filter)
            if est is None and plan.index is not None and plan.config is not None:
                est = stats.estimate_scan(plan.index, plan.config)
        if est is not None:
            plan.estimated_rows = float(est)
            exp(f"Estimated rows: ~{est:.0f} (stats sketch)")

    def _check_attr_visibility(self, type_name: str, f: Filter) -> None:
        auths = getattr(self.store, "auths", None)
        if auths is None:
            return
        sft = self.store.get_schema(type_name)
        from geomesa_tpu_torch.security import visible

        hidden = {
            a.name
            for a in sft.attributes
            if a.options.get("vis") and not visible(str(a.options["vis"]), frozenset(auths))
        }
        if not hidden:
            return
        blocked = sorted(hidden & _referenced_props(f))
        if blocked:
            raise QueryGuardError(
                f"filter references attribute(s) {blocked} whose "
                "visibility the configured auths do not satisfy"
            )

    def _scan_config(self, idx, f: Filter):
        """``idx.scan_config(f)`` through the memo: a warm repeated query
        skips the range decomposition (``plan.probe`` span), a cold one
        decomposes (``plan.decompose``). The decomposition runs outside
        the lock: two racing planners may both compute (the result is
        pure), never block each other on it."""
        from geomesa_tpu_torch.filter.predicates import canonical_key

        key = (idx, canonical_key(f))
        clock = self.store.clock
        with _ospan("plan.probe", index=idx.name):
            with self._memo_lock:
                memo = self._config_memo
                if key in memo:
                    memo.move_to_end(key)
                    clock.count("n.memo.hit")
                    return memo[key]
                epoch = self._memo_epoch
        clock.count("n.memo.miss")
        with _ospan("plan.decompose", index=idx.name):
            cfg = idx.scan_config(f)
        with self._memo_lock:
            if self._memo_epoch != epoch:
                # a mutation invalidated mid-compute: usable for this
                # query, never memoizable
                return cfg
            memo = self._config_memo
            memo[key] = cfg
            while len(memo) > _CONFIG_MEMO_MAX:
                memo.popitem(last=False)
        return cfg

    def _select(self, type_name: str, f: Filter, limit: Optional[int], exp) -> QueryPlan:
        plan = self._select_single(type_name, f, limit, exp)
        if plan.index is not None or plan.ids is not None:
            return plan
        # no single index serves the whole filter: try a multi-index union
        # over the DNF disjuncts (reference FilterSplitter.scala:61-147)
        union = self._select_union(type_name, f, limit, exp)
        return union if union is not None else plan

    def _select_union(
        self, type_name: str, f: Filter, limit: Optional[int], exp
    ) -> Optional[QueryPlan]:
        from geomesa_tpu_torch.filter.dnf import rewrite_dnf

        disjuncts = rewrite_dnf(f)
        if disjuncts is None or len(disjuncts) < 2:
            return None
        subs: list[QueryPlan] = []
        for d in disjuncts:
            sp = self._select_single(type_name, d, None, exp)
            if sp.config is not None and sp.config.disjoint:
                exp("Union: disjunct unsatisfiable, dropped")
                continue  # contributes nothing to the union
            if sp.index is None and sp.ids is None:
                exp("Union: a disjunct needs a full scan -> single-scan plan")
                return None  # one full scan beats full scan + index scans
            subs.append(sp)
        if not subs:
            # every disjunct unsatisfiable: an empty id lookup answers it
            return QueryPlan(type_name, f, None, ScanConfig.empty("union"), ids=[])
        if len(subs) == 1:
            # every other disjunct was unsatisfiable: the live branch IS the
            # query (its disjunct filter is equivalent to the whole filter)
            exp(f"Strategy: {subs[0].strategy} (other disjuncts unsatisfiable)")
            subs[0].limit = limit
            return subs[0]
        exp(
            f"Strategy: union of {len(subs)} index scans ("
            + ", ".join(s.strategy for s in subs) + ")"
        )
        return QueryPlan(type_name, f, None, None, limit=limit, union=subs)

    def _select_single(
        self, type_name: str, f: Filter, limit: Optional[int], exp
    ) -> QueryPlan:
        # id filters take absolute priority (reference IdFilterStrategy)
        ids = extract_ids(f)
        if ids.disjoint:
            exp("Id extraction: disjoint -> empty plan")
            return QueryPlan(type_name, f, None, ScanConfig.empty("id"), ids=[])
        if ids.values:
            exp(f"Strategy: id-lookup ({len(ids.values)} ids)")
            return QueryPlan(type_name, f, "id", None, ids=list(ids.values), limit=limit)
        options: list[tuple[float, str, ScanConfig]] = []
        for idx in self.store.indexes(type_name):
            cfg = self._scan_config(idx, f)
            if cfg is None:
                continue
            if cfg.disjoint:
                exp(f"Index {idx.name}: filter disjoint -> empty plan")
                return QueryPlan(type_name, f, idx.name, cfg, limit=limit)
            cost = self.cost(type_name, idx.name, cfg, exp)
            options.append((cost, idx.name, cfg))
            exp(f"Index {idx.name}: {cfg.n_ranges} ranges, cost {cost:.1f}")
        if not options:
            exp("Strategy: full-table host scan (no index serves this filter)")
            return QueryPlan(type_name, f, None, None, limit=limit)
        options.sort(key=lambda o: o[0])
        cost, name, cfg = options[0]
        exp(f"Strategy: {name} (cost {cost:.1f})")
        return QueryPlan(type_name, f, name, cfg, limit=limit)

    def cost(self, type_name: str, index_name: str, cfg: ScanConfig, exp=None) -> float:
        """Cost = rows the ranges cover x index multiplier (reference
        CostBasedStrategyDecider, StrategyDecider.scala:143-180); the row
        count is exact, from searchsorted over the host-resident keys. An
        armed tuning tier inflates the multiplier of an index whose row
        estimates chronically miss (bounded, hysteretic, explained);
        factor 1.0, or no reweighter, leaves the cost as it is."""
        mult = index_priority(index_name)
        rw = self.reweighter
        if rw is not None:
            fac = rw.factor(type_name, index_name)
            if fac != 1.0:
                mult *= fac
                if exp is not None:
                    # the JAX package's line, byte for byte
                    exp(f"Index {index_name}: estimate-accuracy reweight x{fac:.2f} (docs/tuning.md)")
        try:
            table = self.store.table(type_name, index_name)
        except KeyError:
            return mult  # no data written yet
        rows = sum(hi - lo for lo, hi in table.candidate_spans(cfg))
        return (rows + 1) * mult

    # -- execution -------------------------------------------------------
    def execute(
        self,
        plan: QueryPlan,
        explain: Explainer | None = None,
        hints=None,
        deadline=None,
    ) -> FeatureCollection:
        """Run a plan (through the result cache, when the store has one)
        and record it (``DataStore.record_query``); a QueryTimeout counts
        in ``geomesa.query.timeout`` and propagates. ``deadline``: an
        optional pre-anchored Deadline; by default the clock starts here,
        from the hint or store timeout."""
        t0 = time.perf_counter()
        try:
            out = self._execute_or_cached(plan, explain, hints, deadline)
        except QueryTimeout:
            self._record_timeout(plan)
            raise
        self.store.record_query(plan, len(out), time.perf_counter() - t0)
        return out

    def _execute_or_cached(self, plan: QueryPlan, explain=None, hints=None, deadline=None):
        """The result-cache tier around :meth:`_execute`: probe by
        canonical fingerprint, single-flight the scan on a miss, populate
        under cost-aware admission. Generation validation inside the
        cache guarantees a served entry reflects every committed
        mutation; the ``cache`` hint bypasses or pins per query."""
        cache = getattr(self.store, "cache", None)
        mode = getattr(hints, "cache", None) if hints is not None else None
        if cache is None or not cache.result.enabled or mode == "bypass":
            return self._execute(plan, explain, hints, deadline=deadline)
        exp = explain or ExplainNull()
        sft = self.store.get_schema(plan.type_name)
        key = cache.fingerprint_plan(plan, hints, sft, getattr(self.store, "auths", None))
        key_range = cache.key_range(plan.filter, sft)

        def compute():
            s0 = time.perf_counter()
            value = self._execute(plan, explain, hints, deadline=deadline)
            return value, time.perf_counter() - s0

        t_probe = time.perf_counter()
        out, status, probe_s = cache.result.get_or_compute(
            key, plan.type_name, key_range, compute, pinned=(mode == "pin")
        )
        plan.cache_status = status
        plan.cache_probe_s = probe_s
        # the probe phase is the get_or_compute prefix before any scan,
        # recorded from the measured probe_s
        tr = _otracer()
        tr.add_span(tr.current(), "probe", t0=t_probe, end=t_probe + probe_s, status=status)
        exp(f"cache: {status} (probe {probe_s * 1e3:.3f}ms, key {key[:12]})")
        return out

    def _record_timeout(self, plan) -> None:
        """A timed-out scan is still recorded: the timeout counter makes
        overdue queries visible in metrics instead of vanishing with the
        exception."""
        metrics = getattr(self.store, "metrics", None)
        if metrics is not None:
            metrics.counter("geomesa.query.timeout")

    def _deadline(self, hints):
        """Monotonic cutoff from the hint timeout or the store default."""
        timeout = getattr(hints, "timeout", None) if hints is not None else None
        if timeout is None:
            timeout = getattr(self.store, "query_timeout", None)
        return deadline_from(timeout)

    def _execute(
        self,
        plan: QueryPlan,
        explain: Explainer | None = None,
        hints=None,
        skip_visibility: bool = False,
        deadline=None,
    ) -> FeatureCollection:
        exp = explain or ExplainNull()
        if hints is not None:
            hints.validate()
        if deadline is None:
            deadline = self._deadline(hints)
        prog = self.store._fold_progress.get(plan.type_name)
        if prog is not None:
            # the query interleaves with a sliced fold (lock-free snapshot)
            exp(f"Streaming fold in progress: slice {prog[0]}/{prog[1]}")
        if plan.union is not None:
            return self._execute_union(plan, exp, hints, deadline)
        if plan.ids is not None:  # id lookup
            # one snapshot resolves AND gathers: a fold publishing in
            # between cannot shift the ordinals under the gather
            chunks = self.store.chunk_snapshot(plan.type_name)
            ordinals = self.store.id_lookup(plan.type_name, plan.ids, chunks=chunks)
            candidates = self.store.gather(plan.type_name, ordinals, chunks=chunks)
        elif plan.index is None:  # full host scan
            fc = self.store.features(plan.type_name)
            check_deadline(deadline, "full-table scan start")
            with _ospan("scan", index="full"):
                with exp.span("Full-table host scan"):
                    mask = plan.filter.evaluate(fc.batch)
            check_deadline(deadline, "full-table scan")
            self._note_actual(plan, int(mask.sum()), exp)
            with _ospan("decode", candidates=plan.actual_rows):
                return self._post(fc.mask(mask), plan, hints, exp, skip_visibility)
        elif self.store.row_count(plan.type_name) == 0:
            # schema exists but nothing written yet: no index tables
            candidates = self.store.features(plan.type_name)
        else:
            # a simple index scan: the shared launch/finish implementation
            # (finish runs at once here; query_many defers it)
            return self._submit_simple(
                plan, exp, hints, skip_visibility, deadline=deadline
            )()
        return self._refine_and_post(
            plan, candidates, None, hints, exp, deadline, skip_visibility
        )

    def _execute_union(self, plan: QueryPlan, exp, hints, deadline) -> FeatureCollection:
        """Run every union branch on its own index, each refined with its
        own disjunct filter, and dedup-union by feature id: branches in
        disjunct order, each row where it first appears (reference:
        per-option scans merged client-side with deduplication,
        FilterSplitter OR semantics). The query's one deadline bounds all
        branches: each gets the remaining budget, not a fresh one.
        Branches skip visibility; it and the hints' stages apply once,
        after the merge."""
        from geomesa_tpu_torch.planning.hints import QueryHints

        parts = []
        for sp in plan.union:
            sub_hints = None
            if deadline is not None:
                check_deadline(deadline, f"union branch [{sp.strategy}]")
                sub_hints = QueryHints(timeout=max(deadline.remaining(), 1e-9))
            with exp.span(f"Union branch [{sp.strategy}]"):
                parts.append(
                    self._execute(sp, explain=exp, hints=sub_hints, skip_visibility=True)
                )
        check_deadline(deadline, "union merge")
        nonempty = [p for p in parts if len(p)]
        if not nonempty:
            self._note_actual(plan, 0, exp)
            return self._post(parts[0], plan, hints, exp)
        out = nonempty[0] if len(nonempty) == 1 else FeatureCollection.concat(nonempty)
        _, first = np.unique(np.asarray(out.ids), return_index=True)
        if len(first) != len(out):
            exp(f"Union dedup: {len(out)} -> {len(first)} rows")
            out = out.take(np.sort(first))
        # the union's matched rows before _post's limit and visibility
        # (record_query's hits would compare the estimate against a
        # truncated result)
        self._note_actual(plan, len(out), exp)
        return self._post(out, plan, hints, exp)

    # -- pipelined multi-query execution ---------------------------------
    def _is_simple(self, plan: QueryPlan) -> bool:
        """True when the plan is a plain index scan whose device work can
        launch ahead of finish(); one predicate shared by submit and
        submit_many so their routing cannot drift."""
        return (
            plan.union is None
            and plan.ids is None
            and plan.index is not None
            and plan.config is not None
            and self.store.row_count(plan.type_name) > 0
        )

    def submit(self, plan: QueryPlan, explain: Explainer | None = None,
               hints=None, deadline=None):
        """Stage one query: launch its device scan now, return a zero-arg
        ``finish()`` producing the FeatureCollection. A plan without a
        simple index scan (a union, an id lookup, a full host scan, an
        empty store) runs inside finish(). An explicit ``deadline`` bounds
        both paths; by default each budget starts at finish()."""
        exp = explain or ExplainNull()
        if not self._is_simple(plan):
            return lambda: self.execute(plan, explain=exp, hints=hints, deadline=deadline)
        if hints is not None:
            hints.validate()
        return self._record_wrap(plan, self._submit_simple(plan, exp, hints, deadline=deadline))

    def _record_wrap(self, plan, inner):
        """finish() wrapper that records the query (timing, timeouts): one
        implementation for submit and submit_many's fused finishes, so
        batched and single queries are recorded alike."""

        def finish() -> FeatureCollection:
            t0 = time.perf_counter()
            try:
                out = inner()
            except QueryTimeout:
                self._record_timeout(plan)
                raise
            self.store.record_query(plan, len(out), time.perf_counter() - t0)
            return out

        return finish

    def submit_many(self, plans, hints=None, explains=None, deadlines=None) -> list:
        """Stage many queries: simple index-scan plans sharing a (type,
        index) table go through the table's fused multi-query scan
        (``scan_submit_many``: one kernel launch per chunk instead of one
        per query); the rest take :meth:`submit`. Returns one ``finish()``
        per plan, in input order.

        ``hints``: one QueryHints for every plan, or a sequence aligned
        with ``plans`` (hints shape only post-processing and deadlines,
        never the device scan, so plans with different hints still fuse).
        ``explains``: optional per-plan Explainers. ``deadlines``: optional
        per-plan Deadlines anchoring each plan's budget at an earlier
        instant instead of at its finish()."""
        def aligned(seq, what):
            if seq is None:
                return [None] * len(plans)
            if len(seq) != len(plans):
                raise ValueError(f"{what} sequence length {len(seq)} != plans {len(plans)}")
            return list(seq)

        per = aligned(hints, "hints") if isinstance(hints, (list, tuple)) else [hints] * len(plans)
        exps = aligned(explains, "explains")
        dls = aligned(deadlines, "deadlines")
        finishes: list = [None] * len(plans)
        groups: dict[tuple, list[int]] = {}
        for j, plan in enumerate(plans):
            if self._is_simple(plan):
                groups.setdefault((plan.type_name, plan.index), []).append(j)
            else:
                finishes[j] = self.submit(plan, explain=exps[j], hints=per[j], deadline=dls[j])
        seen: set = set()  # validate each distinct hints object once
        for idxs in groups.values():
            for j in idxs:
                h = per[j]
                if h is not None and id(h) not in seen:
                    seen.add(id(h))
                    h.validate()
        for (tname, iname), idxs in groups.items():
            if len(idxs) == 1:
                j = idxs[0]
                finishes[j] = self.submit(plans[j], explain=exps[j], hints=per[j], deadline=dls[j])
                continue
            table, chunks = self.store.pin_scan_state(tname, iname)
            scan_fins = table.scan_submit_many(
                [plans[j].config for j in idxs], clock=self.store.clock
            )
            for j, scan_fin in zip(idxs, scan_fins):
                finishes[j] = self._record_wrap(plans[j], self._submit_simple(
                    plans[j], exps[j] or ExplainNull(), per[j],
                    finish_scan=scan_fin, deadline=dls[j], chunks=chunks,
                ))
        return finishes

    def execute_many(self, plans, hints=None) -> list:
        """Execute several plans with every device scan launched before any
        result is pulled; scans sharing a table fuse (submit_many)."""
        return [f() for f in self.submit_many(plans, hints=hints)]

    def _submit_simple(self, plan: QueryPlan, exp, hints, skip_visibility=False,
                       finish_scan=None, deadline=None, chunks=None):
        """Launch a simple index-scan plan's device work now (or take the
        ``finish_scan`` of an already launched fused chunk); return
        ``finish()`` -> FeatureCollection. The deadline clock starts when
        finish() runs unless an explicit ``deadline`` anchors it earlier;
        its first check follows the copy that ends the scan. The chunk
        snapshot is pinned at launch, beside the table
        (``pin_scan_state``): the scan's ordinals gather against the rows
        it scanned, however a mutation publishes in between. ``chunks``:
        the snapshot a fused chunk was launched on."""
        clock = self.store.clock
        if finish_scan is None:
            with _ospan("dispatch", index=plan.index):
                table, chunks = self.store.pin_scan_state(plan.type_name, plan.index)
                finish_scan = table.scan_submit(plan.config, clock=clock)
        elif chunks is None:
            chunks = self.store.chunk_snapshot(plan.type_name)

        def finish(deadline=deadline) -> FeatureCollection:
            if deadline is None:
                deadline = self._deadline(hints)
            with _ospan("scan", index=plan.index):
                with exp.span(f"Device scan [{plan.index}]"):
                    ordinals, certain = finish_scan()
                check_deadline(deadline, "scan result pull")
            exp(f"Candidates: {len(ordinals)}")
            with _ospan("decode", candidates=len(ordinals)):
                with clock.host("decode"):
                    candidates = self.store.gather(plan.type_name, ordinals, chunks=chunks)
                return self._refine_and_post(
                    plan, candidates, certain, hints, exp, deadline, skip_visibility
                )

        return finish

    def _refine_and_post(self, plan, candidates, certain, hints, exp, deadline,
                         skip_visibility=False):
        """Refinement tiers (reference Z3IndexKeySpace.useFullFilter):
        - the device mask decides the filter: only the uncertain boundary
          rows (wide & ~inner) re-check on host;
        - the ``loose`` hint, where the mask decides the filter: the
          widened device plane is the answer, nothing refines (reference
          LOOSE_BBOX);
        - otherwise the full filter refines every candidate."""
        decided = mask_decides_filter(
            plan.filter, plan.config, self.store.get_schema(plan.type_name)
        )
        loose_ok = hints is not None and getattr(hints, "loose", False) and decided
        clock = self.store.clock
        if loose_ok or (decided and isinstance(plan.filter, Include)):
            exp("Loose mode: device mask accepted without refinement")
        elif decided and certain is not None:
            unc = np.flatnonzero(~certain)
            exp(f"Refinement: {len(unc)} uncertain of {len(certain)} candidates")
            if len(unc):
                check_deadline(deadline, "boundary refinement start")
                with clock.host("refine"), exp.span("Boundary refinement"):
                    sub_mask = plan.filter.evaluate(candidates.take(unc).batch)
                    keep = certain.copy()
                    keep[unc] = sub_mask
                    if not bool(keep.all()):
                        candidates = candidates.mask(keep)
        elif not isinstance(plan.filter, Include):
            check_deadline(deadline, "residual refinement start")
            with clock.host("refine"), exp.span("Residual filter refinement"):
                mask = plan.filter.evaluate(candidates.batch)
                if not bool(np.all(mask)):
                    candidates = candidates.mask(mask)
        check_deadline(deadline, "refinement")
        # estimate accountability: the post-refinement row count (what the
        # sketch estimate predicts), before _post's limit and visibility
        self._note_actual(plan, len(candidates), exp)
        clock.count("n.rows.matched", plan.actual_rows)
        return self._post(candidates, plan, hints, exp, skip_visibility)

    @staticmethod
    def _note_actual(plan, actual: int, exp) -> None:
        """Record one executed plan's matched-row count next to its
        sketch estimate (explain line; record_query feeds the pair to the
        error histogram and the per-index accuracy windows)."""
        plan.actual_rows = actual
        if plan.estimated_rows is not None:
            from geomesa_tpu_torch.obs.accuracy import error_factor

            exp(
                f"Estimate vs actual: ~{plan.estimated_rows:.0f} est / "
                f"{actual} matched "
                f"({error_factor(plan.estimated_rows, actual):.2f}x)"
            )

    def _post(self, out, plan, hints, exp, skip_visibility: bool = False):
        """Client-side reduce pipeline: visibility -> sample -> sort ->
        offset -> limit -> reproject -> transform (reference
        QueryPlanner.scala:66-102: reducer, sort, startIndex,
        maxFeatures, projection), timed as the store clock's ``post``."""
        with self.store.clock.host("post"):
            return self._reduce(out, plan, hints, exp, skip_visibility)

    def _reduce(self, out, plan, hints, exp, skip_visibility: bool):
        # row-level security: mask rows whose visibility label the store's
        # auths cannot satisfy (reference VisibilityEvaluator tier)
        auths = None if skip_visibility else getattr(self.store, "auths", None)
        if auths is not None:
            from geomesa_tpu_torch.security import VIS_FIELD_KEY, visibility_mask, visible

            sft = self.store.get_schema(plan.type_name)
            vis_field = sft.user_data.get(VIS_FIELD_KEY)
            if vis_field and len(out):
                out = out.mask(visibility_mask(out.columns[vis_field], auths))
                exp(f"Visibility filter: {len(out)} visible")
            # attribute-level security: an attribute whose ``vis=<label>``
            # option the auths cannot satisfy is projected out of the
            # result (rows stay visible, the value does not)
            hidden = [
                a.name
                for a in out.sft.attributes
                if a.options.get("vis") and not visible(str(a.options["vis"]), frozenset(auths))
            ]
            if hidden:
                keep = [a.name for a in out.sft.attributes if a.name not in hidden]
                out = out.project(keep)
                exp(f"Attribute visibility: hid {hidden}")
        exp(f"Hits: {len(out)}")
        if hints is not None:  # validated at _execute entry
            if hints.sample is not None:
                out = out.sample(hints.sample, hints.sample_by)
                exp(f"Sampled: {len(out)}")
            if hints.sort_by:
                out = out.sort_values(hints.sort_by)
        off = hints.offset if hints is not None and hints.offset else 0
        if off or (plan.limit is not None and len(out) > plan.limit):
            # one gather for the page
            lo = min(off, len(out))
            hi = len(out) if plan.limit is None else min(lo + plan.limit, len(out))
            out = out.take(np.arange(lo, hi))
            if off:
                exp(f"Offset {off}: rows [{lo}, {hi})")
        if hints is not None and hints.reproject is not None:
            from geomesa_tpu_torch.crs import reproject_collection

            out = reproject_collection(out, hints.reproject)
            exp(f"Reprojected to {hints.reproject}")
        if hints is not None and hints.transforms is not None:
            out = out.transform(hints.transforms)
        return out
