#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of geomesa on one CUDA card and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card (nvidia-smi name and power limit, torch's device
   name, the host's CPU count) and the build times — every CUDA kernel
   builds from geomesa_tpu_torch/csrc with nvcc for sm_90a, and the
   native host helpers (geomesa_tpu_torch/native) with g++, loaded
   before any path;
   then the lint phase: the port's static analysis
   (``python -m geomesa_tpu_torch.scripts.check --json``) over the tree
   this script sits in, its findings, rule count, wall and CPU seconds on
   a line of their own; any finding fails the run (it needs no kernel, so
   it runs before the first path);
2. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the main path's shapes (SUB = 128 over as many blocks as
   the 100M-row table; K1 at M in {32, 256, 4096} and the whole table
   padded to its bucket; the fused scan K2 at M in {32, 2048} with 48
   queries of differing slot counts, interleaved; the count K1p at M in
   {32, 4096} and the whole table; K1's point-in-polygon and raster legs
   at M = 4096 (PIP at E 16, 64, 256, the raster at R 16, 64, 256, both
   legs at R 16 + E 64) and K2's edge and raster stacks at M = 2048 with
   48 polygon queries, each with and without the window; then the
   extent leg of all five on synthetic extent columns: K1 and K1p at
   M = 4096 and K2 at M = 2048 with 48 extent queries of 1-8 box slots,
   each with and without the window, the window alone and the validity
   leg, K3 and K4 over the bbox centres; K3 again on a clustered shape,
   the main shape's columns with half of the rows in 64 gaussian clusters
   of sigma 0.5 degrees); K2 at the standing matcher's shape (a
   20,000-row batch in 5 blocks of SUB = 32 with +inf pad rows, a full
   chunk of 128 star geofences per fused E bucket 16, 64 and 256, pad
   slots to the 1,024-slot bucket, columns x and y only); results must be
   equal word for word; each kernel's and leg's time (CUDA events, median
   of 25 runs after warm-up: the launch alone, and the whole wrapper with
   its staging) beside its bound and the plain version's time, K3's on
   the uniform and the clustered shape, K1's box + window launch also at
   M = 32 and 256, the main path's small buckets;
3. probes: the chip-side design probes at the JAX probes' sizes, each
   through its own ``run`` (geomesa_tpu_torch/scripts/): P1
   (``probe_pallas``: 64 Mi rows of x, y, tbin, toff, 1.07 GB on the
   card, M = 128 and 1024: the scan kernel over the live slots, its
   end-to-end query, and K1 on the same columns as the yardstick, on
   the probe's params and on the same predicate split into 8 real slots
   of each leg, where K1 does P1's slot work) and P2 (``probe_agg``:
   4096 blocks of x, y, 0.54 GB, M = 256 and 1024: the bounds kernel and
   the density kernel, which both TPU bodies launch, on the probe's box
   and on it split into 8 strips, K1, K3 and ``bincount`` as
   yardsticks); every probe kernel equal to its plain version word for
   word at both M, pad slots included, on the split and on the staging
   edge cases (pad, inverted, NaN and infinite slots, one plane live, a
   leg with no live slot), P1's rows at M = 128 equal to numpy's; the
   columns are freed before the main path;
4. main path: a GDELT-shaped Z3 point table of 100,000,000 rows (the
   reference benchmark's configuration 1, cut from 500M for the run's
   time; with GDELT's ``EventRootCode`` as a host string column) in
   ``DataStore(device="cuda")``, 16 warm-up and 64 measured
   BBOX + DURING queries (latency untraced, then a traced pass of the same
   queries for the per-phase split), 8 of them checked against an f64 brute-force
   filter, 4 density grids and 4 bounds estimates checked against the
   plain versions on the same device table; the record gives the
   candidate blocks of every measured query's K1 launch (its M bucket and
   its real blocks: median, p90, max), the shapes K1 runs at there;
5. batch path, on the same store: ``query_many`` over the 64 queries (a
   warm call, a timed one, then a traced one for the per-phase split),
   the serving scheduler under 8 client threads of 8 queries each,
   ``density_many`` over the 4 busiest queries' envelopes and 8
   ``stats_query("Count()", estimate=True)``;
   ids equal the sequential queries', grids the sequential ``density``
   grids, and each count the table's count arithmetic over the plain
   popcount;
6. polygon path, on the same store: 8 warm-up and 48 measured
   ``INTERSECTS(geom, <star polygon>) AND dtg DURING`` queries (4 with a
   hole, 2 MultiPolygons, 2 past 256 edges), untraced then traced,
   ``query_many``, the scheduler (8 threads x 6 queries), 16 of them
   again with ``geomesa.raster.residue=device`` and with
   ``geomesa.raster.enabled=false`` (and all 48 through ``query_many``
   under each), count / bounds / Count() / density
   over 4 of them, and the full-table host scan the port used to run on
   2; ids, counts, envelopes and grids checked against an f64 brute
   force, every other path's ids against the sequential queries';
6b. gdelt-z3-100M-hints, the query controls on the same store (no new
   table): 16 of the measured queries (the fewest hits past one page)
   sorted by ``dtg`` ascending and descending against the f64 brute force
   stably sorted with the reference's tie rule, their ``offset`` pages
   of 1,000 concatenating to the whole, and the same through
   ``query_many``; ``sample=0.1`` plain and by ``EventRootCode`` equal to
   ``FeatureCollection.sample`` of the exact result; transforms (``dtg``,
   ``st_x``, ``st_y``) equal to the source columns; ``EPSG:3857``
   coordinates within 1e-6 m of the f64 formula; ``loose=True`` ids equal
   to the rows K1's plain version marks in the wide plane (a superset of
   the exact ids) with no refinement time, p50 beside the exact queries';
   ``QueryHints(timeout=1e-6)`` raising QueryTimeout on a query, on
   ``query_many`` and on an id-or-box union, each counted in
   ``geomesa.query.timeout``, exact ids after it and under a generous
   store timeout; ``block_full_table_scans`` rejecting a full-table scan
   and passing INCLUDE, a ``TemporalQueryGuard`` rejecting a window past
   a week; a MetricsRegistry and an AuditWriter over the 64 measured
   queries (counts and hits equal the main path's, the scan histogram's
   p50 within one bucket of the measured one, one audited event per
   query); then the 64 queries untraced and traced (sample 1, a 1 ms
   slow log), the Chrome export holding plan, dispatch, scan and decode
   for each query, the slow ring non-empty, the trace's phase breakdown
   beside PhaseClock's; tracing is disarmed in every other measured pass;
7. a 10,000,000-row table with packed time, 16 queries, ``query_many``
   and two count estimates;
8. a Z2 table of 20,000,000 points (the reference benchmark's
   configuration 4): the polygon path with 32 queries and no time;
9. osm-xz2-50M: the reference benchmark's configuration 3, building
   footprints on an XZ2 table, cut from 200M to 50M rectangles, and to
   25,000,000 for the script's wall (``reduced``);
   8 warm-up and 40 measured INTERSECTS rectangle queries untraced, then
   traced, ``query_many``, the scheduler (8 threads x 5 queries),
   ``IndexTable.count`` / ``density`` / ``bounds_stats`` over 4 of them
   against the plain versions on the same device table, and 8 queries'
   ids and counts against an f64 brute force;
10. xz3-10M-mixed: 10,000,000 extent features with dates over 120 days
   on an XZ3 table, 99 % footprint rectangles and 1 % triangles, stars,
   LineStrings and MultiPolygons; 8 warm-up and 32 measured INTERSECTS
   (rectangle, star) and BBOX queries AND DURING, and DURING alone,
   untraced then traced, ``query_many``, and 8 queries' ids against an
   f64 brute force written here (box algebra, even-odd vertex tests and
   edge crossings);
11. gdelt-z3-10M-tiered: a 10,000,000-row GDELT-shaped store on Z3 and
   Z2 takes two appends of 1,000,000 rows with recent times (hourly
   loads into a standing table). The first stays in the delta tier: 8
   BBOX + DURING queries give the main table's ids then the delta's f64
   brute-force hits, in order and under a limit, counts, both bounds,
   count estimates and density grids equal to the brute force over the
   delta plus the plain versions over the main table, and ``query_many``
   (16 queries, fused) the same ids. The second compacts: ids in order
   equal a store written once with all 12M rows, appended rows first
   where (bin, z) keys tie. Then 4 ``BBOX OR dtg
   DURING`` queries plan as
   unions of a Z2 and a Z3 scan: the box branch's ids, then the window
   branch's unseen ids, each branch equal to an f64 brute force;
12. gdelt-z3-10M-mutate (2,000,000 rows, the cell's 10M cut for the
   script's wall, ``reduced``): a
   GDELT-shaped store on Z3 and Z2 takes ``fold_upsert`` of 500,000
   rows (250k moving objects reporting again in the span's last 21
   days, 250k new ids; 8 slices of 65,536 rows on the device fold; the
   cell's 1M in 16 slices cut for the script's wall, ``reduced``),
   ``upsert`` of 10,000 ids,
   ``modify_features`` of ``dtg`` over a BBOX + DURING filter,
   ``delete_features`` over a 10 x 10 degree box and ``age_off`` with a
   90-day TTL, against a numpy model of the live rows: after every op
   10 BBOX + DURING queries equal the model's f64 brute force as sets
   and in (bin, z, ordinal) order, and ``id_lookup``, ``id_exists_mask``
   and an ``IN`` query over 1,000 ids (half removed) equal the model;
   the first and last slices' device-folded tables equal a host-path
   fold of the same slice and (last) a full build, bitwise on the card,
   and upload only the slice's rows; on the final store ``query_many``
   of 16, 4 count estimates, densities and bounds against the plain
   versions, and ``warmup()``; then the pinned-snapshot check of the
   raster aggregation push-down: a 12-edge star polygon over a dense
   cluster (raster-eligible on Z2, with certain rows and a residue),
   with a hook on ``gather`` that deletes a 1 x 1 degree box inside the
   star (a publish) before it gathers; ``count``, ``bounds`` (both
   ``estimate`` settings) and ``Count()`` equal the f64 brute force of
   the snapshot each scan ran on, and K1 launched with its raster leg;
13. gdelt-attr-10M: 2,000,000 GDELT-shaped points (the cell's 10M, cut
   for the script's wall; ``reduced`` says so) with two string attribute
   indexes (``EventCode``: 300 CAMEO-shaped codes of 2-4
   digits; ``Actor1Name``: 2,000 upper-case names of 3-40 characters,
   many sharing an 8-byte prefix; both Zipf-Mandelbrot skewed) beside Z3
   and Z2, all four tables on the card; 16 code equalities, 8 name
   ranges and 8 codes AND BBOX AND DURING against a numpy brute force
   in the reference's order (value, then id; the z order where a z
   index plans) and under ``limit=10``, ``query_many`` of the 32 and of
   16 rare-code regional queries (fused), 4 count estimates >= the
   exact counts; then two 50k-row appends with names of other widths
   stay in the delta and the 32 queries run again;
14. gdelt-z3-10M-persist: a 2,000,000-row GDELT Z3 store (the cell's
   10M cut for the script's wall, ``reduced``) with
   ``EventRootCode`` answers 16 measured queries, 4 densities, both
   bounds and 4 count estimates; ``persist.save`` writes it to a
   temporary directory on local disk (removed at the end) and
   ``persist.load(device="cuda")`` reads it back: every table on the
   card, ids identical and in order, grids, bounds and estimates
   identical, ``query_many`` in order; 50k rows appended in the span's
   last 21 days and a second save rewrite only the touched partitions,
   and a load reads that save back whole; one byte flipped in one
   committed partition: the load quarantines it (one ``checksum``
   record, ``report.json``, ``geomesa.store.quarantined``), every plan
   carries the degraded warning and ``geomesa.query.degraded`` counts
   it, and the ids are the whole store's minus that partition's rows,
   in order, and equal an f64 brute force over the source columns; a
   crash at each of the seven ``persist.*`` fault points during a second
   save over a committed 200k-row store loads the old or the new store,
   never a mix; the same 10M rows on ``HostAdapter`` answer the 16
   queries as the device store, in order; the lock witness armed around
   a small write, query and fold workload gives an acyclic graph (its
   edges in the record);
15. gdelt-z3-10M-secure-cached: 2,000,000 GDELT-shaped events (the
   cell's 10M cut for the script's wall, ``reduced``) on Z3 and
   Z2 with ``EventRootCode`` declared ``vis=secret`` and a ``vis`` label
   column from the path's own seed (50 % public, 20 % ``analyst``, 15 %
   ``analyst&secret``, 10 % ``secret|ops``, 5 % ``ops``): analysts with
   different clearances share one event store, dashboards repeat the
   same queries and counts. Statistics: ``stats_for`` (count, min/max of
   x, y and dtg, the top-k) against numpy, ``estimate_count`` of the 64
   main queries with each error factor against the exact count (median
   and p90 printed); ``delete_features`` of one region and ``age_off`` of
   the first 7 days, then ``analyze_stats`` equal to a ``StatsStore.build``
   of the surviving rows; a fold that moves one region's rows away and,
   with auto-analyze on and a forced stale window, one query from each of
   8 ``serve()`` threads: exactly one analyze. Visibility: four stores by
   auths (None, (), analyst, analyst+secret): the 64 queries' ids in
   order equal the None store's filtered by the script's own label
   evaluator (and the masked f64 brute force), ``query_many`` launches
   K2, count, both Count() forms, density and both bounds over the 4
   busiest equal the host brute force over the visible rows, each
   visibility-active aggregation counted in ``geomesa.query.vis_fallback``
   and launching no K1p, K3 or K4 (K1 scans), while the None store's
   launch all three; a filter on ``EventRootCode`` raises without
   ``secret``, whose results lack the column. Views: the rows split by
   id parity into two stores; a ``MergedView`` gives the whole store's
   ids as a set, its counts, grids and both bounds; a ``RoutedView`` by
   time half answers as the store it routes to. Cache: a
   ``DataStore(cache=True)`` runs the 64 queries cold then warm (64
   result hits, no K1 launch, ids identical), 32 panned dashboard boxes
   through ``count`` and exact ``bounds`` twice (equal to the brute
   force; the second pass reuses tiles; the cache section runs on the
   path's first 1,000,000 rows, held against an uncached store of them
   and the brute force), then a ``fold_upsert`` of 10k
   rows in one box, a 50k ``write`` in another and a ``delete_features``:
   after each, every query equals a ``cache="bypass"`` query in order and
   the brute force, and the entries away from the mutated box stay hits
   (the delete rebuilds the tables, so all fill again); then
   ``persist.save`` and ``persist.load(cache=...)`` with the warm cache:
   no stale hit, the same answers;
16. gdelt-z3-10M-served: 10,000,000 GDELT-shaped events on Z3 with
   ``EventRootCode`` on a ``DataStore(cache=True)`` (result cache 1 GiB)
   behind ``serve(ServingConfig(queue_max=256))`` with a
   ``TenantRegistry`` (``gold`` weight 8 quota 64, ``bronze`` weight 1
   quota 8), ``attach_slo()`` and ``serve_ops(port=0)`` on loopback:
   dashboard clients of two teams query one shared event store while
   operators scrape it. The fair mix: 16 client threads (8 a tenant) send
   each of the 64 main queries 4 times in a seeded order, every answer's
   ids in order equal to the sequential (cache-bypassing) query's, 16 of
   them to the f64 brute force, identical queries coalesced, leaders +
   coalesced + cache hits = 256, K2 launched; the 64 queries again: 64
   result hits served at admission, no K1 or K2 launch, nothing queued;
   a flood of 200 non-blocking ``bronze`` queries beside 16 ``gold``
   ones: ``bronze`` sheds at its quota, ``gold`` sheds none, served +
   shed = submitted per tenant; 16 queries with a 1 us timeout hint all
   shed with QueryTimeout; on unstarted schedulers 8 copies each of nine
   queries scan once per distinct query (K2 slots and lone K1
   launches), and a query staged on either
   side of a 50k-row write into its box gives two leaders and the new
   rows; ``/metrics`` parses strictly with the registry's serving
   counters, ``/health`` ready (then degraded with ``slo.breach`` under a
   1 us objective), ``/stats`` equal to ``stats_for``, the debug routes
   answer JSON, the p50 of 50 scrapes of each route; ``close()`` leaves no
   serving or ops thread, the ops port rebinds at once, the store still
   answers and ``serve()`` gives a fresh scheduler;
17. moving-z3-3M-stream: the reference's own streaming scenarios
   (``bench.py`` ``config_stream`` and ``config_wal``). ``sustained``: a
   cold Z3 store of 3,000,000 tracked objects (name, one day of times,
   a point), ``serve()`` attached; 6 flushes (the reference's 24, cut
   for the script's wall, ``reduced``), each a 20k-row batch (half
   updates of existing ids with fresh positions and times, half new
   ids) written in 2048-row sub-batches and ``flush()``ed, then
   ``persist_hot()`` inside the timed wall, while 4 clients poll mixed
   BBOX and BBOX + DURING boxes through ``LambdaStore.query`` every 150
   ms; every one of 24 probe queries' ids and values equal a numpy model
   of the final state; then the legacy flush for 2 flushes. ``wal``: a
   200k store and 100k rows of the same write + flush workload with no WAL and under
   ``sync`` off, interval and always (rows/s each, fsync times, the
   interval / no-WAL ratio beside the reference's 0.85); a
   ``checkpoint``, a crash and ``LambdaStore.recover`` on the card equal
   to the live store; on the recovered store ``/health`` names
   ``hot.occupancy`` over 2 x ``fold_rows`` and drops it after
   ``persist_hot``, the scrapes launch nothing, the constructor refuses
   a log with records past its cover, an explicitly opened one reports
   ``wal.needs_recovery`` and ``recover`` clears it; then a recovery run
   (streamed rows with a watermark per batch, a crash, ``recover`` timed
   on the card, every row surfaced, the probes equal). ``close()`` of
   every store leaves no streaming, serving or ops thread;
18. moving-standing-1M: the reference's ``config_standing`` at its
   sizes but for the events. 1,000,000 tiny squares (half-widths 0.005-0.03 degrees), 96
   jagged stars of 8-120 arms in the hotspot box (0, 10, 12, 22) and 16
   convex rings, 1,000,112 in all, registered through
   ``register_geofences`` on a WAL-backed LambdaStore whose cold store is
   on the card, every fused E bucket warmed with the gate; 40,000 events
   (the reference's 200,000, halved for the path's 75 s budget and cut
   again for the script's wall; listed in ``reduced``; 20 % in the
   hotspot) in 20k
   batches, each ``write`` then ``flush``,
   with the matcher off and on (rows/s and their ratio beside the
   reference's 0.9); the inverted index per event against the naive
   evaluation of every subscription on 16 sampled events (beside the
   reference's 50x floor); alerts, fused dispatches, ``gate.host``, and
   the ``geomesa.standing.latency`` p99 beside the 250 ms objective.
   Checks: over 1,500 sampled events the match sets equal a plain f64
   even-odd ray cast over each event's bbox candidates (written here);
   every hotspot event of every batch gives the same match set through a
   fused engine (gate off, one point enough) and a host one, and K2
   launches with its point-in-polygon leg; 1,000 fences ``subscribe()``d
   after a checkpoint survive ``wal.crash()`` and ``recover`` on the card,
   the recovered engine matching one batch as the live one; ``close()``
   leaves no thread;
19. moving-replica-60k: the reference's ``config_replica`` at its
   defaults: a leader over a 60,000-row cold store, two ReplicaStore
   followers over PipeTransport bootstrapped on the card, every probe's
   ids equal to the leader's in order once caught up (before and after
   the first streamed batch); one 2 s read window per store (q/s at 0, 1
   and 2 followers, the scaling beside the reference's 1.5x); 40,000 rows
   streamed in 2,000-row batches under ``sync=always`` with the shipper
   and apply threads running, the staleness p99 beside the 2,000 ms
   objective; the leader killed at 70 % of the stream (``wal.crash()``)
   and a follower promoted from the dead leader's WAL (timed): no
   acknowledged row lost, none invented, the lagging follower holding
   nothing never written, a term-0 shipment refused; ``serve_ops()`` of
   the lagging follower: ``/health`` with the ``replica`` section,
   ``/stats`` answering, no kernel launched by the scrapes; ``close()``
   of every store and the shipper leaves no thread;
20. gdelt-ingest-20M: the reference's ``config_ingest``. 10M GDELT-shaped (the cell's 20M, cut)
   rows over 80 days in 1M-row chunks on Z3 and Z2, loaded by
   ``BulkLoader`` at 1 and 4 workers (the reference's 1, 2 and 4 cut for
   the path's 90 s, and its sequential ``write`` loop cut for the
   script's 900 s once paths 22-24 came; ``reduced``), each store closed
   and released before the next; rows/s, the x4 speedup over x1, stage
   seconds; the x4 load's tables identical to the x1 load's by the
   reference's fingerprint (device columns read back). On the last load:
   the 64 BBOX + DURING queries' ids equal the x1 store's in order and an f64 brute force on 8, density and
   bounds equal their plain versions on 4, ``bin_query`` on 8 equals
   ``bin_format.encode`` of the brute-force rows; 312,500 rows (n/64)
   appended and compacted under an RSS sampler (peak RSS over the host
   column set; the reference's row is 100M, ``reduced``). Then 200k
   seeded rows as 8 CSV splits with 1 % bad rows (half malformed, half
   outside the ``z-bounds`` validator's domain) through
   ``ingest_files(workers=4)``, its parse pool forked after CUDA and the
   native helpers are up: the good rows' ids in split order, the error
   reasons equal to numpy's counts; one query exported as CSV, GeoJSON,
   Avro, Shapefile, TWKB and BIN and read back with equal ids (rows in
   order where a format keeps no id) and coordinates;
21. gdelt-z2-20M-analytics: the analytics tier on the Z2 polygon cell's
   20,000,000 GDELT points, built again with the cache tier. kNN
   (``config_knn``): 64 points near the data, k = 10, through
   ``knn_many`` (the rounds' windows fused into K2) and per point through
   ``knn_search`` (K1), both equal in order to an f64 brute-force top k
   (the card's f64 haversine over every row picks 64 candidates, numpy's
   orders them). Joins (``config_pip_join``): ``spatial_join_indexed`` of
   64 concave stars (its 128) of 16-254 edges, ``contains`` and ``intersects``,
   rasters off and on, pairs equal to an f64 even-odd ray cast run on the
   card over each star's bbox; the host grid join exact and adaptive on a
   seeded 2M-row sample, equal to each other and to the ray cast. The
   tile pyramid at the reference's leaf zoom 3 and 256 px: all 170 tiles
   of zooms 0-3 cold (leaves first) then warm, each equal to
   ``TilePyramid.fresh`` bit for bit, every zoom counting each row once,
   each kind rendered on 4 tiles and inflated; a 10k-row write inside one
   leaf leaves far tiles warm at their ticks and recomposes the leaf and
   its three ancestors, equal to ``fresh``. Eight ``sql_query``
   statements (bbox, ``ST_Intersects``, ``ST_Contains``, ``ST_Within``,
   ``ST_DWithin``, ``ORDER BY`` / ``LIMIT`` on an alias, residual
   ``ST_DistanceSphere``, a residual with ``OFFSET``) equal to the f64
   brute force. Then ``proximity_search``, ``tube_select`` and
   ``route_search`` on a 1M-row Z3 + Z2 store with times and headings,
   each equal to an f64 brute force over every row;
22. moving-z3-2M-http: the reference's data-plane scenario
   (``config_serve_http``) with its cold store raised from 40k to
   1,000,000 rows (the cell's 2M, cut): a saved cold store served as a LambdaStore with a WAL
   under ``sync=always`` through ``serve(port=0)`` on loopback. The
   GeoJSON body of each of three probe boxes equals ``_geojson`` of the
   in-process query byte for byte, at the default page size and at 1,000
   rows; the mixed closed loop (2 s: two readers at ``limit=256``, one
   client ingesting 200-row batches; read q/s and acked rows/s); bursts
   of 16 concurrent readers (fused into K2); fairness (2 s each, its 6 cut: the
   compliant tenant's read p99 alone, then under an adversary of quota 1
   flooding from 3 threads; the degradation beside the reference's 1.5x
   bound, printed; the adversary's 429s accounted to it); every HTTP-acked
   row survives ``wal.crash()`` + ``LambdaStore.recover`` on the card,
   none lost, none invented. On the recovered store (cache tier on,
   auths ``ops``): four PNG tiles equal ``TilePyramid.fresh`` rendered, an
   ``If-None-Match`` replay answers 304 with no aggregation, an ingest
   into one leaf re-renders that leaf and its ancestors and leaves far
   tiles at 304; ``/metrics``, ``/health``, ``/stats`` and ``/tenants`` on
   the data port; 400, 403, 404, 413 and 429 each from one request; then
   the CLI's ``serve`` over the saved catalog on the card and one query
   through it; ``close()`` leaves no serve, serving or ops thread;
23. gdelt-s2-10M: 10,000,000 GDELT-shaped points on a schema with
   ``geomesa.indices.enabled=s3,s2`` (cell ids for both indexes at
   ingest, bit 63 set on faces 4 and 5); 64 BBOX + DURING queries planned
   on s3 and 32 BBOX queries planned on s2 (the explain names each), ids
   against an f64 brute force on 8 of each with their ``limit`` pages as
   prefixes of the full order, density and bounds against the plain
   versions on 4 of each; ingest seconds and p50 / p84 / p99;
24. gdelt-z2-1M-drift: the reference's ``config_drift`` at its defaults
   (1,000,000 points on z2, 12 queries, 6 passes): frozen, oracle and
   self-tuned stores with the frozen pin calibrated on this card; the
   frozen degradation, tuned over oracle and the decisions recorded,
   printed beside the reference's bounds (>= 1.30, <= 1.5, >= 1); the
   disarmed bit-identity on two 50k stores; the card's pull RTT derives
   the link constants, installed on a fresh 8M-row store, where every
   K2 chunk takes the derived slot count and ``query_many`` ids equal the
   untuned store's; an armed tier behind ``serve()`` under a 1 us
   objective sheds the low-weight tenant first and then releases;
   ``close()`` writes ``_tuning.json``, which the CLI's ``tune`` (and
   ``ops``) read on the card;
25. gdelt-pod-10M: the multi-device tier after the reference's
   ``config_pod`` (its spec, its 12 probes of 4 x 3 degrees, 4 hosts and
   the flat mesh on the same devices), the scan rows raised from 150,000
   to 5,000,000 GDELT-shaped points (10M until the scripts path came,
   cut for the script's wall) and the ingest rows from 400,000 to
   2,000,000: a pod of 4 sim hosts x 2 shards of the card, the flat
   8-shard mesh over the same devices and a one-device store, each
   ``write`` + ``compact``; the probes, a fused ``query_many`` of them,
   density, bounds and ``Count()`` estimates on each, ids equal in order
   across the three and to an f64 brute force on 4, grids, bounds and
   counts equal; on the pod every probe launches K1 only on the hosts
   that own its candidate blocks (once per shard with candidates); 3 s
   closed loops of the probes on each store (q/s printed, not gated);
   host-local ingest of 2M rows partitioned by the crc32 owner of their
   ids, each host's ``BulkLoader`` leg timed alone, beside one load on
   the flat mesh, the hosts' union answering as the flat store; a
   ``PodStore`` with per-host WALs (sync always): 1,000 geofences, 200k
   rows in 20k batches, a flush, host 1 killed after the fifth batch and
   rejoined from its WAL; its rows equal a never-crashed pod's and the
   brute force's, the union of the hosts' alerts equals one
   LambdaStore's; the two-process gloo probe
   (``geomesa_tpu_torch/scripts/probe_multiprocess.py``) reads
   ``supported``.
26. scripts: the measurement drivers of ``geomesa_tpu_torch/scripts/``
   (the ports of the reference's ``scripts/``), each through its own
   ``run`` on the card at a small size, its exactness fields checked:
   ``validate_1b`` (4M rows, packed time, 12 exact queries, a 2M append
   and compaction), ``run_pod_scale --ci`` (2M rows, 4 sim hosts x 2
   shards of the card: exact probes, the fused leg taken and exact, the
   streamed compaction exact), ``probe_link`` (16M rows), ``probe_floor``,
   ``probe_async_pull``, ``probe_density_many`` (5M points), the three
   XZ2 probes (2M footprints) and ``profile_join`` (2M points, 64
   polygons); each driver's record on a line of its own with its
   kernels' launches; the phase must stay under ``SCRIPTS_BUDGET_S``.
27. examples: the five examples of ``geomesa_tpu_torch/examples/`` (the
   ports of the reference's ``examples/``, at their sizes: 200k, 100k,
   100k, 200k and 50k rows), each ``main(device="cuda")`` on the card
   (the mesh as 8 virtual shards of ``cuda:0``), then the same example
   with ``device="cpu"`` in this process: the returned ids in order,
   counts, SQL rows, grids, join pairs and every printed line equal; the
   CPU runs launch nothing; each example's wall (card and CPU) and
   kernel launches on a line of their own; the phase must stay under
   ``EXAMPLES_BUDGET_S``.

Launch counts (and the legs' counts) and the native helpers' call counts
are zeroed just before each path and read just after
it; each path must have launched the kernels and legs it names (main:
K1, K3, K4; batch: K2, K1p, K3; Z3 polygon: K1 and K2 each with PIP,
raster and both legs; hints: K1 and K2; packed time: all five; Z2 polygon: K1's raster leg, K2
with stacks; XZ2: all five with the extent leg; XZ3: K1 and K2 with the
extent leg; tiered, mutate, persist and secure-cached: all five;
attribute, served and stream: K1 and K2; standing: K2 with its
point-in-polygon leg; replica: K1; ingest: K1, K3, K4; analytics: K1
and K2; HTTP: K1 and K2; S2: K1, K3, K4; drift: K1 and K2; pod: all
five; scripts: K1, K2, K3; examples: K1, K2, K3) and
called the native helpers ``check_native`` names (the ranges where it
plans new filters, since the batch path's repeated plans take the
planner's scan-config memo; ``sort_bins_z`` where it ingests, the plane
decode where it decodes, point-in-polygon on the polygon paths); the
probe phase zeroes
and reads its own (each probe kernel, and each density variant,
launched).

Then the kernels line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no result; so does a machine without CUDA, and a
directory holding this script without the package.
"""

from __future__ import annotations

import json
import os
import contextlib
import importlib
import io
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np

# the package beside this script: its timer and comparison, shared with the
# probes (in a directory without it, the import fails and nothing runs)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from geomesa_tpu_torch.timing import event_ms, max_abs_err  # noqa: E402

N_MAIN = 100_000_000
N_PACKED = 10_000_000
N_WARMUP = 16
N_MEASURED = 64
N_PACKED_QUERIES = 16
N_POLY_WARMUP = 8
N_POLY_MEASURED = 48
# the points of the reference benchmark's configuration 4 (points x admin
# polygons), on a Z2 table
N_Z2 = 20_000_000
N_Z2_POLY_QUERIES = 32
# the reference benchmark's configuration 3 (XZ2 building footprints), cut
# from 200M for the host's numpy ingest and the run's time, then from the
# cell's 50M to 25M for the script's 800 s once the ingest path came (48.9
# s at 50M, 25.4 s of it the ingest; the record's ``reduced`` says so); and
# an XZ3 table of mixed extents with dates
N_XZ2 = 25_000_000
N_XZ2_MEASURED = 40
N_XZ3 = 10_000_000
N_XZ3_OTHER = 100_000
N_XZ3_MEASURED = 32
N_XZ_WARMUP = 8
K2_SLOTS = 2048  # the fused chunk's slots at 100M rows (storage.table.fused_slots)
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet); the
# kernels' int32 compares and bit operations are counted at this rate too
OPS_PER_S = 67e12
T0_MS = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
SPAN_MS = 120 * 86_400_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# -- GDELT-shaped data and queries (the reference benchmark's generators) --


def gdelt_points(n, rng):
    """World-wide events clustered around population centers: uniform
    background + gaussian clusters."""
    n_clustered = n // 2
    n_uniform = n - n_clustered
    cx = rng.uniform(-160, 160, 64)
    cy = rng.uniform(-55, 65, 64)
    which = rng.integers(0, 64, n_clustered)
    x = np.concatenate([
        rng.uniform(-180, 180, n_uniform),
        np.clip(cx[which] + rng.normal(0, 3.0, n_clustered), -180, 180),
    ])
    y = np.concatenate([
        rng.uniform(-90, 90, n_uniform),
        np.clip(cy[which] + rng.normal(0, 2.0, n_clustered), -90, 90),
    ])
    return x, y


def cluster_xy(torch, x, y, seed=SEED):
    """New x, y with half of the rows (chosen at random among the finite
    ones) moved into 64 gaussian clusters of sigma 0.5 degrees, centres
    drawn as gdelt_points draws them (lon -160..160, lat -55..65): hot
    pixels on a 256 x 256 density grid."""
    g = torch.Generator(device=x.device)
    g.manual_seed(seed + 1)
    cx = torch.rand(64, generator=g, device=x.device) * 320 - 160
    cy = torch.rand(64, generator=g, device=x.device) * 120 - 55
    which = torch.randint(0, 64, x.shape, generator=g, device=x.device)
    # table pad rows (x = +inf) stay pads
    moved = (torch.rand(x.shape, generator=g, device=x.device) < 0.5) & torch.isfinite(x)
    nx = cx[which] + torch.randn(x.shape, generator=g, device=x.device) * 0.5
    ny = cy[which] + torch.randn(x.shape, generator=g, device=x.device) * 0.5
    return (torch.where(moved, nx.clamp(-180, 180), x).contiguous(),
            torch.where(moved, ny.clamp(-90, 90), y).contiguous())


def box_queries(rng, n_queries):
    """Selectivity mix: city-scale through continent-scale boxes."""
    out = []
    for _ in range(n_queries):
        w = float(rng.choice([1.0, 2.0, 5.0, 10.0, 20.0, 40.0]))
        h = w / 2
        qx = rng.uniform(-175, 175 - w)
        qy = rng.uniform(-85, 85 - h)
        out.append((qx, qy, qx + w, qy + h))
    return out


def time_windows(rng, n_queries, t0, span_ms):
    out = []
    for _ in range(n_queries):
        dur_ms = int(rng.choice([6, 24, 72, 168, 24 * 14]) * 3600_000)
        start = int(t0 + rng.integers(0, span_ms - dur_ms))
        out.append((start, start + dur_ms))
    return out


def query_set(seed, n, t0=T0_MS, span_ms=SPAN_MS):
    """[(ecql, (x0, y0, x1, y1, lo_ms, hi_ms))] for n BBOX + DURING queries
    with windows inside [t0, t0 + span_ms)."""
    r = np.random.default_rng(seed)
    boxes = box_queries(r, n)
    wins = time_windows(r, n, t0, span_ms)
    out = []
    for (x0, y0, x1, y1), (lo, hi) in zip(boxes, wins):
        q = (
            f"bbox(geom, {x0:.4f}, {y0:.4f}, {x1:.4f}, {y1:.4f}) AND dtg DURING "
            f"{np.datetime64(lo, 'ms')}Z/{np.datetime64(hi, 'ms')}Z"
        )
        # the filter as parsed: the printed 4-decimal box is the query
        box = tuple(float(f"{v:.4f}") for v in (x0, y0, x1, y1))
        out.append((q, (*box, lo, hi)))
    return out


# -- timing ----------------------------------------------------------------


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    over the memory rate and the operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def leg_ops(boxes, wins, has_boxes, has_windows, planes) -> int:
    """Operations per row of the predicate legs over the query's active
    slots: per slot and plane 4 compares, 3 ANDs and an OR."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    n_box, n_win = bk.slot_words(boxes, wins)[2].tolist()
    return (n_box * has_boxes + n_win * has_windows) * 8 * planes + planes


# operations of the polygon legs (csrc/masks.cuh): per row and edge the ray
# cast's 2 compares and a XOR for the crossing window, a subtract, multiply
# and add for the crossing abscissa, a compare, AND and XOR for the
# parity, and 3 subtracts, 3 absolutes, 3 compares, an AND and 3 ORs for
# the near band; per row the raster cell (2 subtracts, 2 multiplies, 2
# floors, 4 compares, 3 ANDs, a multiply and an add); per row in the grid
# and interval 2 compares and an AND for the hit, and a compare, an AND
# and an OR for each of full and partial
PIP_OPS_PER_EDGE = 22
RASTER_CELL_OPS = 15
RASTER_OPS_PER_INTERVAL = 9


def polygon_ops(torch, x, y, edges, rast) -> int:
    """Operations the polygon legs do on rows ``x``, ``y`` (tensors on the
    card) with one query's ``edges`` [E, 128] and ``rast`` [1 + R, 128]
    blocks (numpy, either None), counted from this data: the intervals
    loop only for rows inside the grid, and with both legs the ray cast
    only for rows in partial cells, as the kernels do; edges and intervals
    are the real ones, before the pad rows."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    rows = x.numel()
    pip_rows = rows
    ops = 0
    if rast is not None:
        n_r = int(bk.active_rints_many(rast[None])[0])
        x0, y0, icx, icy, nx, ny = (float(v) for v in rast[0, :6])
        cx = torch.floor((x - x0) * icx)
        cy = torch.floor((y - y0) * icy)
        in_grid = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
        ops += rows * RASTER_CELL_OPS + int(in_grid.sum()) * n_r * RASTER_OPS_PER_INTERVAL
        del cx, cy, in_grid
        if edges is not None:
            _, part = bk._raster_plain(x, y, torch.as_tensor(rast, device=x.device))
            pip_rows = int(part.sum())
    if edges is not None:
        ops += pip_rows * int(bk.active_edges_many(edges[None])[0]) * PIP_OPS_PER_EDGE
    return ops


def star(cx, cy, r, arms, rng, hole=False):
    """A star polygon of 2 * arms edges, as the reference benchmark's
    geofences (outer radius r, inner radii 0.3-0.7 r), optionally with a
    reversed hole ring of radius 0.15 r, inside every inner vertex."""
    from geomesa_tpu_torch import geometry as geo

    a = np.linspace(0, 2 * np.pi, 2 * arms + 1)[:-1]
    rad = np.where(np.arange(2 * arms) % 2 == 0, r, r * rng.uniform(0.3, 0.7, 2 * arms))
    shell = np.stack([cx + rad * np.cos(a), cy + rad * np.sin(a)], axis=1)
    holes = []
    if hole:
        h = 0.15 * r
        holes.append(np.stack([cx + h * np.cos(a[::-1]), cy + h * np.sin(a[::-1])], axis=1))
    return geo.Polygon(shell, holes)


# -- phase 2: kernels against their plain versions --------------------------


def synthetic_columns(torch, n_blocks, sub, device):
    """[n_blocks, sub, 128] columns made on the card from a seed; the last
    block's tail carries the table's pad sentinels."""
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    shape = (n_blocks, sub, 128)
    x = torch.rand(shape, generator=g, device=device) * 360 - 180
    y = torch.rand(shape, generator=g, device=device) * 180 - 90
    tb = torch.randint(2800, 2820, shape, generator=g, device=device, dtype=torch.int32)
    to = torch.randint(0, 604_800, shape, generator=g, device=device, dtype=torch.int32)
    tw = (tb << 16) | (to >> 5)
    tail = (slice(-1, None), slice(sub // 2, None))
    x[tail] = float("inf")
    y[tail] = float("inf")
    tb[tail] = -1
    to[tail] = 0
    tw[tail] = -1
    return {"x": x.contiguous(), "y": y.contiguous(), "tbin": tb, "toff": to, "tw": tw}


def scan_params():
    """The kernel phase's one-query params: two wide box slots and one
    inner, two wide window slots and one inner, in seconds and in the
    packed 32 s ticks (boxes, wins, wins_tw: [8, 128] blocks)."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    boxes = bk.pack_boxes(
        np.array([[-60, -30, 40, 50], [100, -80, 170, -10]], np.float32),
        np.array([[-59, -29, 39, 49]], np.float32),
    )
    wins = bk.pack_windows(
        np.array([[2801, 2805, 0, 604_799], [2810, 2810, 1000, 90_000]]),
        np.array([[2801, 2805, 1, 604_798]]),
    )
    wins_tw = bk.pack_windows(
        np.array([[2801, 2805, 0, 18_899], [2810, 2810, 31, 2812]]),
        np.array([[2801, 2805, 1, 18_898]]),
    )
    return boxes, wins, wins_tw


def k1_scan_ops(boxes, wins, rows: int) -> int:
    """Operations of K1's box + window scan over ``rows``: per row both
    planes' legs, then a shift and an OR per plane to pack."""
    return rows * (leg_ops(boxes, wins, True, True, planes=2) + 4)


def k1_scan_bytes(bids, n_cols: int, sub: int) -> int:
    """Bytes of K1 over the slots ``bids``: each column read once, both
    planes written, the block ids."""
    rows = len(bids) * sub * 128
    return rows * 4 * n_cols + 2 * rows // 8 + bids.nbytes


def kernel_phase(torch, device):
    from geomesa_tpu_torch.scan import aggregations as agg
    from geomesa_tpu_torch.scan import block_kernels as bk

    sub = 128
    n_blocks = -(-N_MAIN // (sub * 128))  # the main table's block count
    cols = synthetic_columns(torch, n_blocks, sub, device)
    boxes, wins, wins_tw = scan_params()
    predicates = [
        ("box+window", ("tbin", "toff", "x", "y"), True, True, wins),
        ("box+window:tw", ("tw", "x", "y"), True, True, wins_tw),
        ("box", ("x", "y"), True, False, wins),
        ("window", ("tbin", "toff"), False, True, wins),
        ("none", ("x",), False, False, wins),
    ]
    rng = np.random.default_rng(SEED)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    out = {}
    err = {"block_scan": 0.0, "density": 0.0, "bounds": 0.0}
    # K1: every predicate at every M of the ladder the main path uses, and
    # at the whole table (past the largest bucket the table scans every
    # block, padded to the next power of two)
    scan_checks = 0
    for m in (32, 256, 4096, n_blocks):
        blocks = np.sort(rng.choice(n_blocks, size=m, replace=False))
        bids, _ = bk.pad_bids(blocks, n_blocks)
        for name, names, hb, hw, w in predicates:
            c3 = tuple(cols[k] for k in names)
            kw = dict(col_names=names, has_boxes=hb, has_windows=hw)
            kw_, ki = bk.block_scan(c3, bids, boxes, w, **kw)
            pw, pi = bk.block_scan_plain(
                dict(zip(names, c3)), dev(bids, torch.int32), dev(boxes, torch.float32),
                dev(w, torch.int32), has_boxes=hb, has_windows=hw,
            )
            err["block_scan"] = max(err["block_scan"], max_abs_err(kw_, pw), max_abs_err(ki, pi))
            check(torch.equal(kw_, pw) and torch.equal(ki, pi), f"block_scan {name} M={len(bids)}")
            check(bool(kw_.any()), f"block_scan {name} M={len(bids)} selects rows")
            scan_checks += 1
    # timing at the largest bucket, all slots real, box + window on
    # (tbin, toff): the launch alone (params staged once), then the wrapper
    names = ("tbin", "toff", "x", "y")
    c3 = tuple(cols[k] for k in names)
    tcols = dict(zip(names, c3))
    t_m = bk.M_BUCKETS[-1]
    bids, _ = bk.pad_bids(np.arange(t_m), n_blocks)
    kw = dict(col_names=names, has_boxes=True, has_windows=True)
    flags = dict(has_boxes=True, has_windows=True)
    pargs = (tcols, dev(bids, torch.int32), dev(boxes, torch.float32), dev(wins, torch.int32))
    rows = t_m * sub * 128
    _, launch = bk.scan_launcher(tcols, bids, boxes, wins, **flags)
    out["block_scan"] = {
        "ms": event_ms(launch),
        "wrapper_ms": event_ms(lambda: bk.block_scan(c3, bids, boxes, wins, **kw)),
        "plain_ms": event_ms(lambda: bk.block_scan_plain(*pargs, **flags)),
        **bound(k1_scan_bytes(bids, len(names), sub), k1_scan_ops(boxes, wins, rows)),
        "library_ms": None,
        "checks": scan_checks,
        "shape": f"M={t_m} SUB={sub} cols={','.join(names)}",
    }
    # the main path's small buckets, the same predicate on M real slots
    # spread over the table
    small = {}
    for m in (32, 256):
        sb = np.sort(rng.choice(n_blocks, size=m, replace=False)).astype(np.int32)
        _, s_launch = bk.scan_launcher(tcols, sb, boxes, wins, **flags)
        small[f"M={m}"] = {
            "ms": event_ms(s_launch),
            **bound(k1_scan_bytes(sb, len(names), sub), k1_scan_ops(boxes, wins, m * sub * 128)),
        }
    out["block_scan"]["small_m"] = small

    # K3 / K4: grids and stats with -1 pads, both time layouts, over 3000
    # blocks (padded to 4096) and over the whole table (padded to 8192)
    agg_checks = 0
    gb = np.array([-100, -60, 120, 70], np.float32)
    for n_real in (3000, n_blocks):
        blocks = np.sort(rng.choice(n_blocks, size=n_real, replace=False))
        pbids, _ = bk.pad_bids(blocks, n_blocks, pad=-1)
        for name, names_, hb, hw, w in predicates[:2]:
            c3_ = tuple(cols[k] for k in names_)
            kw_ = dict(col_names=names_, has_boxes=hb, has_windows=hw)
            pl = (dict(zip(names_, c3_)), dev(pbids, torch.int32), dev(boxes, torch.float32),
                  dev(w, torch.int32))
            m = len(pbids)
            for width, height in ((256, 256), (33, 17)):
                got = agg.block_density(c3_, pbids, boxes, w, gb, width=width, height=height, **kw_)
                ref = agg.density_plain(*pl, dev(gb, torch.float32), has_boxes=hb,
                                        has_windows=hw, width=width, height=height)
                err["density"] = max(err["density"], max_abs_err(got, ref))
                check(torch.equal(got, ref) and float(got.sum()) > 0,
                      f"density {name} M={m} {width}x{height}")
                agg_checks += 1
            st = agg.block_bounds(c3_, pbids, boxes, w, **kw_)
            sp = agg.bounds_plain(*pl, has_boxes=hb, has_windows=hw)
            err["bounds"] = max(err["bounds"], max_abs_err(st[:n_real], sp[:n_real]))
            check(np.array_equal(st[:n_real].cpu().numpy(), sp[:n_real].cpu().numpy()),
                  f"bounds {name} M={m}")
            agg_checks += 1

    # timing at the largest bucket, all slots real
    col_bytes = rows * 4 * len(names)
    # the library yardstick: one bincount over this query's hit pixels,
    # computed beforehand; it reads no column, so it is not K3's function
    g = {k: v[pargs[1].to(torch.int64)] for k, v in tcols.items()}
    wm, _ = bk.masks_plain(g, pargs[2], pargs[3], True, True)
    wide_hits = int(wm.sum())
    xs, ys = g["x"][wm], g["y"][wm]
    x0, y0, x1, y1 = (float(v) for v in gb)
    inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    xs, ys = xs[inside], ys[inside]
    px = ((xs - x0) / (x1 - x0) * 256).to(torch.int32).clamp(0, 255)
    py = ((ys - y0) / (y1 - y0) * 256).to(torch.int32).clamp(0, 255)
    flat = py.to(torch.int64) * 256 + px.to(torch.int64)
    del g, wm
    wide_ops = rows * leg_ops(boxes, wins, True, True, planes=1)
    # per row the closed envelope (4 compares, 4 ANDs); per hit in it two
    # pixels (subtract, divide, multiply, truncate, 2 clips) and the
    # flat index (multiply, add) before one increment
    density_ops = wide_ops + rows * 8 + flat.numel() * 15
    # per wide hit a count and four min/max
    bounds_ops = wide_ops + wide_hits * 5
    _, d_launch = agg.density_launcher(tcols, bids, boxes, wins, gb, width=256, height=256,
                                       **flags)
    out["density"] = {
        "ms": event_ms(d_launch),
        "wrapper_ms": event_ms(lambda: agg.block_density(
            c3, bids, boxes, wins, gb, width=256, height=256, **kw)),
        "plain_ms": event_ms(lambda: agg.density_plain(
            *pargs, dev(gb, torch.float32), width=256, height=256, **flags)),
        **bound(col_bytes + 256 * 256 * 4 + bids.nbytes, density_ops),
        "library_ms": event_ms(lambda: torch.bincount(flat, minlength=256 * 256)),
        "library_covers": "torch.bincount over the hits' precomputed pixels; reads no column",
        "checks": agg_checks,
        "hits": int(flat.numel()),
        "shape": f"M={t_m} SUB={sub} grid=256x256 cols={','.join(names)}",
    }
    out["density"]["clustered"], c_err = clustered_density(
        torch, cols, n_blocks, bids, boxes, wins, gb, names, rng, dev, col_bytes, wide_ops)
    err["density"] = max(err["density"], c_err)
    _, b_launch = agg.bounds_launcher(tcols, bids, boxes, wins, **flags)
    out["bounds"] = {
        "ms": event_ms(b_launch),
        "wrapper_ms": event_ms(lambda: agg.block_bounds(c3, bids, boxes, wins, **kw)),
        "plain_ms": event_ms(lambda: agg.bounds_plain(*pargs, **flags)),
        **bound(col_bytes + t_m * 8 * 4 + bids.nbytes, bounds_ops),
        "library_ms": None,
        "checks": agg_checks,
        "shape": f"M={t_m} SUB={sub} cols={','.join(names)}",
    }
    for name, e in err.items():
        out[name]["max_abs_err"] = e
    del c3, tcols, pargs, flat
    out.update(fused_and_pops_kernels(torch, cols, n_blocks, sub, predicates, boxes, wins, dev))
    k1, k2, err1, err2, n_poly = polygon_kernels(torch, cols, n_blocks, sub, boxes, wins, dev)
    out["block_scan"]["legs"] = k1
    out["block_scan_multi"]["legs"] = k2
    out["block_scan"]["max_abs_err"] = max(out["block_scan"]["max_abs_err"], err1)
    out["block_scan_multi"]["max_abs_err"] = max(out["block_scan_multi"]["max_abs_err"], err2)
    out["polygon_leg_checks"] = n_poly
    mk, m_err, n_match = matcher_kernels(torch, device, dev)
    out["block_scan_multi"]["legs"].update(mk)
    out["block_scan_multi"]["max_abs_err"] = max(out["block_scan_multi"]["max_abs_err"], m_err)
    out["matcher_checks"] = n_match
    del cols
    torch.cuda.empty_cache()
    for name, leg in extent_kernels(torch, device, n_blocks, sub, boxes, wins, dev).items():
        out[name].setdefault("legs", {})["extent"] = leg
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], leg["max_abs_err"])
    return out


def clustered_density(torch, cols, n_blocks, bids, boxes, wins, gb, names, rng, dev,
                      col_bytes, wide_ops):
    """K3 on the main shape's columns with half of the rows moved into 64
    gaussian clusters of sigma 0.5 degrees (hot pixels): on a 256 x 256 and
    a 33 x 17 grid against the plain version with -1 pads, over 3000
    blocks and the whole table, then the kernel and the wrapper timed at
    the main shape. Returns (record, max abs err)."""
    from geomesa_tpu_torch.scan import aggregations as agg
    from geomesa_tpu_torch.scan import block_kernels as bk

    sub = cols["x"].shape[1]
    ccols = {k: cols[k] for k in names}
    ccols["x"], ccols["y"] = cluster_xy(torch, cols["x"], cols["y"])
    c3 = tuple(ccols[k] for k in names)
    kw = dict(col_names=names, has_boxes=True, has_windows=True)
    flags = dict(has_boxes=True, has_windows=True)
    err, checks = 0.0, 0
    for n_real in (3000, n_blocks):
        blocks = np.sort(rng.choice(n_blocks, size=n_real, replace=False))
        pbids, _ = bk.pad_bids(blocks, n_blocks, pad=-1)
        pl = (ccols, dev(pbids, torch.int32), dev(boxes, torch.float32), dev(wins, torch.int32))
        for width, height in ((256, 256), (33, 17)):
            got = agg.block_density(c3, pbids, boxes, wins, gb, width=width, height=height, **kw)
            ref = agg.density_plain(*pl, dev(gb, torch.float32), width=width, height=height,
                                    **flags)
            err = max(err, max_abs_err(got, ref))
            check(torch.equal(got, ref) and float(got.sum()) > 0,
                  f"density clustered M={len(pbids)} {width}x{height}")
            checks += 1
    pargs = (ccols, dev(bids, torch.int32), dev(boxes, torch.float32), dev(wins, torch.int32))
    ref = agg.density_plain(*pargs, dev(gb, torch.float32), width=256, height=256, **flags)
    hits = int(ref.sum())
    _, launch = agg.density_launcher(ccols, bids, boxes, wins, gb, width=256, height=256, **flags)
    rec = {
        "ms": event_ms(launch),
        "wrapper_ms": event_ms(lambda: agg.block_density(
            c3, bids, boxes, wins, gb, width=256, height=256, **kw)),
        # as the uniform shape: per row the legs and the envelope, per hit
        # the pixel and one increment
        **bound(col_bytes + 256 * 256 * 4 + bids.nbytes,
                wide_ops + len(bids) * sub * 128 * 8 + hits * 15),
        "hits": hits, "max_pixel_hits": int(ref.max()), "checks": checks,
        "max_abs_err": err,
        "shape": f"M={len(bids)} SUB={sub} grid=256x256 cols={','.join(names)}, "
                 "half the rows in 64 clusters of sigma 0.5 deg",
    }
    del ccols, c3, ref
    torch.cuda.empty_cache()
    return rec, err


# -- phase 3: the chip-side probes ------------------------------------------

# the probes' kernels in the kernels line: (entry name, kernel, density
# variant or None, replaced TPU kernel)
PROBE_ENTRIES = (
    ("probe_scan", "probe_scan", None,
     "scripts/probe_pallas.py:67 (block_scan, body scan_kernel :25; pallas_call :84)"),
    ("probe_bounds", "probe_bounds", None,
     "scripts/probe_agg.py:128 (make_pallas(_bounds_kernel), body :109; pallas_call :144)"),
    ("probe_density:reshape", "probe_density", "reshape",
     "scripts/probe_agg.py:128 (make_pallas(_density_kernel_reshape), body :58; "
     "pallas_call :144)"),
    ("probe_density:fori", "probe_density", "fori",
     "scripts/probe_agg.py:128 (make_pallas(_density_kernel_fori), body :85; "
     "pallas_call :144)"),
)


def probe_phase(torch, device):
    """P1 and P2 through their own ``run`` at the JAX probes' sizes, the
    launch counts zeroed just before and read just after. Checks: P1's
    rows at M = 128 equal numpy's, every probe kernel equals its plain
    version at both M (pad slots, the 8-slot split and the staging edge
    cases included), K1's planes equal P1's and K3's grid P2's density,
    the split gives P1's planes and P2's stats and grid, and each probe
    kernel and density leg launched. Returns (record, kernel entries for
    the kernels line)."""
    from geomesa_tpu_torch.kernels import KERNELS, PROBE_DENSITY, PROBE_KERNELS
    from geomesa_tpu_torch.scripts import probe_agg, probe_pallas

    for k in (*KERNELS, *PROBE_KERNELS):
        k.reset_counts()
    t0 = time.perf_counter()
    p1 = probe_pallas.run(device)
    p2 = probe_agg.run(device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in (*KERNELS, *PROBE_KERNELS)}
    legs = dict(PROBE_DENSITY.leg_launches)
    torch.cuda.empty_cache()

    check(p1["check"]["ok"] and p1["check"]["rows"] > 0, "P1 rows at M=128 equal numpy's")
    for r in p1["records"]:
        check(r["max_abs_err"] == 0.0, f"probe_scan equals plain at M={r['M']}")
        check(r["k1_equal"], f"K1 planes equal P1's at M={r['M']}")
        check(r["split_equal"], f"P1 and K1 on the 8-slot split equal P1's planes at M={r['M']}")
        for case, e in r["staging_err"].items():
            check(e == 0.0, f"probe_scan equals plain on staging case {case} at M={r['M']}")
    for r in p2["records"]:
        for name, e in r["max_abs_err"].items():
            check(e == 0.0, f"probe {name} equals plain at M={r['M']}")
        for case, errs in r["staging_err"].items():
            check(not any(errs.values()), f"P2 equals plain on staging case {case} at M={r['M']}")
        check(r["split_equal"], f"P2 on the 8-slot split equals P2 on its box at M={r['M']}")
        check(r["k3_equal"], f"K3 grid equals P2's density at M={r['M']}")
    for k in PROBE_KERNELS:
        check(launches[k.name] > 0, f"probe kernel {k.name} launched")
    for leg, n in legs.items():
        check(n > 0, f"probe_density leg {leg} launched")

    entries = []
    for name, kname, variant, replaces in PROBE_ENTRIES:
        by_m = {}
        if kname == "probe_scan":
            for r in p1["records"]:
                by_m[r["M"]] = {
                    "ms": r["kernel_ms"], "wrapper_ms": r["wrapper_ms"], "plain_ms": r["plain_ms"],
                    **bound(r["bytes"], r["ops"]), "library_ms": None,
                    "max_abs_err": r["max_abs_err"], "gb_per_s": r["gb_per_s"],
                    "query_ms": r["query_ms"], "k1_ms": r["k1_ms"],
                    "k1_wrapper_ms": r["k1_wrapper_ms"], "split_ms": r["split_kernel_ms"],
                    "split_k1_ms": r["split_k1_ms"], "rows": r["rows"],
                    "shape": f"M={r['M']} SUB=128 cols=x,y,tbin,toff slots=8+8",
                }
        else:
            for r in p2["records"]:
                if variant is None:
                    a = v = r["bounds"]
                    plain, lib = r["plain_bounds_ms"], None
                    err, extra = r["max_abs_err"]["bounds"], {}
                else:
                    a = r["density"]
                    v = a[variant]
                    plain, lib = r["plain_density_ms"], r["bincount_ms"]
                    err = r["max_abs_err"][variant]
                    extra = {"k3_ms": r["k3_ms"], "k3_wrapper_ms": r["k3_wrapper_ms"]}
                by_m[r["M"]] = {
                    "ms": v["kernel_ms"], "wrapper_ms": v["wrapper_ms"], "plain_ms": plain,
                    **bound(a["bytes"], a["ops"]), "library_ms": lib, "max_abs_err": err,
                    "hits": a["hits"], "split_ms": v["split_ms"], "k1_ms": r["k1_ms"], **extra,
                    "shape": f"M={r['M']} SUB=128 cols=x,y boxes=8"
                             + (" grid=256x256" if variant else ""),
                }
        top = by_m[max(by_m)]  # the largest M heads the entry
        entries.append({
            "name": name, "route": "cuda", "source": f"geomesa_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces,
            "launches": legs[variant] if variant else launches[kname],
            "launches_by_path": {"probes": legs[variant] if variant else launches[kname]},
            "equal_to_plain": all(b["max_abs_err"] == 0.0 for b in by_m.values()),
            "max_abs_err": max(b["max_abs_err"] for b in by_m.values()),
            "ms": top["ms"], "kernel_ms": top["ms"], "wrapper_ms": top["wrapper_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "split_ms": top["split_ms"], "shape": top["shape"], "by_m": by_m,
        })
    rec = {"phase": "probes", "wall_s": wall, "launches": launches,
           "probe_density_legs": legs, "probe_pallas": p1, "probe_agg": p2}
    return rec, entries


def query_stacks(n_q: int, seed: int):
    """[128, 8, 128] box stack and window stacks (seconds, and 32 s ticks
    for tw) of n_q queries; query q uses 1 + q % 8 box slots and
    1 + (3q + 1) % 8 window slots, so the queries of one chunk differ in
    both counts. Rows past n_q stay zero, as in the table's stacks."""
    from geomesa_tpu_torch.scan import block_kernels as bk
    from geomesa_tpu_torch.storage.table import FUSED_CHUNK_Q

    r = np.random.default_rng(seed)
    boxes = np.zeros((FUSED_CHUNK_Q, 8, 128), np.float32)
    wins = np.zeros((FUSED_CHUNK_Q, 8, 128), np.int32)
    wins_tw = np.zeros_like(wins)
    for q in range(n_q):
        nb, nw = 1 + q % 8, 1 + (3 * q + 1) % 8
        lo = r.uniform(-175, 120, (nb, 2)).astype(np.float32)
        wide = np.concatenate([lo, lo + r.uniform(5, 60, (nb, 2)).astype(np.float32)], axis=1)
        boxes[q] = bk.pack_boxes(wide, wide[:1] + np.array([1, 1, -1, -1], np.float32))
        b = r.integers(2800, 2820, nw)
        b1 = b + r.integers(0, 3, nw)
        for stack, top in ((wins, 604_799), (wins_tw, 18_899)):
            o = np.sort(r.integers(0, top, (nw, 2)), axis=1)
            ws = np.stack([b, b1, o[:, 0], o[:, 1]], axis=1)
            stack[q] = bk.pack_windows(ws, ws[:1] + np.array([0, 0, 1, -1]))
    return boxes, wins, wins_tw


def fused_and_pops_kernels(torch, cols, n_blocks, sub, predicates, boxes1, wins1, dev):
    """K2 and K1p against their plain versions on the synthetic columns,
    then their times. K2 at M = 32 and M = 2048 (the fused chunk at 100M
    rows) with 48 queries of differing slot counts in a [128, 8, 128]
    stack, qids interleaved, pads bid 0 / qid 0; K1p at M = 32, 4096 and
    the whole table padded to its bucket, -1 pads (clamped to block 0)."""
    from geomesa_tpu_torch.scan import aggregations as agg
    from geomesa_tpu_torch.scan import block_kernels as bk

    n_q = 48
    boxes, wins, wins_tw = query_stacks(n_q, SEED + 7)
    rng = np.random.default_rng(SEED + 8)
    out = {}
    err = {"block_scan_multi": 0.0, "block_pops": 0.0}
    multi_checks = 0
    for m in (32, 2048):
        n_real = m - max(4, m // 40)
        blocks = rng.integers(0, n_blocks, n_real)
        bids, _ = bk.pad_bids(blocks, n_blocks, bucket=m)
        qids = np.zeros(m, np.int32)
        qids[:n_real] = rng.permutation(np.arange(n_real) % n_q)
        for name, names, hb, hw, _ in predicates:
            w = wins_tw if "tw" in names else wins
            c3 = tuple(cols[k] for k in names)
            got_w, got_i = bk.block_scan_multi(c3, bids, qids, boxes, w, col_names=names,
                                               has_boxes=hb, has_windows=hw)
            pw, pi = bk.block_scan_multi_plain(
                dict(zip(names, c3)), dev(bids, torch.int32), dev(qids, torch.int32),
                dev(boxes, torch.float32), dev(w, torch.int32), has_boxes=hb, has_windows=hw,
            )
            err["block_scan_multi"] = max(err["block_scan_multi"], max_abs_err(got_w, pw),
                                          max_abs_err(got_i, pi))
            check(torch.equal(got_w, pw) and torch.equal(got_i, pi),
                  f"block_scan_multi {name} M={m}")
            check(bool(got_w.any()), f"block_scan_multi {name} M={m} selects rows")
            multi_checks += 1
    pops_checks = 0
    for m_real in (32, 4096, n_blocks):
        blocks = np.sort(rng.choice(n_blocks, size=m_real - 3, replace=False))
        bids, _ = bk.pad_bids(blocks, n_blocks, pad=-1)
        for name, names, hb, hw, w in predicates:
            c3 = tuple(cols[k] for k in names)
            got = agg.block_pops(c3, bids, boxes1, w, col_names=names, has_boxes=hb,
                                 has_windows=hw)
            ref = agg.block_pops_plain(
                dict(zip(names, c3)), dev(bids, torch.int32), dev(boxes1, torch.float32),
                dev(w, torch.int32), has_boxes=hb, has_windows=hw,
            )
            err["block_pops"] = max(err["block_pops"], max_abs_err(got, ref))
            check(torch.equal(got, ref) and int(got.sum()) > 0,
                  f"block_pops {name} M={len(bids)}")
            pops_checks += 1

    # timing: K2 at the fused chunk's M = 2048, every slot real; K1p at
    # M = 4096 as K1. Box + window on (tbin, toff, x, y).
    names = ("tbin", "toff", "x", "y")
    c3 = tuple(cols[k] for k in names)
    tcols = dict(zip(names, c3))
    flags = dict(has_boxes=True, has_windows=True)
    kw = dict(col_names=names, **flags)
    m = 2048
    bids = np.sort(rng.choice(n_blocks, size=m, replace=False)).astype(np.int32)
    qids = rng.permutation(np.arange(m) % n_q).astype(np.int32)
    rows = m * sub * 128
    per_query = np.array([leg_ops(boxes[q], wins[q], True, True, planes=2) + 4
                          for q in range(len(boxes))])
    multi_ops = sub * 128 * int(per_query[qids].sum())
    staged = bk.stage_multi_params(bids, qids, boxes, wins)
    _, launch = bk.multi_launcher(tcols, bids, qids, boxes, wins, **flags)
    pargs = (tcols, dev(bids, torch.int32), dev(qids, torch.int32), dev(boxes, torch.float32),
             dev(wins, torch.int32))
    out["block_scan_multi"] = {
        "ms": event_ms(launch),
        "wrapper_ms": event_ms(lambda: bk.block_scan_multi(c3, bids, qids, boxes, wins,
                                                                 **kw)),
        "plain_ms": event_ms(lambda: bk.block_scan_multi_plain(*pargs, **flags)),
        **bound(rows * 4 * len(names) + 2 * rows // 8 + staged.nbytes, multi_ops),
        "library_ms": None,
        "checks": multi_checks,
        "shape": f"M={m} Q=128 ({n_q} real) SUB={sub} cols={','.join(names)}",
    }
    del pargs
    m = bk.M_BUCKETS[-1]
    bids, _ = bk.pad_bids(np.arange(m), n_blocks)
    rows = m * sub * 128
    # per row the wide plane's legs, then a shift and an OR to build the
    # word; per word a popcount and an add
    pops_ops = rows * (leg_ops(boxes1, wins1, True, True, planes=1) + 2) + rows // 16
    _, p_launch = agg.pops_launcher(tcols, bids, boxes1, wins1, **flags)
    pargs = (tcols, dev(bids, torch.int32), dev(boxes1, torch.float32), dev(wins1, torch.int32))
    out["block_pops"] = {
        "ms": event_ms(p_launch),
        "wrapper_ms": event_ms(lambda: agg.block_pops(c3, bids, boxes1, wins1, **kw)),
        "plain_ms": event_ms(lambda: agg.block_pops_plain(*pargs, **flags)),
        **bound(rows * 4 * len(names) + m * 4 + bids.nbytes, pops_ops),
        "library_ms": None,
        "checks": pops_checks,
        "shape": f"M={m} SUB={sub} cols={','.join(names)}",
    }
    for name, e in err.items():
        out[name]["max_abs_err"] = e
    return out


def k1_polygon_cases(rng):
    """K1's timed polygon legs, (name, edges, rast): PIP alone at E 16, 64
    and 256 (stars of 12, 56 with a hole, and 200 edges), the raster alone
    at R 16, 64 and 256, both legs at R 16 + E 64."""
    from geomesa_tpu_torch.filter import raster as fr
    from geomesa_tpu_torch.scan import block_kernels as bk

    polys = {
        16: star(-20, 10, 75, 6, rng),
        64: star(30, -5, 70, 14, rng, hole=True),
        256: star(0, 0, 80, 100, rng),
    }
    cases = [(f"pip:E{e}", bk.pack_edges(p), None) for e, p in polys.items()]
    cases += [(f"raster:R{r}", None, fr.build_raster(polys[256]).pack_block(r))
              for r in (16, 64, 256)]
    cases.append(("pip+raster:R16+E64", bk.pack_edges(polys[64]),
                  fr.build_raster(polys[64]).pack_block(16)))
    return cases


def k2_polygon_stacks(rng, n_q: int):
    """K2's [128, 64, 128] edge and [128, 17, 128] raster stacks of n_q
    star geofences of differing edge and interval counts (E bucket 64 with
    or without a hole, R bucket 16); rows past n_q stay zero."""
    from geomesa_tpu_torch.filter import raster as fr
    from geomesa_tpu_torch.scan import block_kernels as bk
    from geomesa_tpu_torch.storage.table import FUSED_CHUNK_Q

    edges = np.zeros((FUSED_CHUNK_Q, 64, 128), np.float32)
    rasts = np.zeros((FUSED_CHUNK_Q, 17, 128), np.float32)
    for q in range(n_q):
        hole = q % 4 == 0
        arms = int(rng.integers(3, 17 if hole else 33))  # E bucket 64 with or without a hole
        p = star(rng.uniform(-150, 150), rng.uniform(-60, 60), rng.uniform(10, 40), arms, rng,
                 hole=hole)
        e = bk.pack_edges(p)
        edges[q, : len(e)] = e
        r = fr.build_raster(p).pack_block(16)
        rasts[q, : len(r)] = r
    return edges, rasts


def polygon_kernels(torch, cols, n_blocks, sub, boxes, wins, dev):
    """K1's point-in-polygon and raster legs and K2's per-query stacks
    against their plain versions on the synthetic columns, each case with
    the window on (tbin, toff) and without it, then timed with the window:
    K1 at M = 4096 with PIP alone at E 16, 64 and 256 (stars of 12, 56
    with a hole, and 200 edges), the raster alone at R 16, 64 and 256, and
    both legs at R 16 + E 64; K2 at M = 2048 with 48 polygon queries of
    differing edge and interval counts (E bucket 64, R bucket 16),
    interleaved, one chunk per leg combination, pads spip 0. The plain
    versions take seconds at E 256, so they are timed over 3 runs."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    rng = np.random.default_rng(SEED + 9)
    cases = k1_polygon_cases(rng)
    windowed = ("tbin", "toff", "x", "y")
    variants = [(windowed, True), (("x", "y"), False)]
    m = bk.M_BUCKETS[-1]
    bids, _ = bk.pad_bids(np.sort(rng.choice(n_blocks, size=m, replace=False)), n_blocks)
    tbids = dev(bids, torch.int32)
    rows = m * sub * 128
    n_win = int(bk.slot_words(wins, wins)[2][1])
    gx, gy = cols["x"][tbids.long()], cols["y"][tbids.long()]
    err, checks, k1 = 0.0, 0, {}
    for name, edges, rast in cases:
        kw = dict(edges=edges, n_edges=bk.n_edges_of(edges), rast=rast,
                  n_rints=bk.n_rints_of(rast))
        pkw = dict(edges=None if edges is None else dev(edges, torch.float32),
                   rast=None if rast is None else dev(rast, torch.float32))
        for names, hw in variants:
            c3 = tuple(cols[k] for k in names)
            got_w, got_i = bk.block_scan(c3, bids, boxes, wins, col_names=names,
                                         has_boxes=True, has_windows=hw, **kw)
            pw, pi = bk.block_scan_plain(
                dict(zip(names, c3)), tbids, dev(boxes, torch.float32), dev(wins, torch.int32),
                has_boxes=True, has_windows=hw, **pkw,
            )
            err = max(err, max_abs_err(got_w, pw), max_abs_err(got_i, pi))
            check(torch.equal(got_w, pw) and torch.equal(got_i, pi),
                  f"block_scan {name} windows={hw} M={m}")
            # certain rows too where the ray cast runs (a coarse raster
            # alone may certify none)
            check(bool(got_w.any()) and (edges is None or bool(got_i.any())),
                  f"block_scan {name} windows={hw} selects rows")
            checks += 1
            del got_w, got_i, pw, pi
        c3 = tuple(cols[k] for k in windowed)
        tcols = dict(zip(windowed, c3))
        _, launch = bk.scan_launcher(tcols, bids, boxes, wins, has_boxes=True,
                                     has_windows=True, edges=edges, rast=rast)
        # per row both planes' window legs and the packing
        ops = rows * (n_win * 16 + 2 + 4) + polygon_ops(torch, gx, gy, edges, rast)
        n_e = int(bk.active_edges_many(edges[None])[0]) if edges is not None else 0
        n_r = int(bk.active_rints_many(rast[None])[0]) if rast is not None else 0
        # the staged params with the polygon block's real rows
        staged = bk.stage_params(bids, boxes, wins).nbytes + 4 * (2 + 6 * n_e + 6 + 3 * n_r)
        k1[name] = {
            "ms": event_ms(launch),
            "wrapper_ms": event_ms(lambda: bk.block_scan(
                c3, bids, boxes, wins, col_names=windowed, has_boxes=True, has_windows=True,
                **kw)),
            "plain_ms": event_ms(lambda: bk.block_scan_plain(
                tcols, tbids, dev(boxes, torch.float32), dev(wins, torch.int32),
                has_boxes=True, has_windows=True, **pkw), runs=3, warmup=1),
            **bound(rows * 4 * len(windowed) + 2 * rows // 8 + staged, ops),
            "library_ms": None,
            "real_edges": n_e,
            "real_intervals": n_r,
            "shape": f"M={m} SUB={sub} cols={','.join(windowed)}",
        }
    del gx, gy

    # K2: 48 polygon queries in one [128, ...] chunk per leg combination
    n_q = 48
    qboxes, wins_q, _ = query_stacks(n_q, SEED + 10)
    edges, rasts = k2_polygon_stacks(rng, n_q)
    m2 = K2_SLOTS
    n_real = m2 - m2 // 40
    bids2, _ = bk.pad_bids(rng.integers(0, n_blocks, n_real), n_blocks, bucket=m2)
    qids = np.zeros(m2, np.int32)
    qids[:n_real] = rng.permutation(np.arange(n_real) % n_q)
    spip = np.zeros(m2, np.int32)
    spip[:n_real] = 1
    tb2, tq = dev(bids2, torch.int32), dev(qids, torch.int32)
    gx, gy = cols["x"][tb2.long()], cols["y"][tb2.long()]
    k2, err2 = {}, 0.0
    for name, es, rs in (("pip:E64", edges, None), ("raster:R16", None, rasts),
                         ("pip+raster:R16+E64", edges, rasts)):
        kw = dict(edges=es, spip=spip, n_edges=0 if es is None else 64, rasts=rs,
                  n_rints=0 if rs is None else 16)
        pkw = dict(edges=None if es is None else dev(es, torch.float32),
                   rasts=None if rs is None else dev(rs, torch.float32),
                   spip=dev(spip, torch.int32))
        for names, hw in variants:
            w = wins_q
            c3 = tuple(cols[k] for k in names)
            got_w, got_i = bk.block_scan_multi(c3, bids2, qids, qboxes, w, col_names=names,
                                               has_boxes=True, has_windows=hw, **kw)
            pw, pi = bk.block_scan_multi_plain(
                dict(zip(names, c3)), tb2, tq, dev(qboxes, torch.float32), dev(w, torch.int32),
                has_boxes=True, has_windows=hw, **pkw,
            )
            err2 = max(err2, max_abs_err(got_w, pw), max_abs_err(got_i, pi))
            check(torch.equal(got_w, pw) and torch.equal(got_i, pi),
                  f"block_scan_multi {name} windows={hw} M={m2}")
            check(bool(got_w.any()), f"block_scan_multi {name} windows={hw} selects rows")
            checks += 1
            del got_w, got_i, pw, pi
        c3 = tuple(cols[k] for k in windowed)
        tcols = dict(zip(windowed, c3))
        _, launch = bk.multi_launcher(tcols, bids2, qids, qboxes, wins_q, has_boxes=True,
                                      has_windows=True, edges=es, rasts=rs, spip=spip)
        ops = 0
        for q in range(n_q):
            sel = torch.from_numpy(np.flatnonzero(qids[:n_real] == q)).to(gx.device)
            nw = int(bk.slot_words(qboxes[q], wins_q[q])[2][1])
            ops += len(sel) * sub * 128 * (nw * 16 + 2 + 4) + polygon_ops(
                torch, gx[sel], gy[sel], None if es is None else es[q],
                None if rs is None else rs[q])
        rows2 = m2 * sub * 128
        k2[name] = {
            "ms": event_ms(launch),
            "wrapper_ms": event_ms(lambda: bk.block_scan_multi(
                c3, bids2, qids, qboxes, wins_q, col_names=windowed, has_boxes=True,
                has_windows=True, **kw)),
            "plain_ms": event_ms(lambda: bk.block_scan_multi_plain(
                tcols, tb2, tq, dev(qboxes, torch.float32), dev(wins_q, torch.int32),
                has_boxes=True, has_windows=True, **pkw), runs=3, warmup=1),
            **bound(rows2 * 4 * len(windowed) + 2 * rows2 // 8 + bk.stage_multi_params(
                bids2, qids, qboxes, wins_q, spip=spip, poly=bk.poly_words(
                    None if es is None else es[:n_q], None if rs is None else rs[:n_q],
                    0 if es is None else 64, 0 if rs is None else 16)).nbytes, ops),
            "library_ms": None,
            "shape": f"M={m2} Q=128 ({n_q} polygon queries) SUB={sub} "
                     f"cols={','.join(windowed)}",
        }
    del gx, gy
    return k1, k2, err, err2, checks


def extent_columns(torch, n_blocks, sub, device):
    """[n_blocks, sub, 128] extent columns (gxmin, gymin, gxmax, gymax),
    and tbin / toff, made on the card from a seed: bboxes from a point up
    to a few degrees wide, widened one f32 ulp outward as the packed column
    stores them; the last block's tail carries the extent table's pad
    sentinels (an empty bbox, +inf / -inf)."""
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 40)
    shape = (n_blocks, sub, 128)
    inf = torch.tensor(float("inf"), device=device)
    x0 = torch.rand(shape, generator=g, device=device) * 356 - 180
    y0 = torch.rand(shape, generator=g, device=device) * 176 - 90
    w = -torch.log1p(-torch.rand(shape, generator=g, device=device)) * 0.5
    h = -torch.log1p(-torch.rand(shape, generator=g, device=device)) * 0.5
    cols = {"gxmin": torch.nextafter(x0, -inf), "gymin": torch.nextafter(y0, -inf),
            "gxmax": torch.nextafter(x0 + w, inf), "gymax": torch.nextafter(y0 + h, inf)}
    del x0, y0, w, h
    cols["tbin"] = torch.randint(2800, 2820, shape, generator=g, device=device, dtype=torch.int32)
    cols["toff"] = torch.randint(0, 604_800, shape, generator=g, device=device, dtype=torch.int32)
    tail = (slice(-1, None), slice(sub // 2, None))
    cols["gxmin"][tail] = cols["gymin"][tail] = float("inf")
    cols["gxmax"][tail] = cols["gymax"][tail] = float("-inf")
    cols["tbin"][tail] = -1
    cols["toff"][tail] = 0
    return {k: v.contiguous() for k, v in cols.items()}


EXT = ("gxmax", "gxmin", "gymax", "gymin")  # the extent columns, as a table projects them


def extent_kernels(torch, device, n_blocks, sub, boxes1, wins1, dev):
    """The extent leg of all five kernels against their plain versions on
    synthetic extent columns of the main table's block count, then timed:
    K1 and K1p at M = 4096 and K2 at M = 2048 with 48 extent queries of
    1-8 box slots (K1 and K1p take 8 of them one by one), each with and
    without the window on (tbin, toff), plus the window alone and the
    validity leg on gxmin; K3 (256 x 256 and 33 x 17 grids) and K4 at
    M = 4096 with -1 pads, over the bbox centres. Timed on the XZ2 path's
    shape: the box leg on the four extent columns, 2 box slots."""
    from geomesa_tpu_torch.scan import aggregations as agg
    from geomesa_tpu_torch.scan import block_kernels as bk

    cols = extent_columns(torch, n_blocks, sub, device)
    windowed = tuple(sorted(EXT + ("tbin", "toff")))
    variants = [("box+window", windowed, True, True), ("box", EXT, True, False)]
    others = [("window", ("tbin", "toff"), False, True), ("valid", ("gxmin",), False, False)]
    n_q = 48
    qboxes, qwins, _ = query_stacks(n_q, SEED + 41)
    rng = np.random.default_rng(SEED + 42)
    err = dict.fromkeys(("block_scan", "block_pops", "block_scan_multi", "density", "bounds"), 0.0)
    checks = dict.fromkeys(err, 0)

    def cmp(name, got, ref, what):
        if got is None or ref is None:
            check(got is None and ref is None, f"{name} extent {what}: plane count")
            return
        err[name] = max(err[name], max_abs_err(got, ref))
        check(torch.equal(got, ref), f"{name} extent {what}")

    m = bk.M_BUCKETS[-1]
    bids, _ = bk.pad_bids(np.sort(rng.choice(n_blocks, size=m, replace=False)), n_blocks)
    tbids = dev(bids, torch.int32)
    cases = [(f"{v[0]} q{q}", *v[1:], qboxes[q], qwins[q]) for q in range(8) for v in variants]
    cases += [(o[0], *o[1:], qboxes[0], qwins[0]) for o in others]
    selected: dict = {}  # per variant: some query of it selects rows
    for what, names, hb, hw, bx, wn in cases:
        c3 = tuple(cols[k] for k in names)
        kw = dict(col_names=names, has_boxes=hb, has_windows=hw, extent=True)
        flags = dict(has_boxes=hb, has_windows=hw, extent=True)
        pargs = (dict(zip(names, c3)), tbids, dev(bx, torch.float32), dev(wn, torch.int32))
        w, i = bk.block_scan(c3, bids, bx, wn, **kw)
        pw, pi = bk.block_scan_plain(*pargs, **flags)
        cmp("block_scan", w, pw, f"{what} M={m}")
        cmp("block_scan", i, pi, f"{what} M={m} inner")
        selected[what.split()[0]] = selected.get(what.split()[0], False) or bool(w.any())
        check((i is None) == hb, f"block_scan extent {what}: one plane with boxes")
        del w, i, pw, pi
        checks["block_scan"] += 1
        got = agg.block_pops(c3, bids, bx, wn, **kw)
        cmp("block_pops", got, agg.block_pops_plain(*pargs, **flags), f"{what} M={m}")
        checks["block_pops"] += 1
    for variant, sel in selected.items():
        check(sel, f"block_scan extent {variant} selects rows")

    m2 = K2_SLOTS
    n_real = m2 - m2 // 40
    bids2, _ = bk.pad_bids(rng.integers(0, n_blocks, n_real), n_blocks, bucket=m2)
    qids = np.zeros(m2, np.int32)
    qids[:n_real] = rng.permutation(np.arange(n_real) % n_q)
    tb2, tq = dev(bids2, torch.int32), dev(qids, torch.int32)
    for what, names, hb, hw in variants + others:
        c3 = tuple(cols[k] for k in names)
        w, i = bk.block_scan_multi(c3, bids2, qids, qboxes, qwins, col_names=names,
                                   has_boxes=hb, has_windows=hw, extent=True)
        pw, pi = bk.block_scan_multi_plain(
            dict(zip(names, c3)), tb2, tq, dev(qboxes, torch.float32), dev(qwins, torch.int32),
            has_boxes=hb, has_windows=hw, extent=True)
        cmp("block_scan_multi", w, pw, f"{what} M={m2}")
        cmp("block_scan_multi", i, pi, f"{what} M={m2} inner")
        check(bool(w.any()), f"block_scan_multi extent {what} selects rows")
        del w, i, pw, pi
        checks["block_scan_multi"] += 1

    gb = np.array([-100, -60, 120, 70], np.float32)
    pbids, _ = bk.pad_bids(np.sort(rng.choice(n_blocks, size=m - 96, replace=False)), n_blocks,
                           pad=-1)
    tpb = dev(pbids, torch.int32)
    for what, names, hb, hw in variants + others[:1]:
        names = tuple(sorted(set(names) | set(EXT)))  # the aggregations read the extents
        c3 = tuple(cols[k] for k in names)
        kw = dict(col_names=names, has_boxes=hb, has_windows=hw, extent=True)
        flags = dict(has_boxes=hb, has_windows=hw, extent=True)
        pargs = (dict(zip(names, c3)), tpb, dev(boxes1, torch.float32), dev(wins1, torch.int32))
        for width, height in ((256, 256), (33, 17)):
            got = agg.block_density(c3, pbids, boxes1, wins1, gb, width=width, height=height, **kw)
            ref = agg.density_plain(*pargs, dev(gb, torch.float32), width=width, height=height,
                                    **flags)
            cmp("density", got, ref, f"{what} {width}x{height}")
            check(float(got.sum()) > 0, f"density extent {what} counts rows")
            checks["density"] += 1
        st = agg.block_bounds(c3, pbids, boxes1, wins1, **kw)
        sp = agg.bounds_plain(*pargs, **flags)
        n_r = m - 96
        cmp("bounds", st[:n_r], sp[:n_r], what)
        check(bool(torch.isfinite(st[:n_r, 1:5][st[:n_r, 0] > 0]).all()),
              f"bounds extent {what}: no NaN centre")
        checks["bounds"] += 1

    # timing: the XZ2 path's shape (box leg, four extent columns, the two
    # box slots of the point kernels' timing), all slots real
    names, flags = EXT, dict(has_boxes=True, has_windows=False, extent=True)
    c3 = tuple(cols[k] for k in names)
    tcols = dict(zip(names, c3))
    kw = dict(col_names=names, **flags)
    bids, _ = bk.pad_bids(np.arange(m), n_blocks)
    pargs = (tcols, dev(bids, torch.int32), dev(boxes1, torch.float32), dev(wins1, torch.int32))
    rows = m * sub * 128
    col_bytes = rows * 4 * len(names)
    wide_ops = rows * leg_ops(boxes1, wins1, True, False, planes=1)
    out = {}
    _, launch = bk.scan_launcher(tcols, bids, boxes1, wins1, **flags)
    out["block_scan"] = {
        "ms": event_ms(launch),
        "wrapper_ms": event_ms(lambda: bk.block_scan(c3, bids, boxes1, wins1, **kw)),
        "plain_ms": event_ms(lambda: bk.block_scan_plain(*pargs, **flags)),
        # per row the wide plane's legs, a shift and an OR to pack; one plane out
        **bound(col_bytes + rows // 8 + bids.nbytes, wide_ops + rows * 2),
    }
    _, p_launch = agg.pops_launcher(tcols, bids, boxes1, wins1, **flags)
    out["block_pops"] = {
        "ms": event_ms(p_launch),
        "wrapper_ms": event_ms(lambda: agg.block_pops(c3, bids, boxes1, wins1, **kw)),
        "plain_ms": event_ms(lambda: agg.block_pops_plain(*pargs, **flags)),
        **bound(col_bytes + m * 4 + bids.nbytes, wide_ops + rows * 2 + rows // 16),
    }
    # the library yardstick of K3: one bincount over the hits' pixels
    g = {k: v[pargs[1].to(torch.int64)] for k, v in tcols.items()}
    wm, _ = bk.masks_plain(g, pargs[2], pargs[3], True, False, extent=True)
    wide_hits = int(wm.sum())
    xs = (g["gxmin"][wm] + g["gxmax"][wm]) * 0.5
    ys = (g["gymin"][wm] + g["gymax"][wm]) * 0.5
    del g, wm
    x0, y0, x1, y1 = (float(v) for v in gb)
    inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    xs, ys = xs[inside], ys[inside]
    px = ((xs - x0) / (x1 - x0) * 256).to(torch.int32).clamp(0, 255)
    py = ((ys - y0) / (y1 - y0) * 256).to(torch.int32).clamp(0, 255)
    flat = py.to(torch.int64) * 256 + px.to(torch.int64)
    del xs, ys, px, py, inside
    # per wide hit the centre (2 adds, 2 multiplies) and the closed
    # envelope (4 compares, 4 ANDs); per hit in it the pixel (15, as K3's
    # point leg) and one increment
    density_ops = wide_ops + wide_hits * 12 + flat.numel() * 15
    _, d_launch = agg.density_launcher(tcols, bids, boxes1, wins1, gb, width=256, height=256,
                                       **flags)
    out["density"] = {
        "ms": event_ms(d_launch),
        "wrapper_ms": event_ms(lambda: agg.block_density(
            c3, bids, boxes1, wins1, gb, width=256, height=256, **kw)),
        "plain_ms": event_ms(lambda: agg.density_plain(
            *pargs, dev(gb, torch.float32), width=256, height=256, **flags)),
        **bound(col_bytes + 256 * 256 * 4 + bids.nbytes, density_ops),
        "library_ms": event_ms(lambda: torch.bincount(flat, minlength=256 * 256)),
        "hits": int(flat.numel()),
    }
    del flat
    _, b_launch = agg.bounds_launcher(tcols, bids, boxes1, wins1, **flags)
    out["bounds"] = {
        "ms": event_ms(b_launch),
        "wrapper_ms": event_ms(lambda: agg.block_bounds(c3, bids, boxes1, wins1, **kw)),
        "plain_ms": event_ms(lambda: agg.bounds_plain(*pargs, **flags)),
        # per wide hit the centre, a count and four min/max
        **bound(col_bytes + m * 8 * 4 + bids.nbytes, wide_ops + wide_hits * 9),
    }
    m2 = K2_SLOTS
    bids2 = np.sort(rng.choice(n_blocks, size=m2, replace=False)).astype(np.int32)
    qids = rng.permutation(np.arange(m2) % n_q).astype(np.int32)
    rows2 = m2 * sub * 128
    per_query = np.array([leg_ops(qboxes[q], qwins[q], True, False, planes=1) + 2
                          for q in range(len(qboxes))])
    _, launch = bk.multi_launcher(tcols, bids2, qids, qboxes, qwins, **flags)
    pargs2 = (tcols, dev(bids2, torch.int32), dev(qids, torch.int32),
              dev(qboxes, torch.float32), dev(qwins, torch.int32))
    out["block_scan_multi"] = {
        "ms": event_ms(launch),
        "wrapper_ms": event_ms(lambda: bk.block_scan_multi(
            c3, bids2, qids, qboxes, qwins, **kw)),
        "plain_ms": event_ms(lambda: bk.block_scan_multi_plain(*pargs2, **flags)),
        **bound(rows2 * 4 * len(names) + rows2 // 8
                + bk.stage_multi_params(bids2, qids, qboxes, qwins).nbytes,
                sub * 128 * int(per_query[qids].sum())),
    }
    for name, rec in out.items():
        rec.setdefault("library_ms", None)
        rec["max_abs_err"] = err[name]
        rec["equal_to_plain"] = err[name] == 0.0
        rec["checks"] = checks[name]
        rec["shape"] = (f"M={m2 if name == 'block_scan_multi' else m} SUB={sub} "
                        f"cols={','.join(names)}"
                        + (f" Q=128 ({n_q} real)" if name == "block_scan_multi" else "")
                        + (" grid=256x256" if name == "density" else ""))
    del cols, c3, tcols, pargs, pargs2
    torch.cuda.empty_cache()
    return out


# -- phase 4: the main path --------------------------------------------------


def root_codes(n, seed) -> np.ndarray:
    """GDELT's ``EventRootCode``: the 20 CAMEO root codes "01".."20",
    skewed toward the verbal ones as GDELT's are (a host column only)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, 21)
    return np.array([f"{c:02d}" for c in range(1, 21)])[rng.choice(20, n, p=w / w.sum())]


def build_store(torch, device, n, packed: bool = False, index: str = "z3", seed: int = SEED,
                with_root_code: bool = False, adapter=None, **store_kw):
    """A GDELT-shaped point table of n rows: (dtg, geom) on Z3, or geom
    alone on Z2 (the reference benchmark's points of its configuration 4);
    ``with_root_code`` adds the string attribute ``EventRootCode`` (drawn
    from its own seed, so the points and times stay the same); ``adapter``
    is the store's storage.adapter backend (None: the device tables);
    ``store_kw`` (cache, metrics, audit) pass to the DataStore.
    Returns (store, (x, y, t | None), ingest seconds)."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    rng = np.random.default_rng(seed)
    x, y = gdelt_points(n, rng)
    t = T0_MS + rng.integers(0, SPAN_MS, n) if index == "z3" else None
    spec = "dtg:Date,*geom:Point:srid=4326" if index == "z3" else "*geom:Point:srid=4326"
    if with_root_code:
        spec = "EventRootCode:String," + spec
    sft = FeatureType.from_spec("gdelt", spec)
    sft.user_data["geomesa.indices.enabled"] = index
    if packed:
        sft.user_data["geomesa.z3.packed-time"] = "true"
    ds = DataStore(device=device, adapter=adapter, **store_kw)
    ds.create_schema(sft)
    cols = {"geom": (x, y)} if t is None else {"dtg": t, "geom": (x, y)}
    if with_root_code:
        cols["EventRootCode"] = root_codes(n, seed + 7)
    fc = FeatureCollection.from_columns(sft, np.arange(n), cols)
    t_in = time.perf_counter()
    ds.write("gdelt", fc, check_ids=False)
    torch.cuda.synchronize()
    return ds, (x, y, t), time.perf_counter() - t_in


def brute_ids(src, box) -> np.ndarray:
    x, y, t = src
    x0, y0, x1, y1, lo, hi = box
    return np.flatnonzero(
        (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1) & (t >= lo) & (t < hi)
    )


def check_queries(ds, src, measured, results, n_check) -> int:
    """ids vs an f64 brute-force filter, and count vs len, for the first
    n_check queries; returns how many were checked."""
    checked = list(zip(measured, results))[:n_check]
    for (q, box), out in checked:
        got = np.sort(np.asarray(out.ids, dtype=np.int64))
        check(np.array_equal(got, brute_ids(src, box)), f"query ids vs brute force: {q}")
        check(ds.count("gdelt", q) == len(out), f"count == len(query): {q}")
    return len(checked)


def check_aggregations(torch, ds, queries):
    """density / bounds(estimate=True) through the store against the plain
    versions over the same device table and candidate blocks."""
    from geomesa_tpu_torch.scan import aggregations as agg

    table = ds.table("gdelt", "z3")
    n = 0
    for q, (x0, y0, x1, y1, _, _) in queries:
        env = (x0, y0, x1, y1)
        grid = ds.density("gdelt", q, envelope=env, width=256, height=256)
        env_stats = ds.bounds("gdelt", q, estimate=True)
        plan = ds.planner.plan("gdelt", q)
        cols3, bids, n_real, boxes, wins, kw = table.agg_launch_args(plan.config)
        cols = dict(zip(kw["col_names"], cols3))
        dv = table.device
        targs = (cols, torch.from_numpy(bids).to(dv), torch.from_numpy(boxes).to(dv),
                 torch.from_numpy(wins).to(dv))
        flags = dict(has_boxes=kw["has_boxes"], has_windows=kw["has_windows"])
        ref = agg.density_plain(
            *targs, torch.tensor(env, dtype=torch.float32, device=dv),
            width=256, height=256, **flags,
        ).cpu().numpy()
        check(np.array_equal(grid, ref), f"density vs plain: {q}")
        st = agg.bounds_plain(*targs, **flags).cpu().numpy()
        check(env_stats == agg.reduce_bounds(st, n_real)[1], f"bounds vs plain: {q}")
        check(float(grid.sum()) > 0 and env_stats is not None, f"aggregations see hits: {q}")
        n += 1
    return n


def busiest(queries, outs, k):
    """The k queries with the most hits (aggregations over them see data)."""
    order = np.argsort([-len(o) for o in outs], kind="stable")[:k]
    return [queries[i] for i in order]


def run_queries(ds, queries, type_name="gdelt"):
    lat, outs = [], []
    t_all = time.perf_counter()
    for q, *_ in queries:
        s = time.perf_counter()
        outs.append(ds.query(type_name, q))
        lat.append(time.perf_counter() - s)
    return np.array(lat), outs, time.perf_counter() - t_all


def zero_launches() -> None:
    """Zero every system kernel's launch counts and the native host
    helpers' call counts."""
    from geomesa_tpu_torch import native
    from geomesa_tpu_torch.kernels import KERNELS

    for k in KERNELS:
        k.reset_counts()
    native.reset_counts()


def read_native() -> dict:
    """Calls into the native host helpers since the last zero_launches()."""
    from geomesa_tpu_torch import native

    return dict(native.calls)


def read_launches() -> dict:
    from geomesa_tpu_torch.kernels import KERNELS

    return {k.name: k.launches for k in KERNELS}


def read_leg_launches() -> dict:
    """Launches per polygon leg of the kernels that have them."""
    from geomesa_tpu_torch.kernels import KERNELS

    return {k.name: dict(k.leg_launches) for k in KERNELS if k.leg_launches}


@contextmanager
def chunk_recorder():
    """Record the members of every fused chunk the table launches (one
    entry per scan_planes_multi call: its queries, max qid + 1)."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    members: list = []
    launch = bk.scan_planes_multi

    def recording(cols3, bids, qids, *args, **kw):
        members.append(int(np.max(qids)) + 1)
        return launch(cols3, bids, qids, *args, **kw)

    bk.scan_planes_multi = recording
    try:
        yield members
    finally:
        bk.scan_planes_multi = launch


@contextmanager
def scan_m_recorder():
    """Record the candidate blocks of every single-query scan the table
    launches: per ``scan_planes`` call its M (the padded bucket K1 runs
    over) and its real blocks (the ids before the trailing pad run of
    block 0)."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    shapes: list = []
    launch = bk.scan_planes

    def recording(cols3, bids, *args, **kw):
        b = np.asarray(bids)
        nz = np.flatnonzero(b)
        shapes.append((len(b), int(nz[-1]) + 1 if len(nz) else 1))
        return launch(cols3, bids, *args, **kw)

    bk.scan_planes = recording
    try:
        yield shapes
    finally:
        bk.scan_planes = launch


def m_summary(values) -> dict:
    v = np.asarray(values, np.float64)
    return {"median": float(np.median(v)), "p90": float(np.percentile(v, 90)),
            "max": int(v.max())}


@contextmanager
def plain_pops(torch):
    """IndexTable.count's own arithmetic with block_pops_plain in place of
    the K1p kernel (straddling blocks still decode through K1)."""
    from geomesa_tpu_torch.scan import aggregations as agg

    kernel = agg.block_pops

    def plain(cols3, bids, boxes, wins, *, col_names, has_boxes, has_windows, extent=False,
              **_):
        dv = cols3[0].device
        return agg.block_pops_plain(
            dict(zip(col_names, cols3)), torch.from_numpy(np.asarray(bids, np.int32)).to(dv),
            torch.from_numpy(boxes).to(dv), torch.from_numpy(wins).to(dv),
            has_boxes=has_boxes, has_windows=has_windows, extent=extent,
        )

    agg.block_pops = plain
    try:
        yield
    finally:
        agg.block_pops = kernel


def check_counts(torch, ds, queries, outs, estimates) -> int:
    """Count estimates against the count arithmetic over block_pops_plain,
    and against the exact hits."""
    table = ds.table("gdelt", "z3")
    for (q, _), out, n in zip(queries, outs, estimates):
        with plain_pops(torch):
            ref = table.count(ds.planner.plan("gdelt", q).config)
        check(n == ref, f"count estimate {n} vs plain {ref}: {q}")
        check(n >= len(out), f"count estimate {n} >= hits {len(out)}: {q}")
    return len(estimates)


def check_same_ids(got, ref, what: str) -> None:
    for k, (a, b) in enumerate(zip(got, ref)):
        check(np.array_equal(np.sort(np.asarray(a.ids, np.int64)),
                             np.sort(np.asarray(b.ids, np.int64))), f"{what}: query {k}")
    check(len(got) == len(ref), f"{what}: one result per query")


SERVING_COUNTERS = ("submitted", "shed", "coalesced", "batches", "batched_queries")


def serving_counts(metrics) -> dict:
    """The scheduler's geomesa.serving.* counters in a registry."""
    return {k: metrics.counter_value(f"geomesa.serving.{k}") for k in SERVING_COUNTERS}


def count_estimates(ds, queries) -> list:
    return [ds.stats_query("gdelt", "Count()", q, estimate=True)[0].count for q, _ in queries]


def batch_path(torch, ds, measured, outs, seq_wall: float) -> dict:
    """The many-query path on the main path's store: query_many (a warm
    call, a timed one, a traced one), the serving scheduler under 8 client threads,
    density_many over the 4 busiest envelopes and 8 count estimates;
    launch counts zeroed before, read after, checks after that."""
    from concurrent.futures import ThreadPoolExecutor

    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    filters = [q for q, _ in measured]
    zero_launches()
    ds.query_many("gdelt", filters)
    before = read_launches()
    with chunk_recorder() as members:
        t0 = time.perf_counter()
        many = ds.query_many("gdelt", filters)
        many_s = time.perf_counter() - t0
    timed = {k: v - before[k] for k, v in read_launches().items()}
    # a traced pass of the same call splits its time by phase
    ds.clock = clock = PhaseClock()
    t0 = time.perf_counter()
    ds.query_many("gdelt", filters)
    traced_s = time.perf_counter() - t0
    phases = {k: v * 1e3 for k, v in clock.settle().items() if not k.startswith("n.")}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))

    sched = ds.serve()
    counted0 = serving_counts(sched.metrics)
    try:
        def client(k):
            futs = [sched.submit("gdelt", q) for q in filters[k * 8:(k + 1) * 8]]
            return [f.result(600) for f in futs]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            served = [o for outs_k in ex.map(client, range(8)) for o in outs_k]
        serve_s = time.perf_counter() - t0
    finally:
        ds.close()
    served_counts = {k: v - counted0[k] for k, v in serving_counts(sched.metrics).items()}

    tiles = busiest(measured, outs, 4)
    requests = [(q, (x0, y0, x1, y1)) for q, (x0, y0, x1, y1, _, _) in tiles]
    t0 = time.perf_counter()
    grids = ds.density_many("gdelt", requests, width=256, height=256)
    density_s = time.perf_counter() - t0
    counted = measured[:8]
    t0 = time.perf_counter()
    estimates = count_estimates(ds, counted)
    count_s = time.perf_counter() - t0
    launches = read_launches()

    check_same_ids(many, outs, "query_many vs sequential query")
    check_same_ids(served, outs, "scheduler vs sequential query")
    check(served_counts["submitted"] == len(served)
          == served_counts["batched_queries"] + served_counts["coalesced"],
          f"the registry counts every served query once: {served_counts}")
    for (q, env), grid in zip(requests, grids):
        ref = ds.density("gdelt", q, envelope=env, width=256, height=256)
        check(np.array_equal(grid, ref) and float(grid.sum()) > 0, f"density_many vs density: {q}")
    n_counts = check_counts(torch, ds, counted, outs[:8], estimates)
    hits = sum(len(o) for o in many)
    return {
        "phase": "batch_path", "cell": "gdelt-z3-100M-batch", "launches": launches,
        "native": read_native(),
        "n_queries": len(filters), "hits_total": hits,
        "query_many_s": many_s, "query_many_queries_per_s": len(filters) / many_s,
        "query_many_features_per_s": hits / many_s,
        "sequential_queries_per_s": len(filters) / seq_wall,
        "chunks": len(members), "members_per_chunk": members,
        "members_to_k1": timed["block_scan"], "query_many_launches": timed,
        "query_many_phase_ms": phases, "query_many_traced_s": traced_s,
        "query_many_device_busy_share": device_ms / (traced_s * 1e3),
        "scheduler_wall_s": serve_s, "scheduler_queries_per_s": len(served) / serve_s,
        "scheduler_batches": served_counts["batches"],
        "scheduler_batched_queries": served_counts["batched_queries"],
        "scheduler_coalesced": served_counts["coalesced"],
        "density_many_s": density_s, "count_estimate_ms": count_s / len(counted) * 1e3,
        "count_estimates": estimates, "exact_counts": [len(o) for o in outs[:8]],
        "checked_query_many": len(many), "checked_scheduler": len(served),
        "checked_density_many": len(grids), "checked_counts": n_counts,
    }


# -- polygon paths ---------------------------------------------------------


def cluster_centres(seed):
    """The gaussian cluster centres gdelt_points draws first from the
    store's seed."""
    r = np.random.default_rng(seed)
    return r.uniform(-160, 160, 64), r.uniform(-55, 65, 64)


def polygon_query_set(seed, n, centres, timed: bool, specials: bool):
    """[(ecql, geometry as parsed, (lo_ms, hi_ms) | None, kind)] for n
    INTERSECTS queries: stars of 3-60 arms (6-120 edges), radii 1-12
    degrees, every other one centred on a cluster; ``timed`` adds a
    DURING window of 6 h - 14 d; ``specials``: the first four carry a
    hole, the next two are MultiPolygons, the next two have more than 256
    edges."""
    from geomesa_tpu_torch import geometry as geo

    r = np.random.default_rng(seed)
    wins = time_windows(r, n, T0_MS, SPAN_MS) if timed else [None] * n
    out = []
    for k in range(n):
        if k % 2 == 0:
            c = int(r.integers(0, 64))
            cx, cy = centres[0][c] + r.normal(0, 2), centres[1][c] + r.normal(0, 1.5)
        else:
            cx, cy = r.uniform(-165, 165), r.uniform(-75, 75)
        rad = float(r.uniform(1, 12))
        arms = int(r.integers(3, 61))
        # whole polygons inside the lon/lat domain (no antimeridian split)
        cx = float(np.clip(cx, -178 + rad, 178 - rad))
        cy = float(np.clip(cy, -88 + rad, 88 - rad))
        kind = "star"
        if specials and k < 4:
            g, kind = star(cx, cy, rad, arms, r, hole=True), "hole"
        elif specials and k < 6:
            other = star(cx - np.sign(cx) * 3 * rad, cy, rad / 2, arms, r)  # disjoint parts
            g, kind = geo.MultiPolygon([star(cx, cy, rad, arms, r), other]), "multi"
        elif specials and k < 8:
            g, kind = star(cx, cy, rad, int(r.integers(130, 141)), r), "e>256"
        else:
            g = star(cx, cy, rad, arms, r)
        q = f"INTERSECTS(geom, {geo.to_wkt(g)})"
        if wins[k] is not None:
            lo, hi = wins[k]
            q += f" AND dtg DURING {np.datetime64(lo, 'ms')}Z/{np.datetime64(hi, 'ms')}Z"
        # the geometry as the filter parses it
        out.append((q, geo.from_wkt(geo.to_wkt(g)), wins[k], kind))
    return out


def brute_polygon_ids(src, geom, window) -> np.ndarray:
    """f64 brute force: the bbox and the window first, then the even-odd
    point-in-polygon test over every ring."""
    from geomesa_tpu_torch import geometry as geo

    x, y, t = src
    x0, y0, x1, y1 = geom.bounds()
    m = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    if window is not None:
        m &= (t >= window[0]) & (t < window[1])
    cand = np.flatnonzero(m)
    return cand[geo.points_in_polygon(x[cand], y[cand], geom)]


def leg_of(config) -> str:
    """The scan legs a polygon config rides: pip, raster, pip+raster, or
    bbox (host refinement alone)."""
    legs = [n for n, b in (("pip", config.poly), ("raster", config.rast)) if b is not None]
    return "+".join(legs) or "bbox"


@contextmanager
def raster_knob(name, value, ds):
    """One raster knob set for the block (the raster cache and the store
    planner's scan-config memo dropped around it: a memoized config holds
    the legs of the setting it was planned under)."""
    from geomesa_tpu_torch import conf
    from geomesa_tpu_torch.filter import raster as fr

    prop = getattr(conf, name)
    prop.set(value)
    fr.clear_cache()
    ds.planner.invalidate_config_memo()
    try:
        yield
    finally:
        prop.clear()
        fr.clear_cache()
        ds.planner.invalidate_config_memo()


def host_density(x, y, envelope, width, height) -> np.ndarray:
    """The reference's pixel rule over hit coordinates (numpy)."""
    x0, y0, x1, y1 = envelope
    grid = np.zeros(height * width, np.float32)
    m = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    px = np.clip(((x - x0) / (x1 - x0) * width).astype(np.int64), 0, width - 1)
    py = np.clip(((y - y0) / (y1 - y0) * height).astype(np.int64), 0, height - 1)
    np.add.at(grid, (py * width + px)[m], 1)
    return grid.reshape(height, width)


def polygon_path(torch, ds, src, index: str, warm, measured, n_brute: int, n_settings: int,
                 n_agg: int, n_full_scan: int) -> dict:
    """Polygon queries through query (untraced, then traced), query_many,
    the scheduler (8 threads), the same queries under the two other raster
    settings, count / bounds / density, and the old full-table host scan
    for comparison; launch counts zeroed before, read after, checks after
    that."""
    from concurrent.futures import ThreadPoolExecutor

    from geomesa_tpu_torch.planning.planner import QueryPlan
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    table = ds.table("gdelt", index)
    filters = [q for q, *_ in measured]
    zero_launches()
    run_queries(ds, warm)
    lat, outs, wall = run_queries(ds, measured)
    ds.clock = clock = PhaseClock()
    _, _, traced_wall = run_queries(ds, measured)
    phases = {k: v / len(measured) * 1e3 for k, v in clock.settle().items() if not k.startswith("n.")}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))

    legs: dict = {}
    cand_blocks, cont_rows = [], []
    for q in filters:
        cfg = ds.planner.plan("gdelt", q).config
        check(cfg is not None and ds.planner.plan("gdelt", q).index == index,
              f"polygon query plans to the {index} index scan: {q[:60]}")
        legs[leg_of(cfg)] = legs.get(leg_of(cfg), 0) + 1
        overlap, contained = table.candidate_spans_split(cfg)
        cand_blocks.append(len(table.candidate_blocks(overlap)))
        cont_rows.append(sum(z - a for a, z in contained))

    with chunk_recorder() as members:
        t0 = time.perf_counter()
        many = ds.query_many("gdelt", filters)
        many_s = time.perf_counter() - t0

    sched = ds.serve()
    try:
        def client(k):
            futs = [sched.submit("gdelt", q) for q in filters[k * 6:(k + 1) * 6]]
            return [f.result(600) for f in futs]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            served = [o for outs_k in ex.map(client, range(8)) for o in outs_k]
        serve_s = time.perf_counter() - t0
    finally:
        ds.close()

    settings = {}
    for label, name, value in (("device_residue", "RASTER_RESIDUE", "device"),
                               ("raster_off", "RASTER_ENABLED", False)):
        with raster_knob(name, value, ds):
            s_lat, s_outs, _ = run_queries(ds, measured[:n_settings])
            # every query through query_many: groups of more than 8
            # members fuse (smaller ones go to K1), so the chunks of this
            # setting's leg combination run
            s_many = ds.query_many("gdelt", filters)
            s_legs: dict = {}
            for q in filters[:n_settings]:
                leg = leg_of(ds.planner.plan("gdelt", q).config)
                s_legs[leg] = s_legs.get(leg, 0) + 1
        settings[label] = (s_lat, s_outs, s_many, s_legs)

    brute = [brute_polygon_ids(src, g, w) for _, g, w, _ in measured[:n_brute]]
    with_hits = [k for k in np.argsort([-len(b) for b in brute], kind="stable")[:n_agg]]
    aggs = []
    t0 = time.perf_counter()
    for k in with_hits:
        q = filters[k]
        env = measured[k][1].bounds()
        aggs.append((ds.count("gdelt", q), ds.bounds("gdelt", q, estimate=False),
                     ds.bounds("gdelt", q, estimate=True),
                     ds.stats_query("gdelt", "Count()", q, estimate=True)[0].count,
                     ds.density("gdelt", q, envelope=env, width=128, height=128)))
    agg_s = time.perf_counter() - t0
    launches, leg_launches = read_launches(), read_leg_launches()

    # the full-table host scan the port ran for every polygon before this
    # slice, on the smallest polygons (it reads every row)
    full_ms = []
    for k in np.argsort([len(b) for b in brute], kind="stable")[:n_full_scan]:
        t0 = time.perf_counter()
        full = ds.planner.execute(QueryPlan("gdelt", ds.planner.plan("gdelt", filters[k]).filter,
                                            None, None))
        full_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(np.sort(np.asarray(full.ids, np.int64)), brute[k]),
              f"full-table host scan vs brute force: {filters[k][:60]}")

    for k, ids in enumerate(brute):
        got = np.sort(np.asarray(outs[k].ids, np.int64))
        check(np.array_equal(got, ids), f"polygon ids vs brute force ({measured[k][3]}): "
                                        f"{filters[k][:60]}")
    check_same_ids(many, outs, f"{index} polygon query_many vs sequential query")
    check_same_ids(served, outs, f"{index} polygon scheduler vs sequential query")
    for label, (_, s_outs, s_many, _) in settings.items():
        check_same_ids(s_outs, outs[:n_settings], f"{index} polygon ids under {label}")
        check_same_ids(s_many, outs, f"{index} polygon query_many under {label}")
    x, y, _ = src
    for k, (n, env, env_est, est, grid) in zip(with_hits, aggs):
        ids = brute[k]
        check(n == len(ids) == est, f"polygon count {n} / Count() {est} vs brute {len(ids)}")
        ref_env = (float(x[ids].min()), float(y[ids].min()), float(x[ids].max()),
                   float(y[ids].max())) if len(ids) else None
        check(env == env_est == ref_env, f"polygon bounds {env} / {env_est} vs brute {ref_env}")
        ref = host_density(x[ids], y[ids], measured[k][1].bounds(), 128, 128)
        check(np.array_equal(grid, ref) and grid.sum() == len(ids), "polygon density vs brute")
    hits = sum(len(o) for o in outs)
    return {
        "launches": launches, "leg_launches": leg_launches, "native": read_native(),
        "n_points": table.n, "index": index, "n_blocks": table.n_blocks,
        "n_queries": len(measured), "hits_total": hits,
        "query_kinds": {kd: sum(1 for *_, k2 in measured if k2 == kd)
                        for kd in sorted({m[3] for m in measured})},
        "queries_by_leg": legs,
        "candidate_blocks_mean": float(np.mean(cand_blocks)),
        "candidate_blocks_max": int(np.max(cand_blocks)),
        "contained_rows_mean": float(np.mean(cont_rows)),
        "full_scan_blocks": table.n_blocks,
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p84_ms": float(np.percentile(lat, 84) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "latency_mean_ms": float(lat.mean() * 1e3),
        "features_per_s": hits / wall,
        "phase_ms_per_query": phases,
        "traced_ms_per_query": traced_wall / len(measured) * 1e3,
        "device_busy_share": device_ms / (traced_wall / len(measured) * 1e3),
        "query_many_s": many_s, "query_many_queries_per_s": len(filters) / many_s,
        "chunks": len(members), "members_per_chunk": members,
        "scheduler_wall_s": serve_s, "scheduler_queries_per_s": len(served) / serve_s,
        "settings": {label: {"n_queries": len(s_outs),
                             "latency_p50_ms": float(np.percentile(s_lat, 50) * 1e3),
                             "queries_by_leg": s_legs}
                     for label, (s_lat, s_outs, _, s_legs) in settings.items()},
        "settings_default_latency_p50_ms": float(np.percentile(lat[:n_settings], 50) * 1e3),
        "aggregations_s": agg_s,
        "full_scan_ms": full_ms,
        "pruned_latency_ms_same_queries": [
            float(lat[k] * 1e3)
            for k in np.argsort([len(b) for b in brute], kind="stable")[:n_full_scan]],
        "checked_vs_brute_force": len(brute), "checked_query_many": len(many),
        "checked_scheduler": len(served),
        "checked_settings": sum(len(v[1]) + len(v[2]) for v in settings.values()),
        "checked_aggregations": len(aggs),
    }


# -- extent paths ----------------------------------------------------------


def footprints(n, rng, cities):
    """Building-footprint rectangles of 20-200 m clustered around the
    cities, drawn as the reference benchmark's configuration 3 draws them
    (bench.py:308-384): (x0, y0, x1, y1) f64."""
    cx, cy = cities
    which = rng.integers(0, len(cx), n)
    x0 = np.clip(cx[which] + rng.normal(0, 0.5, n), -179.9, 179.8)
    y0 = np.clip(cy[which] + rng.normal(0, 0.4, n), -89.9, 89.8)
    del which
    return x0, y0, x0 + rng.uniform(0.0002, 0.002, n), y0 + rng.uniform(0.0002, 0.002, n)


def extent_store(torch, device, type_name, spec, index, columns, n):
    """A DataStore with one extent schema on ``index`` and n features
    written; returns (store, ingest seconds)."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    sft = FeatureType.from_spec(type_name, spec)
    sft.user_data["geomesa.indices.enabled"] = index
    ds = DataStore(device=device)
    ds.create_schema(sft)
    fc = FeatureCollection.from_columns(sft, np.arange(n), columns)
    t_in = time.perf_counter()
    ds.write(type_name, fc, check_ids=False)
    torch.cuda.synchronize()
    return ds, time.perf_counter() - t_in


def rect_wkt(x0, y0, x1, y1) -> str:
    return (f"POLYGON(({x0:.4f} {y0:.4f}, {x1:.4f} {y0:.4f}, {x1:.4f} {y1:.4f}, "
            f"{x0:.4f} {y1:.4f}, {x0:.4f} {y0:.4f}))")


def parsed_box(x0, y0, x1, y1) -> tuple:
    """The box as the printed 4-decimal filter parses."""
    return tuple(float(f"{v:.4f}") for v in (x0, y0, x1, y1))


def rect_queries(seed, n, cities):
    """[(ecql, box as parsed)] for n INTERSECTS rectangle queries drawn as
    the reference benchmark's configuration 3 draws them (widths
    0.02-2 degrees near a city)."""
    cx, cy = cities
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = r.integers(0, len(cx))
        qw = float(r.choice([0.02, 0.05, 0.1, 0.5, 2.0]))
        qx = cx[c] + r.uniform(-1, 1)
        qy = cy[c] + r.uniform(-0.8, 0.8)
        out.append((f"INTERSECTS(geom, {rect_wkt(qx, qy, qx + qw, qy + qw)})",
                    parsed_box(qx, qy, qx + qw, qy + qw)))
    return out


def brute_rect_ids(boxes, q) -> np.ndarray:
    """Rectangles meeting the closed query box: box algebra in f64."""
    x0, y0, x1, y1 = boxes
    return np.flatnonzero((x0 <= q[2]) & (x1 >= q[0]) & (y0 <= q[3]) & (y1 >= q[1]))


def check_table_aggregations(torch, ds, type_name, index, queries) -> int:
    """IndexTable.count, density (256 x 256 over the query box) and
    bounds_stats on the extent table against the count arithmetic over
    the plain popcount and the plain density and bounds over the same
    device table and candidate blocks."""
    from geomesa_tpu_torch.scan import aggregations as agg

    table = ds.table(type_name, index)
    n = 0
    for q, box in queries:
        cfg = ds.planner.plan(type_name, q).config
        env = box[:4]
        count = table.count(cfg)
        grid = table.density(cfg, env, 256, 256)
        stats = table.bounds_stats(cfg)
        with plain_pops(torch):
            check(count == table.count(cfg), f"extent count vs plain: {q[:60]}")
        cols3, bids, n_real, boxes, wins, kw = table.agg_launch_args(cfg)
        check(kw["extent"], "extent aggregations take the extent leg")
        dv = table.device
        targs = (dict(zip(kw["col_names"], cols3)), torch.from_numpy(bids).to(dv),
                 torch.from_numpy(boxes).to(dv), torch.from_numpy(wins).to(dv))
        flags = dict(has_boxes=kw["has_boxes"], has_windows=kw["has_windows"], extent=True)
        ref = agg.density_plain(*targs, torch.tensor(env, dtype=torch.float32, device=dv),
                                width=256, height=256, **flags).cpu().numpy()
        check(np.array_equal(grid, ref) and float(grid.sum()) > 0,
              f"extent density vs plain: {q[:60]}")
        st = agg.bounds_plain(*targs, **flags).cpu().numpy()
        check(stats == agg.reduce_bounds(st, n_real) and stats[0] >= count > 0,
              f"extent bounds vs plain: {q[:60]}")
        n += 1
    return n


def xz2_path(torch, device) -> dict:
    """The reference benchmark's configuration 3 on an XZ2 table (cut from
    200M to N_XZ2 footprints): INTERSECTS rectangle queries untraced, then
    traced, query_many, the scheduler under 8 threads, the table-level
    aggregations, and ids against an f64 brute force."""
    from concurrent.futures import ThreadPoolExecutor

    from geomesa_tpu_torch import geometry as geo
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    zero_launches()
    t_gen = time.perf_counter()
    rng = np.random.default_rng(SEED + 20)
    cities = (rng.uniform(-160, 160, 256), rng.uniform(-55, 65, 256))
    src = footprints(N_XZ2, rng, cities)
    col = geo.PackedGeometryColumn.from_boxes(*src)
    gen_s = time.perf_counter() - t_gen
    ds, ingest_s = extent_store(torch, device, "bld", "*geom:Polygon:srid=4326", "xz2",
                                {"geom": col}, N_XZ2)
    del col
    table = ds.table("bld", "xz2")
    check(table.extent and table.col_names == EXT, "the xz2 table holds the extent columns")
    warm = rect_queries(SEED + 21, N_XZ_WARMUP, cities)
    measured = rect_queries(SEED + 22, N_XZ2_MEASURED, cities)
    filters = [q for q, _ in measured]
    run_queries(ds, warm, "bld")
    lat, outs, wall = run_queries(ds, measured, "bld")
    ds.clock = clock = PhaseClock()
    _, _, traced_wall = run_queries(ds, measured, "bld")
    phases = {k: v / len(measured) * 1e3 for k, v in clock.settle().items() if not k.startswith("n.")}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))
    cand_blocks = []
    for q in filters:
        plan = ds.planner.plan("bld", q)
        check(plan.index == "xz2" and not plan.config.geom_precise,
              f"extent query plans to the xz2 scan: {q[:60]}")
        cand_blocks.append(len(table.candidate_blocks(table.candidate_spans_split(plan.config)[0])))

    with chunk_recorder() as members:
        t0 = time.perf_counter()
        many = ds.query_many("bld", filters)
        many_s = time.perf_counter() - t0
    sched = ds.serve()
    try:
        def client(k):
            futs = [sched.submit("bld", q) for q in filters[k * 5:(k + 1) * 5]]
            return [f.result(600) for f in futs]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            served = [o for outs_k in ex.map(client, range(8)) for o in outs_k]
        serve_s = time.perf_counter() - t0
    finally:
        ds.close()
    t0 = time.perf_counter()
    n_agg = check_table_aggregations(torch, ds, "bld", "xz2", busiest(measured, outs, 4))
    agg_s = time.perf_counter() - t0
    counts = [ds.count("bld", q) for q in filters[:8]]
    launches, leg_launches = read_launches(), read_leg_launches()

    for k, ((q, box), out) in enumerate(zip(measured[:8], outs)):
        ids = brute_rect_ids(src, box)
        got = np.sort(np.asarray(out.ids, np.int64))
        check(np.array_equal(got, ids), f"xz2 ids vs brute force: {q[:60]}")
        check(counts[k] == len(ids), f"xz2 count vs brute force: {q[:60]}")
    check_same_ids(many, outs, "xz2 query_many vs sequential query")
    check_same_ids(served, outs, "xz2 scheduler vs sequential query")
    hits = sum(len(o) for o in outs)
    rec = {
        "phase": "extent_path_xz2", "cell": "osm-xz2-50M", "launches": launches,
        "native": read_native(),
        "leg_launches": leg_launches, "n_features": N_XZ2, "index": "xz2",
        **({"reduced": {"n_features": {"cell": 50_000_000, "run": N_XZ2}}}
           if N_XZ2 != 50_000_000 else {}),
        "generate_s": gen_s, "ingest_s": ingest_s, "ingest_rows_per_s": N_XZ2 / ingest_s,
        "device_gb": table.nbytes_device / 1e9, "n_blocks": table.n_blocks,
        "n_queries": len(measured), "hits_total": hits,
        "candidate_blocks_mean": float(np.mean(cand_blocks)),
        "candidate_blocks_max": int(np.max(cand_blocks)),
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p84_ms": float(np.percentile(lat, 84) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "latency_mean_ms": float(lat.mean() * 1e3),
        "features_per_s": hits / wall,
        "phase_ms_per_query": phases,
        "traced_ms_per_query": traced_wall / len(measured) * 1e3,
        "device_busy_share": device_ms / (traced_wall / len(measured) * 1e3),
        "query_many_s": many_s, "query_many_queries_per_s": len(filters) / many_s,
        "chunks": len(members), "members_per_chunk": members,
        "scheduler_wall_s": serve_s, "scheduler_queries_per_s": len(served) / serve_s,
        "aggregations_s": agg_s,
        "checked_vs_brute_force": 8, "checked_query_many": len(many),
        "checked_scheduler": len(served), "checked_aggregations": n_agg,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    del ds, src, outs, many, served, table
    torch.cuda.empty_cache()
    return rec


def mixed_geometries(n, rng, cities):
    """n non-rectangle features near the cities: triangles, 5-arm stars,
    LineStrings of 2-6 vertices and, every 500th, a two-part MultiPolygon;
    20-2000 m across, one in 200 up to 0.5 degrees. Returns (port
    geometries, their parts for the brute force: (rings, polygonal) per
    feature, f64 bboxes [n, 4])."""
    from geomesa_tpu_torch import geometry as geo

    cx, cy = cities
    which = rng.integers(0, len(cx), n)
    px = np.clip(cx[which] + rng.normal(0, 0.5, n), -179, 179)
    py = np.clip(cy[which] + rng.normal(0, 0.4, n), -89, 89)
    size = rng.uniform(0.0002, 0.02, n) * np.where(rng.random(n) < 0.005, 25, 1)
    geoms, parts = [], []
    for i in range(n):
        x, y, r = px[i], py[i], size[i]
        if i % 500 == 499:
            stars = [star(x, y, r, 5, rng), star(x + 3 * r, y, r, 5, rng)]
            geoms.append(geo.MultiPolygon(stars))
            parts.append(([p.shell for p in stars], True))
        elif i % 3 == 0:
            ring = np.array([[x, y], [x + r, y], [x, y + r], [x, y]])
            geoms.append(geo.Polygon(ring))
            parts.append(([ring], True))
        elif i % 3 == 1:
            geoms.append(star(x, y, r, 5, rng))
            parts.append(([geoms[-1].shell], True))
        else:
            nv = int(rng.integers(2, 7))
            line = np.stack([x + np.cumsum(rng.normal(0, r, nv)),
                             y + np.cumsum(rng.normal(0, r, nv))], axis=1)
            geoms.append(geo.LineString(line))
            parts.append(([line], False))
    bounds = np.array([g.bounds() for g in geoms], np.float64)
    return geoms, parts, bounds


def xz3_queries(seed, n, cities, during_only: bool):
    """[(ecql, kind, query ring as parsed | None, (lo_ms, hi_ms))]: per 8
    queries 4 INTERSECTS rectangles (0.02-2 degrees), 2 INTERSECTS 5-arm
    stars (0.05-0.5 degrees), a BBOX and, with ``during_only``, a DURING
    alone (6 h or 24 h; else another rectangle); each spatial one AND dtg
    DURING 6 h - 14 d, all near a city."""
    from geomesa_tpu_torch import geometry as geo

    cx, cy = cities
    r = np.random.default_rng(seed)
    wins = time_windows(r, n, T0_MS, SPAN_MS)
    out = []
    for k in range(n):
        lo, hi = wins[k]
        c = r.integers(0, len(cx))
        qx, qy = cx[c] + r.uniform(-1, 1), cy[c] + r.uniform(-0.8, 0.8)
        kind = ("rect", "rect", "rect", "rect", "star", "star", "bbox",
                "during" if during_only else "rect")[k % 8]
        if kind == "during":
            hi = lo + int(r.choice([6, 24])) * 3_600_000
        during = f"dtg DURING {np.datetime64(lo, 'ms')}Z/{np.datetime64(hi, 'ms')}Z"
        if kind == "star":
            g = geo.from_wkt(geo.to_wkt(star(qx, qy, r.uniform(0.05, 0.5), 5, r)))
            ring = g.shell
            q = f"INTERSECTS(geom, {geo.to_wkt(g)}) AND {during}"
        elif kind == "during":
            ring, q = None, during
        else:
            qw = float(r.choice([0.02, 0.05, 0.1, 0.5, 2.0]))
            b = parsed_box(qx, qy, qx + qw, qy + qw)
            ring = np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]], [b[0], b[1]]])
            spatial = (f"INTERSECTS(geom, {rect_wkt(qx, qy, qx + qw, qy + qw)})" if kind == "rect"
                       else f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})")
            q = f"{spatial} AND {during}"
        out.append((q, kind, ring, (lo, hi)))
    return out


# an independent f64 intersects for the brute force: a vertex of one
# inside the other (even-odd), or two edges that cross or touch


def _orient(ax, ay, bx, by, cx, cy):
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def _on_segment(ax, ay, bx, by, px, py, o):
    return ((o == 0) & (np.minimum(ax, bx) <= px) & (px <= np.maximum(ax, bx))
            & (np.minimum(ay, by) <= py) & (py <= np.maximum(ay, by)))


def segments_meet(p1, p2, q1, q2) -> np.ndarray:
    """Whether segments p1-p2 and q1-q2 share a point ([..., 2] arrays,
    broadcast)."""
    a, b, c, d = (np.asarray(v, np.float64) for v in (p1, p2, q1, q2))
    d1 = _orient(c[..., 0], c[..., 1], d[..., 0], d[..., 1], a[..., 0], a[..., 1])
    d2 = _orient(c[..., 0], c[..., 1], d[..., 0], d[..., 1], b[..., 0], b[..., 1])
    d3 = _orient(a[..., 0], a[..., 1], b[..., 0], b[..., 1], c[..., 0], c[..., 1])
    d4 = _orient(a[..., 0], a[..., 1], b[..., 0], b[..., 1], d[..., 0], d[..., 1])
    proper = (((d1 > 0) & (d2 < 0)) | ((d1 < 0) & (d2 > 0))) & \
        (((d3 > 0) & (d4 < 0)) | ((d3 < 0) & (d4 > 0)))
    return (proper
            | _on_segment(c[..., 0], c[..., 1], d[..., 0], d[..., 1], a[..., 0], a[..., 1], d1)
            | _on_segment(c[..., 0], c[..., 1], d[..., 0], d[..., 1], b[..., 0], b[..., 1], d2)
            | _on_segment(a[..., 0], a[..., 1], b[..., 0], b[..., 1], c[..., 0], c[..., 1], d3)
            | _on_segment(a[..., 0], a[..., 1], b[..., 0], b[..., 1], d[..., 0], d[..., 1], d4))


def inside_rings(px, py, rings) -> np.ndarray:
    """Even-odd: points strictly inside the region the closed rings bound."""
    inside = np.zeros(np.shape(px), bool)
    for ring in rings:
        for (x0, y0), (x1, y1) in zip(ring[:-1], ring[1:]):
            if y0 == y1:
                continue
            cross = (y0 > py) != (y1 > py)
            xc = x0 + (py - y0) * (x1 - x0) / (y1 - y0)
            inside ^= cross & (px < xc)
    return inside


def feature_meets(rings, polygonal, qring) -> bool:
    """One feature (its rings, or its line) against the query ring."""
    verts = np.concatenate(rings)
    if inside_rings(verts[:, 0], verts[:, 1], [qring]).any():
        return True
    if polygonal and inside_rings(qring[:, 0], qring[:, 1], rings).any():
        return True
    q1, q2 = qring[:-1], qring[1:]
    for line in rings:
        if segments_meet(line[:-1, None], line[1:, None], q1[None], q2[None]).any():
            return True
    return False


def rects_meet_ring(boxes, qring) -> np.ndarray:
    """Rectangles [n, 4] against a query ring, vectorized over the
    rectangles."""
    x0, y0, x1, y1 = (boxes[:, k] for k in range(4))
    corners = np.stack([np.stack([x0, y0], 1), np.stack([x1, y0], 1),
                        np.stack([x1, y1], 1), np.stack([x0, y1], 1)], axis=1)  # [n, 4, 2]
    hit = inside_rings(corners[..., 0], corners[..., 1], [qring]).any(axis=1)
    qx, qy = qring[None, :, 0], qring[None, :, 1]
    hit |= ((qx > x0[:, None]) & (qx < x1[:, None]) & (qy > y0[:, None])
            & (qy < y1[:, None])).any(axis=1)
    nxt = np.roll(corners, -1, axis=1)
    hit |= segments_meet(corners[:, :, None], nxt[:, :, None], qring[None, None, :-1],
                         qring[None, None, 1:]).any(axis=(1, 2))
    return hit


def brute_xz3_ids(src, query) -> np.ndarray:
    """f64 brute force of one XZ3 query: the window, then rectangles by box
    algebra (rectangle queries) or the general test (stars), other
    features by the general test."""
    rect_boxes, parts, other_bounds, t = src
    _, kind, qring, (lo, hi) = query
    tm = (t >= lo) & (t < hi)
    n_rect = len(rect_boxes[0])
    if qring is None:
        return np.flatnonzero(tm)
    qb = (qring[:, 0].min(), qring[:, 1].min(), qring[:, 0].max(), qring[:, 1].max())
    rect_ids = brute_rect_ids(rect_boxes, qb)
    rect_ids = rect_ids[tm[rect_ids]]
    if kind == "star":
        boxes = np.stack([b[rect_ids] for b in rect_boxes], axis=1)
        rect_ids = rect_ids[rects_meet_ring(boxes, qring)]
    ob = other_bounds
    cand = np.flatnonzero((ob[:, 0] <= qb[2]) & (ob[:, 2] >= qb[0]) & (ob[:, 1] <= qb[3])
                          & (ob[:, 3] >= qb[1]) & tm[n_rect:])
    other_ids = [n_rect + j for j in cand if feature_meets(*parts[j], qring)]
    return np.concatenate([rect_ids, np.array(other_ids, np.int64)])


def xz3_path(torch, device) -> dict:
    """An XZ3 table of N_XZ3 extent features with dates over 120 days:
    building-footprint rectangles and 1 % triangles, stars, LineStrings and
    MultiPolygons. INTERSECTS (rectangles, stars) and BBOX queries AND
    DURING, and DURING alone, untraced then traced, then query_many; ids
    against an f64 brute force."""
    from geomesa_tpu_torch import geometry as geo
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    zero_launches()
    t_gen = time.perf_counter()
    rng = np.random.default_rng(SEED + 50)
    cities = (rng.uniform(-160, 160, 256), rng.uniform(-55, 65, 256))
    n_rect = N_XZ3 - N_XZ3_OTHER
    rects = footprints(n_rect, rng, cities)
    geoms, parts, other_bounds = mixed_geometries(N_XZ3_OTHER, rng, cities)
    t = T0_MS + rng.integers(0, SPAN_MS, N_XZ3)
    col = geo.PackedGeometryColumn.concat([geo.PackedGeometryColumn.from_boxes(*rects),
                                           geo.PackedGeometryColumn.from_geometries(geoms)])
    del geoms
    gen_s = time.perf_counter() - t_gen
    ds, ingest_s = extent_store(torch, device, "ext", "dtg:Date,*geom:Geometry:srid=4326",
                                "xz3", {"geom": col, "dtg": t}, N_XZ3)
    del col
    table = ds.table("ext", "xz3")
    check(table.extent and table.col_names == tuple(sorted(EXT + ("tbin", "toff"))),
          "the xz3 table holds the extent and time columns")
    src = (rects, parts, other_bounds, t)
    warm = xz3_queries(SEED + 51, N_XZ_WARMUP, cities, during_only=False)
    measured = xz3_queries(SEED + 52, N_XZ3_MEASURED, cities, during_only=True)
    filters = [q for q, *_ in measured]
    run_queries(ds, warm, "ext")
    lat, outs, wall = run_queries(ds, measured, "ext")
    ds.clock = clock = PhaseClock()
    _, _, traced_wall = run_queries(ds, measured, "ext")
    phases = {k: v / len(measured) * 1e3 for k, v in clock.settle().items() if not k.startswith("n.")}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))
    cand_blocks = []
    for q in filters:
        plan = ds.planner.plan("ext", q)
        check(plan.index == "xz3", f"extent query plans to the xz3 scan: {q[:60]}")
        cand_blocks.append(len(table.candidate_blocks(table.candidate_spans_split(plan.config)[0])))
    with chunk_recorder() as members:
        t0 = time.perf_counter()
        many = ds.query_many("ext", filters)
        many_s = time.perf_counter() - t0
    launches, leg_launches = read_launches(), read_leg_launches()

    # the checked queries: the first of each kind, then the next ones
    kinds = [m[1] for m in measured]
    checked = sorted({kinds.index(k) for k in set(kinds)} | set(range(8)))[:8]
    t0 = time.perf_counter()
    for k in checked:
        ids = np.sort(brute_xz3_ids(src, measured[k]))
        got = np.sort(np.asarray(outs[k].ids, np.int64))
        check(np.array_equal(got, ids), f"xz3 ids vs brute force ({kinds[k]}): {filters[k][:60]}")
    brute_s = time.perf_counter() - t0
    check_same_ids(many, outs, "xz3 query_many vs sequential query")
    hits = sum(len(o) for o in outs)
    rec = {
        "phase": "extent_path_xz3", "cell": "xz3-10M-mixed", "launches": launches,
        "native": read_native(),
        "leg_launches": leg_launches, "n_features": N_XZ3, "n_non_rectangles": N_XZ3_OTHER,
        "index": "xz3", "generate_s": gen_s, "ingest_s": ingest_s,
        "ingest_rows_per_s": N_XZ3 / ingest_s, "device_gb": table.nbytes_device / 1e9,
        "n_blocks": table.n_blocks, "n_queries": len(measured), "hits_total": hits,
        "query_kinds": {kd: kinds.count(kd) for kd in sorted(set(kinds))},
        "candidate_blocks_mean": float(np.mean(cand_blocks)),
        "candidate_blocks_max": int(np.max(cand_blocks)),
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p84_ms": float(np.percentile(lat, 84) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "latency_mean_ms": float(lat.mean() * 1e3),
        "features_per_s": hits / wall,
        "phase_ms_per_query": phases,
        "traced_ms_per_query": traced_wall / len(measured) * 1e3,
        "device_busy_share": device_ms / (traced_wall / len(measured) * 1e3),
        "query_many_s": many_s, "query_many_queries_per_s": len(filters) / many_s,
        "chunks": len(members), "members_per_chunk": members,
        "checked_vs_brute_force": len(checked),
        "checked_kinds": sorted({kinds[k] for k in checked}), "brute_force_s": brute_s,
        "checked_query_many": len(many),
    }
    del ds, src, outs, many, table
    torch.cuda.empty_cache()
    return rec


# -- the query controls on the main store ----------------------------------

N_HINT_QUERIES = 16
HINT_PAGE = 1_000
HINT_SLOW_MS = 1.0  # the slow-query log's threshold while the path traces
GENEROUS_TIMEOUT_S = 3600.0


def hint_queries(outs, n) -> list:
    """Indexes of the n measured queries with the fewest hits past one
    page (each pages at least twice), topped up with the largest results
    under a page."""
    hits = np.array([len(o) for o in outs])
    order = np.argsort(hits, kind="stable")
    pick = [int(i) for i in order if hits[i] > HINT_PAGE][:n]
    small = [int(i) for i in order[::-1] if 0 < hits[i] <= HINT_PAGE]
    return pick + small[: n - len(pick)]


def sorted_ids(col, ids, desc: bool) -> np.ndarray:
    """``ids`` (in the query's order) stably sorted by ``col[ids]``, the
    reference's tie rule: equal values keep the query's order, ascending
    or descending (``FeatureCollection.sort_values``)."""
    v = col[ids]
    if desc:
        order = np.argsort(-np.unique(v, return_inverse=True)[1], kind="stable")
    else:
        order = np.argsort(v, kind="stable")
    return ids[order]


def wide_plane_ids(torch, ds, q) -> np.ndarray:
    """The rows K1's plain version marks in the wide plane over the query's
    candidate blocks, with the contained spans' rows, in table order: the
    answer the ``loose`` hint accepts."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    table = ds.table("gdelt", "z3")
    cfg = ds.planner.plan("gdelt", q).config
    overlap, contained = table.candidate_spans_split(cfg)
    rows = np.concatenate([np.arange(a, z, dtype=np.int64) for a, z in contained]) \
        if contained else np.zeros(0, np.int64)
    blocks = table.candidate_blocks(overlap)
    if len(blocks):
        bids, n_real = bk.pad_bids(table._full_or(blocks), table.n_blocks)
        boxes, wins = table._params(cfg)
        names = table._scan_cols(cfg)
        kw = table._scan_kernel_kwargs(cfg, names)
        dv = table.device
        wide, _ = bk.block_scan_plain(
            dict(zip(names, table._cols_args(names))), torch.from_numpy(bids).to(dv),
            torch.from_numpy(boxes).to(dv), torch.from_numpy(wins).to(dv),
            has_boxes=kw["has_boxes"], has_windows=kw["has_windows"], extent=kw["extent"],
        )
        wide_rows, _ = bk.decode_bits_pair(wide.cpu().numpy(), None, bids, n_real)
        rows = np.union1d(rows, wide_rows)
    return table.perm[rows].astype(np.int64)


def union_query(q, ids) -> str:
    """An id lookup OR a box-and-window query: on a store with a Z3 index
    alone no single index serves it, so it plans as a union."""
    return "IN (" + ", ".join(f"'{i}'" for i in ids) + f") OR ({q})"


def hints_path(torch, ds, src, measured, outs, main_lat, clock_phases) -> dict:
    """The query controls on the main path's store (no new table): sort and
    offset pages, sample and stratified sample, transforms, reprojection,
    ``loose``, timeouts (single query, ``query_many``, a union), guards,
    and the observability core (metrics, audit, tracing). Launch counts
    zeroed before, read after; every check raises."""
    from bisect import bisect_left

    from geomesa_tpu_torch import conf
    from geomesa_tpu_torch.audit import AuditWriter
    from geomesa_tpu_torch.crs import MAX_LAT_3857
    from geomesa_tpu_torch.metrics import HIST_EDGES, MetricsRegistry
    from geomesa_tpu_torch.obs import trace as otrace
    from geomesa_tpu_torch.planning.errors import QueryGuardError, QueryTimeout
    from geomesa_tpu_torch.planning.guards import TemporalQueryGuard
    from geomesa_tpu_torch.planning.hints import QueryHints
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    x, y, t = src
    picks = hint_queries(outs, N_HINT_QUERIES)
    chosen = [measured[i] for i in picks]
    exact = [np.asarray(outs[i].ids, np.int64) for i in picks]
    filters = [q for q, _ in chosen]
    check(len(chosen) == N_HINT_QUERIES, "the hints path has its queries")
    zero_launches()
    t_path = time.perf_counter()

    # sort, and offset pages under a limit
    bases, sorted_by = [], []
    n_pages = 0
    for (q, box), got0 in zip(chosen, exact):
        base = expected_order(ds, "z3", brute_ids(src, box))
        check(np.array_equal(got0, base), f"exact ids vs the f64 brute force in (bin, z) order: {q}")
        bases.append(base)
        for key in ("dtg", "-dtg"):
            want = sorted_ids(t, base, key.startswith("-"))
            got = np.asarray(ds.query("gdelt", q, hints=QueryHints(sort_by=key)).ids, np.int64)
            check(np.array_equal(got, want), f"sort_by={key} vs the sorted brute force: {q}")
            pages = [np.zeros(0, np.int64)]
            for off in range(0, len(want), HINT_PAGE):
                page = ds.query("gdelt", q, limit=HINT_PAGE, hints=QueryHints(sort_by=key, offset=off))
                pages.append(np.asarray(page.ids, np.int64))
                n_pages += 1
            check(np.array_equal(np.concatenate(pages), want),
                  f"pages of {HINT_PAGE} ({key}) concatenate to the sorted result: {q}")
            if key == "-dtg":
                sorted_by.append(want)
    # the same hints through query_many (fused on K2), one per query
    many = ds.query_many("gdelt", filters, hints=[QueryHints(sort_by="-dtg")] * len(filters))
    for q, m, want in zip(filters, many, sorted_by):
        check(np.array_equal(np.asarray(m.ids, np.int64), want), f"query_many sort_by=-dtg: {q}")

    # sample: the port's own FeatureCollection.sample of the exact result
    n_sampled = 0
    for q in filters:
        whole = ds.query("gdelt", q)
        for kw in ({"sample": 0.1}, {"sample": 0.1, "sample_by": "EventRootCode"}):
            got = np.asarray(ds.query("gdelt", q, hints=QueryHints(**kw)).ids, np.int64)
            want = np.asarray(whole.sample(kw["sample"], kw.get("sample_by")).ids, np.int64)
            again = np.asarray(ds.query("gdelt", q, hints=QueryHints(**kw)).ids, np.int64)
            check(np.array_equal(got, want) and np.array_equal(got, again),
                  f"sample {kw} equals FeatureCollection.sample, deterministically: {q}")
            check(len(got) < len(whole) or len(whole) < 10, f"sample {kw} drops rows: {q}")
            n_sampled += len(got)

    # transforms and reprojection against the source columns
    r = 6378137.0
    reproj_err = 0.0
    for q, base in zip(filters, bases):
        got = ds.query("gdelt", q, hints=QueryHints(transforms=["dtg", "lon=st_x(geom)", "lat=st_y(geom)"]))
        ids = np.asarray(got.ids, np.int64)
        check(np.array_equal(ids, base) and list(got.columns) == ["dtg", "lon", "lat"],
              f"transforms keep the ids and name the columns: {q}")
        check(np.array_equal(got.columns["dtg"], t[ids]) and np.array_equal(got.columns["lon"], x[ids])
              and np.array_equal(got.columns["lat"], y[ids]), f"transformed columns vs brute force: {q}")
        got = ds.query("gdelt", q, hints=QueryHints(reproject="EPSG:3857"))
        ids = np.asarray(got.ids, np.int64)
        check(np.array_equal(ids, base), f"reproject keeps the ids: {q}")
        ex = r * np.radians(x[ids])
        ey = r * np.log(np.tan(np.pi / 4.0 + np.radians(np.clip(y[ids], -MAX_LAT_3857, MAX_LAT_3857)) / 2.0))
        col = got.geom_column
        err = float(max(np.abs(col.x - ex).max(initial=0.0), np.abs(col.y - ey).max(initial=0.0)))
        check(err <= 1e-6, f"EPSG:3857 coordinates within 1e-6 m of the f64 formula ({err}): {q}")
        reproj_err = max(reproj_err, err)

    # loose: K1's wide plane is the answer, nothing refines
    exact_lat, loose_lat, extra = [], [], 0
    for q, base in zip(filters, bases):
        s = time.perf_counter()
        ds.query("gdelt", q)
        exact_lat.append(time.perf_counter() - s)
        s = time.perf_counter()
        got = ds.query("gdelt", q, hints=QueryHints(loose=True))
        loose_lat.append(time.perf_counter() - s)
        ids = np.asarray(got.ids, np.int64)
        check(set(base.tolist()) <= set(ids.tolist()), f"loose ids include the exact ids: {q}")
        check(np.array_equal(ids, wide_plane_ids(torch, ds, q)), f"loose ids are K1's wide plane: {q}")
        extra += len(ids) - len(base)
    ds.clock = clock = PhaseClock()
    for q in filters:
        ds.query("gdelt", q, hints=QueryHints(loose=True))
    loose_phases = {k: v / len(filters) * 1e3 for k, v in clock.settle().items() if not k.startswith("n.")}
    ds.clock = NULL_CLOCK
    check(loose_phases.get("refine", 0.0) == 0.0, "loose queries spend no time refining")

    # timeouts: a single query, query_many, a union; each raise counted
    ds.metrics = metrics = MetricsRegistry()
    tiny = QueryHints(timeout=1e-6)
    uq = union_query(filters[0], bases[0][:2].tolist() + [bases[-1][0]])
    check(ds.planner.plan("gdelt", uq).union is not None, "the id-or-box query plans as a union")
    for what, call in (("query", lambda: ds.query("gdelt", filters[0], hints=tiny)),
                       ("query_many", lambda: ds.query_many("gdelt", filters, hints=tiny)),
                       ("union", lambda: ds.query("gdelt", uq, hints=tiny))):
        try:
            call()
        except QueryTimeout:
            continue
        check(False, f"timeout=1e-6 raises QueryTimeout on {what}")
    check(metrics.counter_value("geomesa.query.timeout") == 3, "geomesa.query.timeout counts each raise")
    after = np.asarray(ds.query("gdelt", filters[0]).ids, np.int64)
    check(np.array_equal(after, bases[0]), "the query after a timeout is exact")
    uout = np.asarray(ds.query("gdelt", uq).ids, np.int64)
    check(set(uout.tolist()) == set(bases[0].tolist()) | {int(bases[-1][0])}, "the union's ids")
    ds.query_timeout = GENEROUS_TIMEOUT_S
    for q, base in zip(filters, bases):
        check(np.array_equal(np.asarray(ds.query("gdelt", q).ids, np.int64), base),
              f"a generous store timeout answers as before: {q}")
    ds.query_timeout = None

    # guards
    full_q = "EventRootCode = '14'"
    check(ds.planner.plan("gdelt", full_q).strategy == "full-scan", "the attribute filter plans full-scan")
    ds.block_full_table_scans = True
    try:
        ds.query("gdelt", full_q)
        check(False, "block_full_table_scans rejects a full-table scan")
    except QueryGuardError:
        pass
    check(ds.planner.plan("gdelt", "INCLUDE").strategy == "full-scan", "INCLUDE passes the guard")
    ds.block_full_table_scans = False
    ds.guards = [TemporalQueryGuard(max_ms=7 * 86_400_000)]
    long_q = [q for q, (*_, lo, hi) in measured if hi - lo > 7 * 86_400_000]
    short_q = [q for q, (*_, lo, hi) in chosen if hi - lo <= 7 * 86_400_000]
    check(bool(long_q) and bool(short_q), "the measured set has windows on both sides of a week")
    try:
        ds.planner.plan("gdelt", long_q[0])
        check(False, "TemporalQueryGuard rejects a window longer than its limit")
    except QueryGuardError:
        pass
    ds.planner.plan("gdelt", short_q[0])
    ds.guards = []

    # metrics and audit over the main path's 64 queries
    ds.metrics = metrics = MetricsRegistry()
    ds.audit = audit = AuditWriter()
    exec_lat, hits = [], []
    for q, _ in measured:
        plan = ds.planner.plan("gdelt", q)
        s = time.perf_counter()
        hits.append(len(ds.planner.execute(plan)))
        exec_lat.append(time.perf_counter() - s)
    check(metrics.counter_value("geomesa.query.count") == len(measured), "geomesa.query.count")
    check(metrics.counter_value("geomesa.query.hits") == sum(len(o) for o in outs) == sum(hits),
          "geomesa.query.hits equals the main path's hits")
    reg_p50 = metrics.histogram_quantile("geomesa.query.scan", 0.5)
    own_p50 = float(np.percentile(exec_lat, 50))
    check(abs(bisect_left(HIST_EDGES, reg_p50) - bisect_left(HIST_EDGES, own_p50)) <= 1,
          f"scan histogram p50 {reg_p50} within a bucket of the measured {own_p50}")
    events = audit.drain()
    check(len(events) == len(measured) and [e["hits"] for e in events] == hits,
          "one audited event per query, with its hits")
    ds.metrics = ds.audit = None

    # tracing: the same 64 queries untraced, then traced
    lat_untraced, _, _ = run_queries(ds, measured)
    conf.OBS_TRACE_SAMPLE.set(1)
    conf.OBS_SLOW_MS.set(HINT_SLOW_MS)
    tr = otrace.install(otrace.Tracer())
    try:
        lat_traced, _, _ = run_queries(ds, measured)
        with tempfile.TemporaryDirectory() as out_dir:
            with open(ds.dump_trace(os.path.join(out_dir, "hints_trace.json"))) as fh:
                events = json.load(fh)["traceEvents"]
        traces = tr.traces()
        slow = ds.slow_queries("gdelt")
    finally:
        conf.OBS_TRACE_SAMPLE.set(0)
        conf.OBS_SLOW_MS.set(0)
        otrace.install(otrace.Tracer())
    by_trace: dict = {}
    for ev in events:
        check(set(ev) == {"name", "ph", "pid", "tid", "ts", "dur", "args"} and ev["ph"] == "X",
              "Chrome trace events")
        by_trace.setdefault(ev["pid"], set()).add(ev["name"])
    queries_traced = [names for names in by_trace.values() if "query" in names]
    check(len(traces) == len(measured) and len(queries_traced) == len(measured),
          "one retained trace per query")
    for names in queries_traced:
        check({"plan", "dispatch", "scan", "decode"} <= names, f"a query's spans: {sorted(names)}")
    check(len(slow) > 0, "the slow-query ring holds entries")
    phase_ms: dict = {}
    for trc in traces:
        for sp in trc.phases():
            phase_ms[sp.name] = phase_ms.get(sp.name, 0.0) + sp.dur_s * 1e3 / len(traces)
    launches = read_launches()
    return {
        "phase": "hints_path", "cell": "gdelt-z3-100M-hints", "launches": launches,
        "native": read_native(), "n_queries": len(chosen),
        "hits": [len(b) for b in bases], "pages": n_pages, "sampled_rows": n_sampled,
        "reproject_max_err_m": reproj_err,
        "exact_p50_ms": float(np.percentile(exact_lat, 50) * 1e3),
        "loose_p50_ms": float(np.percentile(loose_lat, 50) * 1e3),
        "loose_extra_rows": int(extra), "loose_phase_ms_per_query": loose_phases,
        "timeouts_counted": 3,
        "registry_scan_p50_ms": reg_p50 * 1e3, "measured_execute_p50_ms": own_p50 * 1e3,
        "audited_events": len(measured),
        "main_p50_ms": float(np.percentile(main_lat, 50) * 1e3),
        "untraced_p50_ms": float(np.percentile(lat_untraced, 50) * 1e3),
        "traced_p50_ms": float(np.percentile(lat_traced, 50) * 1e3),
        "trace_phase_ms_per_query": phase_ms, "phaseclock_ms_per_query": clock_phases,
        "slow_queries": len(slow), "trace_events": len(events),
        "wall_s": time.perf_counter() - t_path,
    }


def main_path(torch, device):
    """Twenty-four paths, each with its own launch and native call counts
    (zeroed just before it runs, read just after): the single-query main
    path, the batch path, the polygon path and the query controls on the
    same store, the
    packed-time cell, the Z2 polygon cell, the two extent cells (XZ2,
    XZ3), the tiered store with its union queries, the mutated store, the
    attribute-indexed store, the saved and loaded store, the secure,
    cached event store, the served store behind the scheduler and the
    ops plane, the streaming tier, standing queries, replication, the
    pipelined bulk loader with file ingest and export, the analytics
    tier (kNN, joins, the tile pyramid, SQL, processes), the HTTP data
    plane, the S2 and S3 indexes, the tuning tier with the CLI, the pod
    tier, and the measurement drivers of geomesa_tpu_torch/scripts/. Each
    path from the XZ2 cell on carries its wall as ``wall_s``."""
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    zero_launches()
    ds, src, ingest_s = build_store(torch, device, N_MAIN, packed=False, with_root_code=True)
    table = ds.table("gdelt", "z3")
    warm = query_set(SEED + 1, N_WARMUP)
    measured = query_set(SEED + 2, N_MEASURED)
    run_queries(ds, warm)
    with scan_m_recorder() as scans:
        lat, outs, wall = run_queries(ds, measured)  # untraced: the end-to-end numbers
    check(len(scans) > 0, "the main path's queries launched K1")
    # a second, traced pass over the same queries splits the time by phase
    ds.clock = clock = PhaseClock()
    _, _, traced_wall = run_queries(ds, measured)
    phases = {k: v / len(measured) * 1e3 for k, v in clock.settle().items() if not k.startswith("n.")}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))
    hits = sum(len(o) for o in outs)
    n_brute = check_queries(ds, src, measured, outs, 8)
    n_agg = check_aggregations(torch, ds, busiest(measured, outs, 4))
    launches = read_launches()
    rec = {
        "phase": "main_path", "cell": "gdelt-z3-100M", "launches": launches,
        "native": read_native(),
        "n_points": N_MAIN, "index": "z3",
        "ingest_s": ingest_s, "ingest_rows_per_s": N_MAIN / ingest_s,
        "device_gb": table.nbytes_device / 1e9,
        "n_blocks": table.n_blocks, "n_queries": len(measured), "hits_total": hits,
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p84_ms": float(np.percentile(lat, 84) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "latency_mean_ms": float(lat.mean() * 1e3),
        "features_per_s": hits / wall,
        "phase_ms_per_query": phases,
        "traced_ms_per_query": traced_wall / len(measured) * 1e3,
        "device_busy_share": device_ms / (traced_wall / len(measured) * 1e3),
        "checked_vs_brute_force": n_brute, "checked_aggregations": n_agg,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        # the shapes K1 runs at on this path, per measured query's scan
        "k1_candidate_m": {"scans": len(scans), "m": m_summary([m for m, _ in scans]),
                           "real_blocks": m_summary([r for _, r in scans])},
    }
    batch = batch_path(torch, ds, measured, outs, wall)
    centres = cluster_centres(SEED)
    poly = polygon_path(
        torch, ds, src, "z3", polygon_query_set(SEED + 21, N_POLY_WARMUP, centres, True, False),
        polygon_query_set(SEED + 22, N_POLY_MEASURED, centres, True, True),
        n_brute=8, n_settings=16, n_agg=4, n_full_scan=2,
    )
    poly = {"phase": "polygon_path", "cell": "gdelt-z3-100M-polygon", **poly}
    hints = hints_path(torch, ds, src, measured, outs, lat, phases)
    del ds, src, outs, table
    torch.cuda.empty_cache()

    zero_launches()
    ds, src, ingest_s = build_store(torch, device, N_PACKED, packed=True)
    table = ds.table("gdelt", "z3")
    check(table.col_names == ("tw", "x", "y"), "packed-time table holds tw")
    queries = query_set(SEED + 3, N_PACKED_QUERIES)
    lat, outs, wall = run_queries(ds, queries)
    n_brute = check_queries(ds, src, queries, outs, 4)
    n_agg = check_aggregations(torch, ds, busiest(queries, outs, 2))
    many = ds.query_many("gdelt", [q for q, _ in queries])
    counted = busiest(queries, outs, 2)
    estimates = count_estimates(ds, counted)
    launches = read_launches()
    check_same_ids(many, outs, "packed query_many vs sequential query")
    exact = {q: o for (q, _), o in zip(queries, outs)}
    n_counts = check_counts(torch, ds, counted, [exact[q] for q, _ in counted], estimates)
    packed = {
        "phase": "main_path_packed_time", "cell": "gdelt-z3-packed-10M",
        "launches": launches, "native": read_native(), "n_points": N_PACKED,
        "ingest_s": ingest_s, "device_gb": table.nbytes_device / 1e9,
        "n_queries": len(queries), "hits_total": sum(len(o) for o in outs),
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "features_per_s": sum(len(o) for o in outs) / wall,
        "checked_vs_brute_force": n_brute, "checked_aggregations": n_agg,
        "checked_query_many": len(many), "checked_counts": n_counts,
    }
    del ds, src, outs, table, many
    torch.cuda.empty_cache()

    zero_launches()
    ds, src, ingest_s = build_store(torch, device, N_Z2, index="z2", seed=SEED + 30)
    ingest_native = read_native()  # polygon_path zeroes the counts again
    centres = cluster_centres(SEED + 30)
    z2 = polygon_path(
        torch, ds, src, "z2", polygon_query_set(SEED + 31, 4, centres, False, False),
        polygon_query_set(SEED + 32, N_Z2_POLY_QUERIES, centres, False, True),
        n_brute=4, n_settings=8, n_agg=2, n_full_scan=1,
    )
    z2 = {"phase": "polygon_path_z2", "cell": "gdelt-z2-20M-polygon", "ingest_s": ingest_s,
          "native_ingest": ingest_native,
          "device_gb": ds.table("gdelt", "z2").nbytes_device / 1e9, **z2}
    del ds, src
    torch.cuda.empty_cache()
    records = [rec, batch, poly, hints, packed, z2]
    for path in (xz2_path, xz3_path, tiered_union_path, mutation_path, attribute_path,
                 persist_path, secure_cached_path, served_path, stream_path, standing_path,
                 replica_path, ingest_path, analytics_path, serve_http_path, s2_path,
                 drift_path, pod_path, scripts_path, examples_path):
        t0 = time.perf_counter()
        records.append(path(torch, device))
        records[-1]["wall_s"] = time.perf_counter() - t0
    return tuple(records)


# -- the delta tier and union plans ----------------------------------------

N_TIERED = 10_000_000
N_APPEND = 1_000_000  # each of the two later writes
N_TIERED_QUERIES = 8
N_UNION_QUERIES = 4
RECENT_MS = 21 * 86_400_000  # the appended rows' times: the span's last 21 days


def wide_rows(cfg, cols) -> np.ndarray:
    """The kernels' wide predicate over host key columns, written out: any
    f32 box slot and any (bin, offset) window slot, bounds inclusive."""
    x, y = cols["x"], cols["y"]
    box = np.zeros(len(x), bool)
    for x0, y0, x1, y1 in np.asarray(cfg.boxes, np.float32):
        box |= (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    win = np.zeros(len(x), bool)
    for b, lo, hi in np.asarray(cfg.windows, np.int64):
        win |= (cols["tbin"] == b) & (cols["toff"] >= lo) & (cols["toff"] <= hi)
    return box & win


def check_tiered_query(torch, ds, q, box, main_ids, src, out) -> None:
    """One BBOX + DURING query on a store whose rows past N_TIERED sit in
    the delta tier: ids in order are the main table's ids, then the
    delta's f64 brute-force hits in write order; a limit is the prefix;
    count, both bounds, the count estimate and the density grid equal the
    brute force over the delta added to the plain versions over the main
    table."""
    from geomesa_tpu_torch.scan import aggregations as agg

    x, y, t = src
    lo, hi = N_TIERED, ds.row_count("gdelt")
    delta = lo + brute_ids((x[lo:hi], y[lo:hi], t[lo:hi]), box)
    expect = np.concatenate([main_ids, delta])
    ids = np.asarray(out.ids, np.int64)
    check(np.array_equal(ids, expect), f"tiered ids in order: {q}")
    check(np.array_equal(np.asarray(ds.query("gdelt", q, limit=7).ids, np.int64), expect[:7]),
          f"tiered limit 7: {q}")
    check(ds.count("gdelt", q) == len(expect), f"tiered count: {q}")
    if len(expect):
        env = (float(x[expect].min()), float(y[expect].min()),
               float(x[expect].max()), float(y[expect].max()))
        check(ds.bounds("gdelt", q, estimate=False) == env, f"tiered exact bounds: {q}")
    tiered = ds.table("gdelt", "z3")
    cfg = ds.planner.plan("gdelt", q).config
    dcols = tiered.delta.device_cols
    wide = np.flatnonzero(wide_rows(cfg, dcols))
    with plain_pops(torch):
        main_count = tiered.main.count(cfg)
    est = ds.stats_query("gdelt", "Count()", q, estimate=True)[0].count
    check(est == main_count + len(wide), f"tiered count estimate: {q}")
    envelope = box[:4]
    args = tiered.main.agg_launch_args(cfg)
    env_main, ref = None, np.zeros((256, 256), np.float32)
    if args is not None:  # the main table has candidate blocks
        cols3, bids, n_real, boxes, wins, kw = args
        dv = tiered.main.device
        targs = (dict(zip(kw["col_names"], cols3)), torch.from_numpy(bids).to(dv),
                 torch.from_numpy(boxes).to(dv), torch.from_numpy(wins).to(dv))
        flags = dict(has_boxes=kw["has_boxes"], has_windows=kw["has_windows"])
        st = agg.bounds_plain(*targs, **flags).cpu().numpy()
        env_main = agg.reduce_bounds(st, n_real)[1]
        ref = agg.density_plain(*targs, torch.tensor(envelope, dtype=torch.float32, device=dv),
                                width=256, height=256, **flags).cpu().numpy()
    dx, dy = dcols["x"][wide], dcols["y"][wide]
    env_est = env_main
    if len(wide):
        denv = (float(dx.min()), float(dy.min()), float(dx.max()), float(dy.max()))
        env_est = denv if env_main is None else (
            min(env_main[0], denv[0]), min(env_main[1], denv[1]),
            max(env_main[2], denv[2]), max(env_main[3], denv[3]))
    check(ds.bounds("gdelt", q, estimate=True) == env_est, f"tiered bounds estimate: {q}")
    grid = ds.density("gdelt", q, envelope=envelope, width=256, height=256)
    ref = ref + host_density(dx, dy, envelope, 256, 256)
    check(np.array_equal(grid, ref), f"tiered density: {q}")


def tiered_union_path(torch, device) -> dict:
    """gdelt-z3-10M-tiered: a 10M-row GDELT-shaped point store (Z3 and Z2)
    takes two hourly-load-sized appends of 1M rows with recent times. The
    first stays in the delta tier (1M <= max(262,144, 11M // 8)): 8 BBOX +
    DURING queries (4 of them on the recent days) are checked as
    ``check_tiered_query`` says, and ``query_many`` over them and 8 more
    against the sequential queries. The
    second crosses the threshold and compacts: ids in order must equal a
    store written once with all 12M rows, with the appended rows ahead of
    the main table's where their (bin, z) keys tie. Then 4 ``BBOX OR dtg DURING``
    queries plan as unions: ids in order are the box branch's ids, then
    the window branch's ids not yet seen, both branches equal to an f64
    brute force, and ``limit=7`` the prefix. Launch counts are zeroed
    before and read after."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch.storage.delta import TieredTable
    from geomesa_tpu_torch.storage.table import IndexTable
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    zero_launches()
    rng = np.random.default_rng(SEED + 40)
    n_all = N_TIERED + 2 * N_APPEND
    x, y = gdelt_points(n_all, rng)
    perm = rng.permutation(n_all)  # clustered and uniform rows in every write
    x, y = x[perm], y[perm]
    t = np.concatenate([
        T0_MS + rng.integers(0, SPAN_MS, N_TIERED),
        T0_MS + SPAN_MS - RECENT_MS + rng.integers(0, RECENT_MS, 2 * N_APPEND),
    ])
    src = (x, y, t)
    sft = FeatureType.from_spec("gdelt", "dtg:Date,*geom:Point:srid=4326")

    def store():
        ds = DataStore(device=device)
        ds.create_schema(sft)
        return ds

    def write(ds, lo, hi) -> float:
        fc = FeatureCollection.from_columns(
            sft, np.arange(lo, hi), {"dtg": t[lo:hi], "geom": (x[lo:hi], y[lo:hi])})
        t_in = time.perf_counter()
        ds.write("gdelt", fc, check_ids=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t_in

    ds = store()
    ingest_s = write(ds, 0, N_TIERED)
    half = N_TIERED_QUERIES // 2
    queries = (query_set(SEED + 41, half, T0_MS + SPAN_MS - RECENT_MS, RECENT_MS)
               + query_set(SEED + 42, N_TIERED_QUERIES - half))
    main_ids = [np.asarray(ds.query("gdelt", q).ids, np.int64) for q, _ in queries]
    lat_main, _, _ = run_queries(ds, queries)
    append_s = write(ds, N_TIERED, N_TIERED + N_APPEND)
    check(isinstance(ds.table("gdelt", "z3"), TieredTable)
          and isinstance(ds.table("gdelt", "z2"), TieredTable), "the first append stays in the delta")
    lat_tiered, outs, _ = run_queries(ds, queries)
    ds.clock = clock = PhaseClock()
    run_queries(ds, queries)
    phases = {k: v / len(queries) * 1e3 for k, v in clock.settle().items() if not k.startswith("n.")}
    ds.clock = NULL_CLOCK
    t_chk = time.perf_counter()
    for (q, box), ids, out in zip(queries, main_ids, outs):
        check_tiered_query(torch, ds, q, box, ids, src, out)
    # 8 more queries: a batch of more than 8 fuses into K2's chunks
    batch = [q for q, _ in queries + query_set(SEED + 45, N_TIERED_QUERIES)]
    many = ds.query_many("gdelt", batch)
    seq = outs + [ds.query("gdelt", q) for q in batch[len(outs):]]
    check(all(np.array_equal(np.asarray(a.ids), np.asarray(b.ids)) for a, b in zip(many, seq))
          and len(many) == len(seq), "tiered query_many vs sequential, in order")
    check_s = time.perf_counter() - t_chk
    delta_hits = sum(int((np.asarray(o.ids) >= N_TIERED).sum()) for o in outs)
    check(delta_hits > 0, "the checked queries see delta rows")

    compact_s = write(ds, N_TIERED + N_APPEND, n_all)
    check(isinstance(ds.table("gdelt", "z3"), IndexTable)
          and ds.row_count("gdelt") == n_all, "the second append compacts")
    lat_compacted, outs, _ = run_queries(ds, queries)
    once = store()
    once_s = write(once, 0, n_all)
    z3 = next(i for i in once.indexes("gdelt") if i.name == "z3")
    ties = 0
    for (q, _), out in zip(queries, outs):
        ref = np.asarray(once.query("gdelt", q).ids, np.int64)
        # one write orders rows of an equal (bin, z) key by id; the
        # reference's compaction puts the appended rows ahead of the main
        # table's there, in write order
        keys = z3.write_keys(FeatureCollection.from_columns(
            sft, ref, {"dtg": t[ref], "geom": (x[ref], y[ref])}))
        order = np.lexsort((ref < N_TIERED, keys.zs, keys.bins))
        ties += int((order != np.arange(len(ref))).sum())
        check(np.array_equal(np.asarray(out.ids, np.int64), ref[order]),
              f"compacted ids in order vs one write, appended rows first on a tie: {q}")
    del once
    torch.cuda.empty_cache()

    r = np.random.default_rng(SEED + 43)
    boxes = box_queries(r, N_UNION_QUERIES)
    r_wins = np.random.default_rng(SEED + 44)
    union_lat, union_hits = [], 0
    for (x0, y0, x1, y1) in boxes:
        dur = int(r_wins.choice([6, 24, 72])) * 3600_000
        lo = int(T0_MS + r_wins.integers(0, SPAN_MS - dur))
        bq = f"bbox(geom, {x0:.4f}, {y0:.4f}, {x1:.4f}, {y1:.4f})"
        wq = f"dtg DURING {np.datetime64(lo, 'ms')}Z/{np.datetime64(lo + dur, 'ms')}Z"
        q = f"{bq} OR {wq}"
        check(ds.planner.plan("gdelt", q).strategy == "union(z2+z3)", f"union plan: {q}")
        s0 = time.perf_counter()
        got = np.asarray(ds.query("gdelt", q).ids, np.int64)
        union_lat.append(time.perf_counter() - s0)
        b1 = np.asarray(ds.query("gdelt", bq).ids, np.int64)
        b2 = np.asarray(ds.query("gdelt", wq).ids, np.int64)
        bx = tuple(float(f"{v:.4f}") for v in (x0, y0, x1, y1))
        check(np.array_equal(np.sort(b1), np.flatnonzero(
            (x >= bx[0]) & (x <= bx[2]) & (y >= bx[1]) & (y <= bx[3]))), f"box branch: {bq}")
        check(np.array_equal(np.sort(b2), np.flatnonzero((t >= lo) & (t < lo + dur))),
              f"window branch: {wq}")
        expect = np.concatenate([b1, b2[~np.isin(b2, b1)]])
        check(np.array_equal(got, expect), f"union ids in order: {q}")
        check(np.array_equal(np.asarray(ds.query("gdelt", q, limit=7).ids, np.int64),
                             expect[:7]), f"union limit 7: {q}")
        union_hits += len(got)
    launches = read_launches()
    rec = {
        "phase": "tiered_union_path", "cell": "gdelt-z3-10M-tiered", "launches": launches,
        "native": read_native(),
        "n_points": N_TIERED, "n_append": N_APPEND, "indexes": ["z3", "z2"],
        "ingest_s": ingest_s, "append_s": append_s, "compaction_s": compact_s,
        "one_write_12M_s": once_s,
        "n_queries": len(queries), "delta_hits_total": delta_hits,
        "latency_p50_ms_main_only": float(np.percentile(lat_main, 50) * 1e3),
        "latency_p50_ms_tiered": float(np.percentile(lat_tiered, 50) * 1e3),
        "latency_p50_ms_compacted": float(np.percentile(lat_compacted, 50) * 1e3),
        "delta_scan_ms_per_query": phases.get("delta", 0.0),
        "phase_ms_per_query_tiered": phases,
        "checked_tiered": len(queries), "checked_query_many": len(many), "check_s": check_s,
        "checked_compacted_vs_one_write": len(queries), "compacted_hits_moved_by_ties": ties,
        "n_union_queries": len(union_lat), "union_hits_total": union_hits,
        "union_latency_p50_ms": float(np.percentile(union_lat, 50) * 1e3),
        "union_latency_max_ms": float(np.max(union_lat) * 1e3),
        "device_gb": ds.table("gdelt", "z3").nbytes_device / 1e9
                     + ds.table("gdelt", "z2").nbytes_device / 1e9,
    }
    del ds, outs, many, seq
    torch.cuda.empty_cache()
    return rec


# -- the mutation surface and the incremental fold --------------------------

# cut from the cell's 10M rows, as it once was before: with the path at 10M and
# the ingest path added the script took 846.2 s (NVIDIA H100 80GB HBM3,
# 700.00 W; the path 116.6 s of it, the fold 65.0 s), over its 800 s; the
# fold's slices and the maintenance ops scale with the rows
# cut to 3M for the script's wall once paths 22-24 came, and to 2M once
# the pod path came (the script ran 965.2 s on an H100 80GB HBM3 at 700 W
# with it, over its 850 s)
N_MUTATE = 2_000_000
# half replace existing ids, half are new; the cell folds 1M rows in 16
# slices, cut to 500k in 8 for the script's 900 s once paths 22-24 came
N_FOLD = 500_000
N_UPSERT = 10_000
N_MUTATE_QUERIES = 8
N_ID_CHECK = 1_000
MUTATE_MODIFY_BOX = (-20.0, -20.0, 20.0, 20.0)
MUTATE_DELETE_BOX = (40.0, 0.0, 50.0, 10.0)
AGE_OFF_TTL_MS = 90 * 86_400_000


class PointModel:
    """The live rows of a mutated store, by id: alive, x, y, t."""

    def __init__(self, n_ids, x, y, t, n_live):
        self.alive = np.zeros(n_ids, bool)
        self.alive[:n_live] = True
        self.x = np.zeros(n_ids)
        self.y = np.zeros(n_ids)
        self.t = np.zeros(n_ids, np.int64)
        self.set(np.arange(n_live), x, y, t)

    def set(self, ids, x, y, t):
        self.alive[ids] = True
        self.x[ids], self.y[ids], self.t[ids] = x, y, t

    def hits(self, box, lo=None, hi=None) -> np.ndarray:
        """Live ids in the f64 box (bounds inclusive) and, with a window,
        with lo <= t < hi."""
        x0, y0, x1, y1 = box
        m = self.alive & (self.x >= x0) & (self.x <= x1) & (self.y >= y0) & (self.y <= y1)
        if lo is not None:
            m &= (self.t >= lo) & (self.t < hi)
        return np.flatnonzero(m)


def expected_order(ds, iname, hits) -> np.ndarray:
    """``hits`` in the order a query returns them: the device table's rows
    by (bin, z) and then store ordinal, then the delta tier's rows in
    ordinal order."""
    from geomesa_tpu_torch.storage.delta import TieredTable

    if len(hits) == 0:
        return hits
    ords = ds.id_lookup("gdelt", hits)
    check(len(ords) == len(hits), "every brute-force hit is in the store's id index")
    table = ds.table("gdelt", iname)
    main_rows = table.base if isinstance(table, TieredTable) else ds.row_count("gdelt")
    fc = ds.gather("gdelt", ords)
    idx = next(i for i in ds.indexes("gdelt") if i.name == iname)
    keys = idx.write_keys(fc)
    delta = ords >= main_rows
    order = np.lexsort((ords, np.where(delta, 0, keys.zs), np.where(delta, 0, keys.bins), delta))
    return np.asarray(fc.ids, np.int64)[order]


def check_mutated_queries(ds, model, queries, op: str) -> list:
    """The queries' ids as sets against the model's f64 brute force, and in
    order as ``expected_order`` gives them. Returns the latencies (s)."""
    lat = []
    for q, (x0, y0, x1, y1, lo, hi) in queries:
        s = time.perf_counter()
        plan = ds.planner.plan("gdelt", q)  # what DataStore.query runs
        out = ds.planner.execute(plan)
        lat.append(time.perf_counter() - s)
        got = np.asarray(out.ids, np.int64)
        ref = model.hits((x0, y0, x1, y1), lo, hi)
        check(np.array_equal(np.sort(got), ref), f"after {op}: query ids vs the model: {q}")
        check(np.array_equal(got, expected_order(ds, plan.index, ref)),
              f"after {op}: query ids in (bin, z, ordinal) order: {q}")
    return lat


def check_mutated_ids(ds, model, removed, rng, op: str) -> None:
    """``id_lookup``, ``id_exists_mask`` and an ``IN`` query over 1,000 ids,
    half of them live and half removed (deleted, or never written)."""
    live = np.flatnonzero(model.alive)
    dead = np.asarray(removed, np.int64)
    if len(dead) < N_ID_CHECK // 2:
        dead = np.concatenate([dead, len(model.alive) + np.arange(N_ID_CHECK // 2)])
    ids = np.concatenate([rng.choice(live, N_ID_CHECK // 2, replace=False),
                          rng.choice(dead, N_ID_CHECK // 2, replace=False)])
    rng.shuffle(ids)
    known = ids < len(model.alive)
    expect = known.copy()
    expect[known] = model.alive[ids[known]]
    check(np.array_equal(ds.id_exists_mask("gdelt", ids), expect),
          f"after {op}: id_exists_mask vs the model")
    ords = ds.id_lookup("gdelt", ids)
    fc = ds.gather("gdelt", ords)
    got = np.asarray(fc.ids, np.int64)
    check(np.array_equal(got, ids[expect]), f"after {op}: id_lookup gives the live ids in order")
    col = fc.columns["geom"]
    check(np.array_equal(col.x, model.x[got]) and np.array_equal(col.y, model.y[got])
          and np.array_equal(fc.columns["dtg"], model.t[got]),
          f"after {op}: id_lookup rows hold the model's values")
    probe = ids[:60]
    q = "IN (" + ", ".join(f"'{i}'" for i in probe) + ")"
    live_probe = probe[expect[:60]]
    ref = np.array(sorted(live_probe, key=str), np.int64)
    check(np.array_equal(np.asarray(ds.query("gdelt", q).ids, np.int64), ref),
          f"after {op}: an IN query gives the live ids in sorted order")


@contextmanager
def fold_recorder(keep_slices):
    """Record every folded_table call of a fold (the store's adapter calls
    storage.table.folded_table): per index, each slice's rows_uploaded
    and, for the slices in ``keep_slices``, the call's arguments and
    result, to fold again on the host path afterwards."""
    from geomesa_tpu_torch.storage import table as tbl

    fold = tbl.folded_table
    uploaded: dict = {}
    kept: dict = {}

    def recording(old, merged, keep, omap, dk, delta_perm=None, tile=None):
        table = fold(old, merged, keep, omap, dk, delta_perm=delta_perm, tile=tile)
        name = old.keyspace.name
        si = len(uploaded.setdefault(name, []))
        uploaded[name].append((table.rows_uploaded, len(dk.zs)))
        if si in keep_slices:
            kept[(name, si)] = (old, merged, keep, omap, dk, tile, table)
        return table

    tbl.folded_table = recording
    try:
        yield uploaded, kept
    finally:
        tbl.folded_table = fold


def check_fold_builds(torch, device, kept, last: int) -> dict:
    """Each kept slice's device-folded table against a host-path fold of
    the same slice (``geomesa.stream.fold.device=off``) and, for the last
    slice, a full IndexTable over the merged keys: sort state and every
    column bitwise equal on the card. Returns, per (index, slice), the
    host path's rows_uploaded and both builds' seconds, each timed again
    from the same old table."""
    from geomesa_tpu_torch import conf
    from geomesa_tpu_torch.storage.table import IndexTable, folded_table

    def fold_s(old, merged, keep, omap, dk, tile, mode):
        conf.STREAM_FOLD_DEVICE.set(mode)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = folded_table(old, merged, keep, omap, dk, tile=tile)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        finally:
            conf.STREAM_FOLD_DEVICE.clear()

    out = {}
    for (name, si), (old, merged, keep, omap, dk, tile, table) in sorted(kept.items()):
        check(table.rows_uploaded == len(dk.zs),
              f"device fold of slice {si} on {name} uploads only the slice's rows")
        args = (old, merged, keep, omap, dk, tile)
        dev, dev_s = fold_s(*args, "on")
        del dev
        host, host_s = fold_s(*args, "off")
        out[f"{name}/{si}"] = {"host_rows_uploaded": host.rows_uploaded,
                               "device_fold_s": dev_s, "host_fold_s": host_s}
        refs = [("host fold", host)]
        if si == last:
            refs.append(("full build", IndexTable(old.keyspace, merged, tile=tile, device=device)))
        for what, ref in refs:
            check(np.array_equal(np.asarray(table.perm, np.int64), np.asarray(ref.perm, np.int64)),
                  f"device fold of slice {si} on {name}: perm equals the {what}'s")
            for k in table.cols3:
                check(table.cols3[k].device.type == "cuda" or device.type != "cuda",
                      f"{name} column {k} lives on the card")
                check(torch.equal(table.cols3[k], ref.cols3[k]),
                      f"device fold of slice {si} on {name}: {k} equals the {what}'s bitwise")
        del refs, host
    torch.cuda.empty_cache()
    return out


N_PINNED_CALLS = 4  # count, bounds (estimate on and off), Count()


def pinned_raster_check(torch, ds, model) -> dict:
    """The raster aggregation push-down answers from the snapshot its scan
    ran on: a hook on ``gather`` deletes a 1 x 1 degree box inside a
    12-edge star (a publish that renumbers the table) before every
    residue gather; ``count``, ``bounds`` with ``estimate`` on and off and
    ``Count()`` must equal the f64 brute force of the model before that
    call's delete. K1's launches by leg are counted around the calls."""
    from geomesa_tpu_torch import geometry as geo

    # the centre of the densest 1 x 1 degree cell of the live rows
    live = model.alive
    h, xe, ye = np.histogram2d(model.x[live], model.y[live], bins=[360, 180],
                               range=[[-180, 180], [-90, 90]])
    i, j = np.unravel_index(int(np.argmax(h)), h.shape)
    cx, cy = float(xe[i]) + 0.5, float(ye[j]) + 0.5
    poly = star(cx, cy, 4.0, 6, np.random.default_rng(SEED + 57))
    q = f"INTERSECTS(geom, {geo.to_wkt(poly)})"
    plan = ds.planner.plan("gdelt", q)
    check(plan.index == "z2" and plan.config.rast is not None
          and ds._raster_agg_eligible("gdelt", plan),
          "the pinned-snapshot star is raster-eligible on Z2")
    _, certain = ds.table("gdelt", "z2").scan(plan.config)
    check(bool(certain.any()) and bool((~certain).any()),
          "the star's scan has certain rows and a residue")

    def brute():
        return brute_polygon_ids((np.where(model.alive, model.x, np.nan), model.y, model.t),
                                 poly, None)

    gather = ds.gather
    deleted = []
    busy = []  # the delete gathers too: it must not publish again

    def hooked(type_name, ords, chunks=None):
        if not busy and len(deleted) < N_PINNED_CALLS:
            j = len(deleted)
            box = (cx - 0.5 + 0.25 * j, cy - 0.5, cx + 0.5 + 0.25 * j, cy + 0.5)
            gone = model.hits(box)
            busy.append(1)
            try:
                n = ds.delete_features(type_name, "bbox(geom, {}, {}, {}, {})".format(*box))
            finally:
                busy.clear()
            check(n == len(gone) > 0, f"the pinned check's delete {j} removed {n} rows, "
                                      f"the model {len(gone)}")
            model.alive[gone] = False
            deleted.append(n)
        return gather(type_name, ords, chunks=chunks)

    legs0 = read_leg_launches().get("block_scan", {})
    ds.gather = hooked
    answers = {}
    t0 = time.perf_counter()
    try:
        for name, call in (("count", lambda: ds.count("gdelt", q)),
                           ("bounds_estimate", lambda: ds.bounds("gdelt", q, estimate=True)),
                           ("bounds_exact", lambda: ds.bounds("gdelt", q, estimate=False)),
                           ("count_stat", lambda: ds.stats_query("gdelt", "Count()", q)[0].count)):
            ids = brute()  # the snapshot the scan runs on: before this call's delete
            want = len(ids) if name.startswith("count") else (
                float(model.x[ids].min()), float(model.y[ids].min()),
                float(model.x[ids].max()), float(model.y[ids].max()))
            got = call()
            check(got == want, f"pinned raster {name}: {got} against the snapshot's {want}")
            answers[name] = got
    finally:
        del ds.gather
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(deleted) == N_PINNED_CALLS, "every pinned call published before its gather")
    legs1 = read_leg_launches().get("block_scan", {})
    raster = sum(legs1.get(g, 0) - legs0.get(g, 0) for g in legs1 if "raster" in g)
    check(raster >= N_PINNED_CALLS, f"K1 launched {raster} times with its raster leg")
    return {"polygon_edges": 12, "centre": [cx, cy], "answers": answers, "deleted": deleted,
            "k1_raster_launches": raster, "certain": int(certain.sum()),
            "residue": int((~certain).sum()), "s": seconds}


def mutation_path(torch, device) -> dict:
    """gdelt-z3-10M-mutate, N_MUTATE rows: a GDELT-shaped
    point store (Z3 and Z2, ids 0..N-1, written once) takes, in order,
    ``fold_upsert`` of 1M rows
    (500k existing ids moved to new positions in the span's last 21 days,
    500k new ids; 16 slices of 65,536 rows on the device fold),
    ``upsert`` of 10k existing ids, ``modify_features`` setting ``dtg`` on
    a BBOX + DURING filter, ``delete_features`` over a 10 x 10 degree box,
    and ``age_off`` with a 90-day TTL. A numpy model of the live rows
    follows every op. After each op: 8 BBOX + DURING queries (4 on the
    recent days) and 2 over the modified and the deleted rows against the
    model's f64 brute force, as sets and in (bin, z, ordinal) order; ``id_lookup``, ``id_exists_mask`` and an
    ``IN`` query over 1,000 ids, half of them removed. After the fold:
    the first and last slices' device-folded tables against a host-path
    fold of the same slice and (last) a full build, bitwise on the card.
    On the final store: ``query_many`` over 16 queries against the
    sequential ones, 4 count estimates, densities and bounds against the
    plain versions, ``warmup()``, and the raster push-down's pinned
    snapshot under publishes (``pinned_raster_check``). Launch counts are
    zeroed before and read after; all five kernels must launch."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType, conf

    zero_launches()
    rng = np.random.default_rng(SEED + 50)
    x, y = gdelt_points(N_MUTATE, rng)
    t = T0_MS + rng.integers(0, SPAN_MS, N_MUTATE)
    n_new = N_FOLD // 2
    model = PointModel(N_MUTATE + n_new, x, y, t, N_MUTATE)
    sft = FeatureType.from_spec("gdelt", "dtg:Date,*geom:Point:srid=4326")
    ds = DataStore(device=device)
    ds.create_schema(sft)

    def fc_of(ids, bx, by, bt):
        return FeatureCollection.from_columns(sft, ids, {"dtg": bt, "geom": (bx, by)})

    t_in = time.perf_counter()
    ds.write("gdelt", fc_of(np.arange(N_MUTATE), x, y, t), check_ids=False)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t_in
    del x, y, t
    half = N_MUTATE_QUERIES // 2
    queries = (query_set(SEED + 51, half, T0_MS + SPAN_MS - RECENT_MS, RECENT_MS)
               + query_set(SEED + 52, N_MUTATE_QUERIES - half))
    # the modify's filter, and the deleted box over the whole span: two
    # more queries that see the ops' rows
    lo = T0_MS + 40 * 86_400_000
    hi = lo + 20 * 86_400_000
    probes = [
        (f"bbox(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND dtg DURING "
         f"{np.datetime64(w0, 'ms')}Z/{np.datetime64(w1, 'ms')}Z", (*b, w0, w1))
        for b, w0, w1 in ((MUTATE_MODIFY_BOX, lo, hi),
                          (MUTATE_DELETE_BOX, T0_MS, T0_MS + SPAN_MS))
    ]
    id_rng = np.random.default_rng(SEED + 53)
    removed: list = []
    ops: dict = {}

    def after(op, seconds, n_removed):
        t0 = time.perf_counter()
        lat = check_mutated_queries(ds, model, queries + probes, op)[: len(queries)]
        check_mutated_ids(ds, model, np.concatenate(removed) if removed else [], id_rng, op)
        ops[op] = {"s": seconds, "rows_removed": n_removed, "rows": ds.row_count("gdelt"),
                   "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
                   "check_s": time.perf_counter() - t0}

    after("write", ingest_s, 0)

    # 1. the fold: moving objects reporting again, and new ones
    r = np.random.default_rng(SEED + 54)
    ids = np.concatenate([r.choice(N_MUTATE, N_FOLD - n_new, replace=False),
                          N_MUTATE + np.arange(n_new)])
    r.shuffle(ids)
    fx, fy = gdelt_points(N_FOLD, r)
    ft = T0_MS + SPAN_MS - RECENT_MS + r.integers(0, RECENT_MS, N_FOLD)
    batch = fc_of(ids, fx, fy, ft)
    slice_rows = conf.STREAM_FOLD_SLICE_ROWS.get()  # 65,536 by default
    n_slices = -(-N_FOLD // slice_rows)
    with fold_recorder({0, n_slices - 1}) as (uploaded, kept):
        t0 = time.perf_counter()
        ds.fold_upsert("gdelt", batch)
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t0
    report = ds.last_fold_report
    check(report["slices"] == n_slices and report["rows"] == N_FOLD,
          f"the fold ran in {n_slices} slices of {slice_rows} rows")
    model.set(ids, fx, fy, ft)
    del batch, fx, fy, ft
    fold_builds = check_fold_builds(torch, device, kept, n_slices - 1)
    del kept
    torch.cuda.empty_cache()
    for name, per_slice in uploaded.items():
        check(len(per_slice) == n_slices and all(u == n for u, n in per_slice),
              f"every device-folded slice of {name} uploads only its rows")
    after("fold_upsert", fold_s, 0)

    # 2. upsert: the delete-and-rewrite path
    r = np.random.default_rng(SEED + 55)
    ids = r.choice(np.flatnonzero(model.alive), N_UPSERT, replace=False)
    ux, uy = gdelt_points(N_UPSERT, r)
    ut = T0_MS + SPAN_MS - RECENT_MS + r.integers(0, RECENT_MS, N_UPSERT)
    t0 = time.perf_counter()
    n = ds.upsert("gdelt", fc_of(ids, ux, uy, ut))
    torch.cuda.synchronize()
    upsert_s = time.perf_counter() - t0
    check(n == N_UPSERT, "upsert wrote its batch")
    model.set(ids, ux, uy, ut)
    after("upsert", upsert_s, 0)

    # 3. modify_features: rows move to another time bin
    new_t = T0_MS + 100 * 86_400_000
    mq = probes[0][0]
    matched = model.hits(MUTATE_MODIFY_BOX, lo, hi)
    t0 = time.perf_counter()
    n = ds.modify_features("gdelt", {"dtg": int(new_t)}, mq)
    torch.cuda.synchronize()
    modify_s = time.perf_counter() - t0
    check(n == len(matched) > 0, f"modify_features changed {n} rows, the model {len(matched)}")
    model.t[matched] = new_t
    after("modify_features", modify_s, 0)
    ops["modify_features"]["rows_modified"] = n

    # 4. delete_features over one box
    gone = model.hits(MUTATE_DELETE_BOX)
    t0 = time.perf_counter()
    n = ds.delete_features("gdelt", "bbox(geom, {}, {}, {}, {})".format(*MUTATE_DELETE_BOX))
    torch.cuda.synchronize()
    delete_s = time.perf_counter() - t0
    check(n == len(gone) > 0, f"delete_features removed {n} rows, the model {len(gone)}")
    model.alive[gone] = False
    removed.append(gone)
    after("delete_features", delete_s, n)

    # 5. age_off: a 90-day TTL at the span's end
    now = T0_MS + SPAN_MS
    old = np.flatnonzero(model.alive & (model.t < now - AGE_OFF_TTL_MS))
    t0 = time.perf_counter()
    n = ds.age_off("gdelt", ttl_ms=AGE_OFF_TTL_MS, now_ms=now)
    torch.cuda.synchronize()
    age_off_s = time.perf_counter() - t0
    check(n == len(old) > 0, f"age_off removed {n} rows, the model {len(old)}")
    model.alive[old] = False
    removed.append(old)
    after("age_off", age_off_s, n)

    # the final store: the fused scan, the aggregations, warm-up
    batch_q = [q for q, _ in queries + query_set(SEED + 56, N_MUTATE_QUERIES)]
    many = ds.query_many("gdelt", batch_q)
    seq = [ds.query("gdelt", q) for q in batch_q]
    check(len(many) == len(seq) and all(
        np.array_equal(np.asarray(a.ids), np.asarray(b.ids)) for a, b in zip(many, seq)),
        "mutated query_many vs sequential, in order")
    outs = seq[:N_MUTATE_QUERIES]
    counted = busiest(queries, outs, 4)
    exact = {q: o for (q, _), o in zip(queries, outs)}
    estimates = count_estimates(ds, counted)
    n_counts = check_counts(torch, ds, counted, [exact[q] for q, _ in counted], estimates)
    n_agg = check_aggregations(torch, ds, counted)
    t0 = time.perf_counter()
    calls = ds.warmup("gdelt")
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    pinned = pinned_raster_check(torch, ds, model)
    launches = read_launches()
    slice_ms = np.asarray(report["slice_s"]) * 1e3
    rec = {
        "phase": "mutation_path", "cell": "gdelt-z3-10M-mutate", "launches": launches,
        "native": read_native(),
        "n_points": N_MUTATE, "indexes": ["z3", "z2"], "n_queries": len(queries),
        "reduced": {"n_points": {"cell": 10_000_000, "run": N_MUTATE},
                    "fold_rows": {"cell": 1_000_000, "run": N_FOLD}},
        "ingest_s": ingest_s,
        "fold": {"rows": N_FOLD, "replaced": N_FOLD - n_new, "new": n_new, "s": fold_s,
                 "slices": report["slices"], "slice_rows": slice_rows,
                 "slice_ms_p50": float(np.percentile(slice_ms, 50)),
                 "slice_ms_max": float(slice_ms.max()),
                 "rows_uploaded_device": {k: int(sum(u for u, _ in v))
                                          for k, v in uploaded.items()},
                 "checked_slice_builds": fold_builds,
                 "checked_slices": [0, n_slices - 1]},
        "fold_s": fold_s, "upsert_s": upsert_s, "modify_s": modify_s, "delete_s": delete_s,
        "age_off_s": age_off_s, "warmup_s": warmup_s, "warmup_calls": calls,
        "ops": ops,
        "checked_query_many": len(many), "checked_counts": n_counts,
        "checked_aggregations": n_agg, "count_estimates": estimates,
        "checked_pinned_raster": pinned,
        "device_gb": ds.table("gdelt", "z3").nbytes_device / 1e9
                     + ds.table("gdelt", "z2").nbytes_device / 1e9,
    }
    del ds, many, seq, outs, model
    torch.cuda.empty_cache()
    return rec


# -- attribute indexes -------------------------------------------------------

# 5M of the cell's 10M rows: with the streaming path added, the whole
# script ran 851.3 s on the card against its 760 s budget
# cut to 3M for the script's wall once paths 22-24 came, and to 2M once
# the pod path came (the script ran 965.2 s on an H100 80GB HBM3 at 700 W
# with it, over its 850 s)
N_ATTR = 2_000_000
N_ATTR_APPEND = 50_000  # each of the two appends kept in the delta tier
N_ATTR_BATCH = 16  # rare-code regional queries in one query_many
N_ACTORS = 2_000
# Zipf-Mandelbrot skew of both attributes: P(rank k) ~ (k + q)^-s
ATTR_ZIPF_S, ATTR_ZIPF_Q = 1.1, 2.7
ATTR_LIMIT = 10
ATTR_SPEC = ("EventCode:String:index=true,Actor1Name:String:index=true,"
             "dtg:Date,*geom:Point:srid=4326")
# the stems of compound actor names: countries, organisations and roles
# (GDELT's Actor1Name values are upper-case CAMEO actor names); several
# share an 8-byte prefix ("UNITED S", "UNITED K", "PRESIDEN")
ACTOR_STEMS = (
    "UNITED STATES", "UNITED STATES", "UNITED STATES", "UNITED KINGDOM", "UNITED NATIONS",
    "UNITED ARAB EMIRATES", "PRESIDENT", "PRESIDENTIAL GUARD", "GOVERNMENT", "POLICE",
    "MILITARY", "SECURITY FORCES", "PRIME MINISTER", "EUROPEAN UNION", "CHINA", "RUSSIA",
    "IRAN", "ISRAEL", "INDIA", "PAKISTAN", "AFGHANISTAN", "NIGERIA", "SOUTH AFRICA",
)


def cameo_codes(rng) -> np.ndarray:
    """300 CAMEO-shaped event codes of 2-4 digits: the 20 root codes, their
    200 three-digit children and 80 four-digit children of 16 of those."""
    roots = [f"{i:02d}" for i in range(1, 21)]
    three = [f"{r}{d}" for r in roots for d in range(10)]
    four = [f"{c}{d}" for c in rng.choice(three, 16, replace=False) for d in range(1, 6)]
    return np.array(roots + three + four)


def actor_names(rng, n, lo_len=3, hi_len=40) -> np.ndarray:
    """n distinct upper-case actor names of lo_len..hi_len characters:
    three in five a stem and a word, the rest one word."""
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    out: dict = {}
    while len(out) < n:
        word = "".join(rng.choice(letters, int(rng.integers(3, 13))))
        if rng.random() < 0.6:
            word = f"{ACTOR_STEMS[int(rng.integers(len(ACTOR_STEMS)))]} {word}"
        word = word[:hi_len]
        if len(word) >= lo_len:
            out.setdefault(word, None)
    return np.array(list(out))


def zipf_ranks(rng, n_values, n) -> np.ndarray:
    """n draws of value ranks 0..n_values-1, Zipf-Mandelbrot skewed."""
    p = (np.arange(1, n_values + 1) + ATTR_ZIPF_Q) ** -ATTR_ZIPF_S
    cdf = np.cumsum(p / p.sum())
    return np.minimum(np.searchsorted(cdf, rng.random(n), side="right"), n_values - 1)


class AttrRows:
    """The attribute cell's rows by id: points, times, and each row's event
    code and actor name as indexes into their vocabularies."""

    def __init__(self, rng):
        self.codes = cameo_codes(rng)  # vocabulary, in rank order of the skew
        self.actors = actor_names(rng, N_ACTORS)
        n_all = N_ATTR + 2 * N_ATTR_APPEND
        self.x, self.y = gdelt_points(n_all, rng)
        perm = rng.permutation(n_all)
        self.x, self.y = self.x[perm], self.y[perm]
        self.t = T0_MS + rng.integers(0, SPAN_MS, n_all)
        self.code = zipf_ranks(rng, len(self.codes), n_all)
        # the appends' names have other word widths: one batch at most 16
        # bytes (one secondary word), one of 41-48 bytes (five), so the
        # delta's key parts pad when they join (_concat_sub)
        short = self.actors[np.char.str_len(self.actors) <= 16]
        longer = np.array([f"{a} REGIONAL OFFICE"[:48] for a in self.actors
                           if 41 <= len(f"{a} REGIONAL OFFICE") <= 48])
        self.names = np.concatenate([self.actors, short, longer])
        a = N_ATTR
        self.actor = np.concatenate([
            zipf_ranks(rng, N_ACTORS, a),
            len(self.actors) + rng.integers(0, len(short), N_ATTR_APPEND),
            len(self.actors) + len(short) + rng.integers(0, len(longer), N_ATTR_APPEND),
        ])
        # each value's rank in sorted (byte) order: the index's value order
        self.code_pos = np.searchsorted(np.unique(self.codes), self.codes)
        self.name_pos = np.searchsorted(np.unique(self.names), self.names)

    def fc(self, sft, lo, hi):
        from geomesa_tpu_torch import FeatureCollection

        return FeatureCollection.from_columns(sft, np.arange(lo, hi), {
            "EventCode": self.codes[self.code[lo:hi]], "Actor1Name": self.names[self.actor[lo:hi]],
            "dtg": self.t[lo:hi], "geom": (self.x[lo:hi], self.y[lo:hi]),
        })


def attr_queries(rows: AttrRows, seed) -> list:
    """[(ecql, kind, predicate)]: 16 EventCode equalities (the 8 commonest
    codes, 8 of ranks 200-299), 8 Actor1Name BETWEEN ranges whose bounds
    are longer than 8 bytes and share their 8-byte prefix, and 8
    EventCode IN (...) AND BBOX AND DURING queries."""
    r = np.random.default_rng(seed)
    out = []
    for k in [*range(8), *r.choice(np.arange(200, 300), 8, replace=False)]:
        out.append((f"EventCode = '{rows.codes[k]}'", "code", ("eq", int(k))))
    names = np.sort(rows.actors[np.char.str_len(rows.actors) > 8])
    prefix = np.array([n[:8] for n in names])
    groups = [np.flatnonzero(prefix == p) for p in np.unique(prefix)]
    groups = [g for g in groups if len(g) >= 4]
    for g in [groups[i] for i in r.choice(len(groups), 8, replace=len(groups) < 8)]:
        i = int(r.integers(0, len(g) - 1))
        j = int(r.integers(i + 1, min(len(g), i + 1 + max(1, len(g) // 3))))
        lo, hi = names[g[i]], names[g[j]]
        out.append((f"Actor1Name BETWEEN '{lo}' AND '{hi}'", "name", ("between", lo, hi)))
    # half: three common codes in a box of 1-40 degrees over 6 h-14 d (the
    # z index is cheaper); half: one rare code over a 40-degree region and
    # 14 days (the attribute index is cheaper, so its plan runs K1 with
    # the box and window legs and clips to the value spans)
    common = query_set(seed + 1, 4)
    for k in range(8):
        if k % 2:
            q, box = common[k // 2]
            ks = r.choice(10, 3, replace=False)
            lst = ", ".join(f"'{rows.codes[c]}'" for c in ks)
            out.append((f"EventCode IN ({lst}) AND {q}", "mixed", ("in", [int(c) for c in ks], box)))
        else:
            out.append(rare_region_query(rows, r))
    return out


def rare_region_query(rows: AttrRows, r):
    """EventCode IN (one code of rank 250-299) AND a 40-degree box AND a
    14-day window: where did a rare event happen in a region over two
    weeks."""
    x0, y0 = r.uniform(-170, 130), r.uniform(-60, 20)
    lo = int(T0_MS + r.integers(0, SPAN_MS - 14 * 86_400_000))
    hi = lo + 14 * 86_400_000
    box = (round(x0, 4), round(y0, 4), round(x0 + 40, 4), round(y0 + 40, 4), lo, hi)
    k = int(r.integers(250, 300))
    q = (f"EventCode IN ('{rows.codes[k]}') AND bbox(geom, {box[0]:.4f}, {box[1]:.4f}, "
         f"{box[2]:.4f}, {box[3]:.4f}) AND dtg DURING {np.datetime64(lo, 'ms')}Z/"
         f"{np.datetime64(hi, 'ms')}Z")
    return q, "mixed", ("in", [k], box)


def attr_hits(rows: AttrRows, pred, n) -> np.ndarray:
    """Ascending ids < n that pass the query, by an f64 / string brute force."""
    kind = pred[0]
    if kind == "eq":
        m = rows.code[:n] == pred[1]
    elif kind == "between":
        ok = (rows.names >= pred[1]) & (rows.names <= pred[2])
        m = ok[rows.actor[:n]]
    else:
        x0, y0, x1, y1, lo, hi = pred[2]
        x, y, t = rows.x[:n], rows.y[:n], rows.t[:n]
        m = (np.isin(rows.code[:n], pred[1]) & (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
             & (t >= lo) & (t < hi))
    return np.flatnonzero(m)


def attr_order(ds, rows: AttrRows, index: str, hits, main_rows) -> np.ndarray:
    """``hits`` in the order the reference returns them for a plan on
    ``index``: an attribute index's main rows by value (full string
    bytes) then id, then the delta tier's rows by id; a z index's by
    ``expected_order``."""
    if not index.startswith("attr_"):
        return expected_order(ds, index, hits)
    pos = rows.code_pos[rows.code[hits]] if index == "attr_EventCode" \
        else rows.name_pos[rows.actor[hits]]
    delta = hits >= main_rows
    return hits[np.lexsort((hits, np.where(delta, 0, pos), delta))]


@contextmanager
def ingest_recorder(ds, type_name):
    """Seconds per index of one write: its write keys and its table build
    (through the store's adapter)."""
    spent: dict = {}
    real_create = ds.adapter.create_table

    def timed_create(keyspace, keys, **kw):
        s = time.perf_counter()
        out = real_create(keyspace, keys, **kw)
        spent[f"{keyspace.name}.table"] = time.perf_counter() - s
        return out

    def timed_keys(idx):
        real = idx.write_keys

        def run(fc):
            s = time.perf_counter()
            out = real(fc)
            spent[f"{idx.name}.keys"] = time.perf_counter() - s
            return out
        return run

    idxs = ds.indexes(type_name)
    for idx in idxs:
        idx.write_keys = timed_keys(idx)
    ds.adapter.create_table = timed_create
    try:
        yield spent
    finally:
        del ds.adapter.create_table
        for idx in idxs:
            del idx.write_keys


def check_attr_queries(ds, rows, queries, n, main_rows, stage) -> dict:
    """Each query's ids against the brute force in the reference's order,
    and its limit page against their prefix; returns {ecql: index}."""
    plans = {}
    for q, kind, pred in queries:
        plan = ds.planner.plan("gdelt", q)
        plans[q] = plan.index
        if kind != "mixed":
            check(plan.index == ("attr_EventCode" if kind == "code" else "attr_Actor1Name"),
                  f"{stage}: a pure attribute query plans its attribute index: {q}")
        got = np.asarray(ds.planner.execute(plan).ids, np.int64)
        want = attr_order(ds, rows, plan.index, attr_hits(rows, pred, n), main_rows)
        check(np.array_equal(got, want), f"{stage}: ids in the reference's order: {q}")
        page = np.asarray(ds.query("gdelt", q, limit=ATTR_LIMIT).ids, np.int64)
        check(np.array_equal(page, want[:ATTR_LIMIT]), f"{stage}: limit page: {q}")
    return plans


def attribute_path(torch, device) -> dict:
    """gdelt-attr-10M: ``N_ATTR`` (5M of the cell's 10M) GDELT-shaped points
    with two attribute indexes (EventCode, Actor1Name) beside Z3 and Z2,
    all four tables on the card.
    32 queries (16 EventCode equalities, 8 Actor1Name ranges, 8 EventCode
    IN + BBOX + DURING) against a numpy brute force in the reference's
    order and under limit 10, ``query_many`` against the sequential ids,
    4 count estimates >= the exact counts; then two 50k-row appends of
    other name widths kept in the delta, and the 32 queries again. Launch
    and native call counts are zeroed before and read after."""
    from geomesa_tpu_torch import DataStore, FeatureType
    from geomesa_tpu_torch.storage.delta import TieredTable
    from geomesa_tpu_torch.timing import NULL_CLOCK, PhaseClock

    zero_launches()
    t_gen = time.perf_counter()
    rows = AttrRows(np.random.default_rng(SEED + 60))
    gen_s = time.perf_counter() - t_gen
    sft = FeatureType.from_spec("gdelt", ATTR_SPEC)
    ds = DataStore(device=device)
    ds.create_schema(sft)
    check([i.name for i in ds.indexes("gdelt")] == ["z3", "z2", "attr_EventCode",
                                                    "attr_Actor1Name"], "four indexes")
    fc = rows.fc(sft, 0, N_ATTR)
    with ingest_recorder(ds, "gdelt") as per_index:
        t_in = time.perf_counter()
        ds.write("gdelt", fc, check_ids=False)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t_in
    del fc
    tables = {i.name: ds.table("gdelt", i.name) for i in ds.indexes("gdelt")}
    check(tables["attr_Actor1Name"].subkeys is not None
          and tables["attr_EventCode"].subkeys is None,
          "names past 8 bytes carry secondary sort words; codes do not")
    queries = attr_queries(rows, SEED + 61)
    filters = [q for q, _, _ in queries]

    run_queries(ds, [(q,) for q in filters[:8]])  # warm-up
    lat, outs, wall = run_queries(ds, [(q,) for q in filters])
    ds.clock = clock = PhaseClock()
    _, _, traced_wall = run_queries(ds, [(q,) for q in filters])
    phases = {k: v / len(filters) * 1e3 for k, v in clock.settle().items() if not k.startswith("n.")}
    ds.clock = NULL_CLOCK
    device_ms = sum(phases.get(k, 0.0) for k in ("h2d", "kernel", "d2h"))
    hits = sum(len(o) for o in outs)

    t_chk = time.perf_counter()
    plans = check_attr_queries(ds, rows, queries, N_ATTR, N_ATTR, "main")
    s = time.perf_counter()
    many = ds.query_many("gdelt", filters)
    many_s = time.perf_counter() - s
    check_same_ids(many, outs, "attribute query_many vs sequential query")
    # a dashboard's batch of 16 rare-code regional queries: more than 8
    # attribute plans with box and window legs fuse into K2's chunks
    r = np.random.default_rng(SEED + 62)
    batch = [rare_region_query(rows, r) for _ in range(N_ATTR_BATCH)]
    with chunk_recorder() as fused:
        many_batch = ds.query_many("gdelt", [q for q, _, _ in batch])
    check_same_ids(many_batch, [ds.query("gdelt", q) for q, _, _ in batch],
                   "rare-code batch query_many vs sequential query")
    batch_plans = check_attr_queries(ds, rows, batch, N_ATTR, N_ATTR, "batch")
    counted = [queries[i] for i in (0, 12, 16, 24)]
    estimates = [ds.stats_query("gdelt", "Count()", q, estimate=True)[0].count
                 for q, _, _ in counted]
    for (q, _, pred), est in zip(counted, estimates):
        check(est >= len(attr_hits(rows, pred, N_ATTR)), f"count estimate >= exact: {q}")
    check_s = time.perf_counter() - t_chk

    append_s = []
    for lo in (N_ATTR, N_ATTR + N_ATTR_APPEND):
        t_in = time.perf_counter()
        ds.write("gdelt", rows.fc(sft, lo, lo + N_ATTR_APPEND), check_ids=False)
        torch.cuda.synchronize()
        append_s.append(time.perf_counter() - t_in)
    n_all = N_ATTR + 2 * N_ATTR_APPEND
    names = ds.table("gdelt", "attr_Actor1Name")
    check(isinstance(names, TieredTable) and ds.row_count("gdelt") == n_all,
          "both appends stay in the delta tier")
    sub = names.delta.sub
    check(sub is not None and sub.shape == (2 * N_ATTR_APPEND, 5)
          and not sub[:N_ATTR_APPEND, 1:].any(),
          "the delta's secondary words join at the widest batch's width, zero-padded")
    lat_tiered, outs_tiered, _ = run_queries(ds, [(q,) for q in filters])
    check_attr_queries(ds, rows, queries, n_all, N_ATTR, "tiered")
    many = ds.query_many("gdelt", filters)
    check_same_ids(many, outs_tiered, "tiered attribute query_many vs sequential query")
    delta_hits = sum(int((np.asarray(o.ids) >= N_ATTR).sum()) for o in outs_tiered)
    check(delta_hits > 0, "the queries see delta rows")

    launches = read_launches()
    rec = {
        "phase": "attribute_path", "cell": "gdelt-attr-10M", "launches": launches,
        "native": read_native(),
        "source": "GDELT 1.0 event codebook (EventCode: CAMEO, 2-4 digits; Actor1Name) on "
                  "BASELINE.md config 1's points (bench.py:155-226)",
        "reduced": {"rows": "GDELT 1.0 holds hundreds of millions of events; cut to "
                            "10,000,000 for the script's 1200 s limit",
                    **({"cell_rows": {"cell": 10_000_000, "run": N_ATTR}}
                       if N_ATTR != 10_000_000 else {})},
        "n_points": N_ATTR, "n_append": 2 * N_ATTR_APPEND,
        "indexes": list(tables), "n_event_codes": len(rows.codes), "n_actors": N_ACTORS,
        "top_code_share": float(np.mean(rows.code[:N_ATTR] == 0)),
        "actors_past_8_bytes": float(np.mean(np.char.str_len(rows.actors) > 8)),
        "data_gen_s": gen_s, "ingest_s": ingest_s, "ingest_s_by_index": per_index,
        "append_s": append_s,
        "n_queries": len(filters), "hits_total": hits, "delta_hits_total": delta_hits,
        "strategies": {q: plans[q] for q, kind, _ in queries if kind == "mixed"},
        "batch_strategies": sorted(batch_plans.values()), "batch_fused_chunks": fused,
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p84_ms": float(np.percentile(lat, 84) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "latency_p50_ms_tiered": float(np.percentile(lat_tiered, 50) * 1e3),
        "features_per_s": hits / wall,
        "query_many_queries_per_s": len(filters) / many_s,
        "phase_ms_per_query": phases,
        "traced_ms_per_query": traced_wall / len(filters) * 1e3,
        "device_busy_share": device_ms / (traced_wall / len(filters) * 1e3),
        "count_estimates": estimates, "check_s": check_s,
        "device_gb": sum(t.nbytes_device for t in tables.values()) / 1e9,
    }
    del ds, rows, outs, outs_tiered, many, tables, names
    torch.cuda.empty_cache()
    return rec


# -- persistence: save, load, quarantine, crash points, the host adapter -----

# the cell's 10M rows cut to 3M for the script's wall once paths 22-24
# came, to 2M once the pod path came (the record's ``reduced``)
N_PERSIST = 2_000_000
N_PERSIST_APPEND = 50_000  # the span's last 21 days, kept in the delta tier
N_PERSIST_QUERIES = 16
N_CRASH = 200_000
N_CRASH_APPEND = 10_000
N_WITNESS = 100_000
PERSIST_POINTS = (
    "persist.partition.write", "persist.partition.rename", "persist.partition.commit",
    "persist.manifest.write", "persist.manifest.rename", "persist.manifest.commit",
    "persist.gc",
)


@contextmanager
def time_recorder(targets):
    """Seconds spent in each (owner, function name) of ``targets`` while
    the block runs (a method patched on its class, a function on its
    module), summed over calls."""
    spent: dict = {}
    saved = []
    for owner, name in targets:
        real = getattr(owner, name)

        def timed(*a, _real=real, _name=name, **k):
            s0 = time.perf_counter()
            try:
                return _real(*a, **k)
            finally:
                spent[_name] = spent.get(_name, 0.0) + time.perf_counter() - s0

        saved.append((owner, name, real))
        setattr(owner, name, timed)
    try:
        yield spent
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)


def manifest_parts(root, type_name="gdelt") -> dict:
    """The committed manifest's partitions of one type: key -> entry."""
    with open(os.path.join(root, "metadata.json")) as fh:
        return json.load(fh)["types"][type_name]["partitions"]


def append_rows(n, n_new, seed, with_root_code=True):
    """n_new GDELT-shaped rows with ids n.. and times in the span's last
    21 days (a day's loads into a standing table): (ids, x, y, t, codes)."""
    rng = np.random.default_rng(seed)
    x, y = gdelt_points(n_new, rng)
    t = T0_MS + SPAN_MS - RECENT_MS + rng.integers(0, RECENT_MS, n_new)
    codes = root_codes(n_new, seed + 7) if with_root_code else None
    return np.arange(n, n + n_new), x, y, t, codes


def write_rows(ds, rows) -> float:
    from geomesa_tpu_torch import FeatureCollection

    ids, x, y, t, codes = rows
    sft = ds.get_schema("gdelt")
    cols = {"dtg": t, "geom": (x, y)}
    if codes is not None:
        cols["EventRootCode"] = codes
    t_in = time.perf_counter()
    ds.write("gdelt", FeatureCollection.from_columns(sft, ids, cols), check_ids=False)
    return time.perf_counter() - t_in


def ids_of(outs) -> list:
    return [np.asarray(o.ids, np.int64) for o in outs]


def crash_points(torch, device, root) -> dict:
    """A 200k-row store saved and committed, then 10k appended rows: a
    second save over the committed directory crashes at each persist.*
    fault point, and each load must give the old store or the new one,
    never a mix. Returns point -> "old" | "new"."""
    import shutil

    from geomesa_tpu_torch import fault
    from geomesa_tpu_torch.storage import persist

    small, _, _ = build_store(torch, device, N_CRASH, with_root_code=True, seed=SEED + 72)
    base = os.path.join(root, "crash-base")
    persist.save(small, base)
    old = np.arange(N_CRASH)
    write_rows(small, append_rows(N_CRASH, N_CRASH_APPEND, SEED + 73))
    new = np.arange(N_CRASH + N_CRASH_APPEND)
    outcome = {}
    for point in PERSIST_POINTS:
        d = os.path.join(root, f"crash-{point}")
        shutil.copytree(base, d)
        crashed = False
        with fault.inject(point, kind="crash") as spec:
            try:
                persist.save(small, d)
            except fault.InjectedCrash:
                crashed = True
        check(crashed and spec.fired == 1, f"the save crashed at {point}")
        back = persist.load(d, device=device)
        got = np.sort(np.asarray(back.features("gdelt").ids, np.int64))
        state = "old" if np.array_equal(got, old) else "new" if np.array_equal(got, new) else None
        check(state is not None, f"a crash at {point} loads the old or the new store")
        check(back.store_health.status == "ok", f"a crash at {point} damages nothing committed")
        outcome[point] = state
        del back
        shutil.rmtree(d)
    check(outcome["persist.partition.write"] == "old" and outcome["persist.gc"] == "new",
          "the manifest's rename is the commit point")
    del small
    return outcome


def witness_workload(torch, device) -> dict:
    """The lock witness armed around a small write, query and fold
    workload (the store is built after arming, so its locks are
    wrapped): the observed acquisition graph must be acyclic."""
    from geomesa_tpu_torch import FeatureCollection, lockwitness
    from geomesa_tpu_torch.metrics import MetricsRegistry

    lockwitness.enable()
    try:
        ds, src, _ = build_store(torch, device, N_WITNESS, seed=SEED + 74)
        ds.metrics = MetricsRegistry()
        qs = [q for q, _ in query_set(SEED + 75, 8)]
        for q in qs:
            ds.query("gdelt", q)
        ds.query_many("gdelt", qs)
        x, y, t = src
        rows = np.arange(0, N_WITNESS, 5)
        fc = FeatureCollection.from_columns(ds.get_schema("gdelt"), rows, {
            "dtg": t[rows] + 3_600_000, "geom": (x[rows], y[rows])})
        paced = []
        ds.fold_upsert("gdelt", fc, slice_rows=5_000, pacer=lambda: paced.append(1))
        snap = lockwitness.REPORT.snapshot()
        cycle = lockwitness.REPORT.cycle()
    finally:
        lockwitness.disable()
    check(cycle is None, f"the witnessed lock graph is acyclic: {cycle}")
    check({"DataStore._write_lock", "DataStore._id_lock", "MetricsRegistry._lock"}
          <= set(snap["seen"]), "the store's locks were witnessed")
    check(len(paced) == -(-len(rows) // 5_000) - 1, "the fold paced between its slices")
    del ds
    return {"edges": [f"{a} -> {b}" for a, b in snap["edges"]], "seen": snap["seen"],
            "blocking": snap["blocking"]}


def persist_path(torch, device) -> dict:
    """gdelt-z3-10M-persist: an N_PERSIST-row GDELT Z3 store with
    ``EventRootCode`` answers 16 measured queries, densities and bounds;
    ``persist.save`` writes it to a temporary directory on local disk
    (removed at the end) and ``persist.load(device="cuda")`` reads it
    back: ids identical and in order, grids and bounds identical, the
    loaded tables on the card and their queries launching K1 (K2 through
    ``query_many``, K1p through count estimates, K3 and K4 through the
    aggregations). 50k rows appended in the span's last 21 days and a
    second save rewrite only the touched partitions; a load reads the
    save back whole. One byte flipped in one committed partition: the
    load quarantines it (one checksum record), every plan warns and
    ``geomesa.query.degraded`` counts, and the ids are the whole store's
    minus that partition's rows, in order, and equal an f64 brute force
    over the source columns. Then a crash at each persist.* point on a
    200k-row store, the same 10M rows on ``HostAdapter`` (its 16 results
    equal the device store's, in order), and the lock witness around a
    small workload. Launch and native counts are zeroed before, read
    after."""
    import shutil

    from geomesa_tpu_torch import DataStore
    from geomesa_tpu_torch.kernels import BLOCK_SCAN
    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.storage import persist
    from geomesa_tpu_torch.storage.adapter import HostAdapter

    zero_launches()
    ds, src, ingest_s = build_store(torch, device, N_PERSIST, with_root_code=True,
                                    seed=SEED + 70)
    queries = query_set(SEED + 71, N_PERSIST_QUERIES)
    busy = busiest(queries, [ds.query("gdelt", q) for q, _ in queries], 4)
    lat_before, outs, _ = run_queries(ds, queries)
    want = ids_of(outs)
    check(sum(map(len, want)) > 0, "the persist path's queries have hits")

    def aggregates(store):
        return ([store.density("gdelt", q, envelope=box[:4], width=256, height=256)
                 for q, box in busy],
                [store.bounds("gdelt", q, estimate=e) for q, _ in busy for e in (True, False)],
                count_estimates(store, busy))

    grids, envs, ests = aggregates(ds)
    root = tempfile.mkdtemp(prefix="geomesa_persist_")
    try:
        # where a save's and a load's time goes: packing, the content
        # signature, the partition files (compress, checksum, durable
        # write), the manifest; reading, unpacking, the keys, the builds
        save_parts = [(persist, n) for n in ("_pack_columns", "_signature", "_write_partition",
                                              "_commit_manifest", "_collect_garbage")]
        with time_recorder(save_parts) as save_phases:
            t0 = time.perf_counter()
            persist.save(ds, root)
            save_s = time.perf_counter() - t0
        parts1 = manifest_parts(root)
        files1 = {k: e["file"] for k, e in parts1.items()}
        bytes1 = sum(e["bytes"] for e in parts1.values())
        on_disk = sum(os.path.getsize(os.path.join(root, "gdelt", f)) for f in files1.values())
        check(len(parts1) >= 5 and on_disk == bytes1,
              "the 120-day span saves as 5-6 partitions of 28 days, every byte committed")
        check(sum(e["rows"] for e in parts1.values()) == N_PERSIST, "every row saved")

        load_parts = [(persist, "_read_bytes"), (persist, "_unpack_columns"),
                      (DataStore, "_encode_batch"), (DataStore, "compact")]
        with time_recorder(load_parts) as load_phases:
            t0 = time.perf_counter()
            back = persist.load(root, device=device)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        check(back.store_health.status == "ok", "the saved store loads healthy")
        check(all(t.device == back.device and type(t).__name__ == "IndexTable"
                  for t in back._tables.values()), "the load builds every table on the card")
        k1 = BLOCK_SCAN.launches
        run_queries(back, queries[:4])  # warm the loaded store's first calls
        lat_after, outs_after, _ = run_queries(back, queries)
        check(BLOCK_SCAN.launches > k1, "the loaded store's queries launch K1")
        for (q, _), a, b in zip(queries, ids_of(outs_after), want):
            check(np.array_equal(a, b), f"loaded ids identical and in order: {q}")
        g2, e2, c2 = aggregates(back)
        check(all(np.array_equal(a, b) for a, b in zip(g2, grids)), "loaded density grids")
        check(e2 == envs, "loaded bounds, both modes")
        check(c2 == ests, "loaded count estimates")
        many = back.query_many("gdelt", [q for q, _ in queries])
        check(all(np.array_equal(a, b) for a, b in zip(ids_of(many), want)),
              "query_many on the loaded store, in order")
        del back, outs_after, many
        torch.cuda.empty_cache()

        # an append in the span's last 21 days and an incremental save
        rows = append_rows(N_PERSIST, N_PERSIST_APPEND, SEED + 76)
        append_s = write_rows(ds, rows)
        t0 = time.perf_counter()
        persist.save(ds, root)
        save2_s = time.perf_counter() - t0
        parts2 = manifest_parts(root)
        touched = {f"p{int(p)}" for p in np.unique(rows[3] // persist.PARTITION_MS)}
        rewritten = {k for k, e in parts2.items() if files1.get(k) != e["file"]}
        check(rewritten == touched, f"only the touched partitions {sorted(touched)} rewritten")
        check(set(os.listdir(os.path.join(root, "gdelt"))) ==
              {e["file"] for e in parts2.values()}, "the replaced files were collected")
        t0 = time.perf_counter()
        full = persist.load(root, device=device)
        load2_s = time.perf_counter() - t0
        n_all = N_PERSIST + N_PERSIST_APPEND
        check(full.row_count("gdelt") == n_all and np.array_equal(
            np.sort(np.asarray(full.features("gdelt").ids, np.int64)), np.arange(n_all)),
            "the incremental save reads back whole")
        full_ids = ids_of(full.query("gdelt", q) for q, _ in queries)
        cur_ids = ids_of(ds.query("gdelt", q) for q, _ in queries)
        check(all(np.array_equal(np.sort(a), np.sort(b)) for a, b in zip(full_ids, cur_ids)),
              "the reloaded store answers as the in-memory one")
        del full
        torch.cuda.empty_cache()

        # one flipped byte in one committed partition, not one the append touched
        bad_key = sorted(set(parts2) - touched, key=lambda k: int(k[1:]))[0]
        bad_file = os.path.join(root, "gdelt", parts2[bad_key]["file"])
        with open(bad_file, "rb+") as fh:
            size = os.path.getsize(bad_file)
            fh.seek(size // 2)
            b = fh.read(1)
            fh.seek(size // 2)
            fh.write(bytes([b[0] ^ 0x20]))
        reg = MetricsRegistry()
        t0 = time.perf_counter()
        degraded = persist.load(root, device=device, metrics=reg)
        load3_s = time.perf_counter() - t0
        health = degraded.store_health
        check(health.status == "degraded" and [d.reason for d in health.damage] == ["checksum"]
              and health.damage[0].file == parts2[bad_key]["file"],
              "one checksum record for the flipped partition")
        check(reg.counter_value("geomesa.store.quarantined") == 1, "the quarantine is counted")
        check(os.path.exists(os.path.join(root, "_quarantine", "report.json"))
              and not os.path.exists(bad_file), "the damaged file moved to _quarantine/")
        warning = health.warning_for("gdelt")
        x, y, t = src
        _, ax, ay, at, _ = rows
        x_all, y_all, t_all = (np.concatenate(v) for v in ((x, ax), (y, ay), (t, at)))
        lost = (t_all // persist.PARTITION_MS) == int(bad_key[1:])
        check(degraded.row_count("gdelt") == n_all - int(lost.sum()),
              "the degraded store holds every other partition's rows")
        for (q, box), ids in zip(queries, full_ids):
            check(degraded.planner.plan("gdelt", q).warnings == [warning],
                  f"the plan over the degraded type warns: {q}")
            got = np.asarray(degraded.query("gdelt", q).ids, np.int64)
            check(np.array_equal(got, ids[~lost[ids]]),
                  f"degraded ids: the whole store's minus the partition's, in order: {q}")
            check(np.array_equal(np.sort(got),
                                 np.setdiff1d(brute_ids((x_all, y_all, t_all), box),
                                              np.flatnonzero(lost))),
                  f"degraded ids vs the f64 brute force over the source columns: {q}")
        check(reg.counter_value("geomesa.query.degraded") == len(queries),
              "geomesa.query.degraded counts every degraded query")
        del degraded
        torch.cuda.empty_cache()
        crash = crash_points(torch, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del ds, outs
    torch.cuda.empty_cache()

    hds, _, host_ingest_s = build_store(torch, device, N_PERSIST, with_root_code=True,
                                        seed=SEED + 70, adapter=HostAdapter())
    check(all(t.nbytes_device == 0 for t in hds._tables.values()),
          "the host adapter keeps nothing on the card")
    lat_host, outs_host, _ = run_queries(hds, queries)
    for (q, _), a, b in zip(queries, ids_of(outs_host), want):
        check(np.array_equal(a, b), f"the host adapter's ids equal the device store's: {q}")
    del hds, outs_host
    witness = witness_workload(torch, device)
    launches = read_launches()
    torch.cuda.empty_cache()
    return {
        "phase": "persist_path", "cell": "gdelt-z3-10M-persist", "launches": launches,
        "native": read_native(),
        "reduced": {"n_points": {"cell": 10_000_000, "run": N_PERSIST}},
        "n_points": N_PERSIST, "n_append": N_PERSIST_APPEND, "n_queries": len(queries),
        "ingest_s": ingest_s, "append_s": append_s,
        "save_s": save_s, "load_s": load_s, "save_incremental_s": save2_s,
        "save_phase_s": save_phases, "load_phase_s": load_phases,
        "load_after_append_s": load2_s, "load_degraded_s": load3_s,
        "bytes_on_disk": bytes1, "bytes_on_disk_after_append": sum(
            e["bytes"] for e in parts2.values()),
        "bytes_per_row": bytes1 / N_PERSIST,
        "partitions_written": len(parts1),
        "partitions_rewritten_by_append": len(rewritten),
        "partitions_reused_by_append": len(parts2) - len(rewritten),
        "partitions_quarantined": len(health.damage), "rows_quarantined": int(lost.sum()),
        "latency_p50_ms_before_load": float(np.percentile(lat_before, 50) * 1e3),
        "latency_p50_ms_after_load": float(np.percentile(lat_after, 50) * 1e3),
        "latency_p50_ms_host_adapter": float(np.percentile(lat_host, 50) * 1e3),
        "host_adapter_ingest_s": host_ingest_s,
        "crash_points": crash, "witness": witness,
    }


# -- statistics, visibility, federated views and the cache tier --------------

# the cell's 10M rows cut to 3M for the script's wall once paths 22-24
# came, to 2M once the pod path came (the record's ``reduced``)
N_SECURE = 2_000_000
N_SECURE_AGG = 4
N_TILE_VIEWS = 4  # dashboard views, each panned 8 times: 32 tile boxes
# the cache section's rows: a seeded prefix of the path's rows (1M since
# PR 19, for the script's wall)
N_SECURE_CACHE = 1_000_000
N_SECURE_WRITE = 50_000
N_SECURE_FOLD = 10_000  # half replace rows in the fold box, half are new ids
N_SERVE_THREADS = 8
# the result cache sized to the dashboard's working set: the 64 queries'
# rows and the 32 boxes' (a box count the tile tier's cost gate declines
# answers through the row path, whose result the cache admits: up to
# ~100 MB a box at 10M rows); the default 256 MB would evict the measured
# entries before the scoped-invalidation checks read them
SECURE_CACHE_BYTES = 4 << 30
SECURE_SPEC = "EventRootCode:String:vis=secret,vis:String,dtg:Date,*geom:Point:srid=4326"
# the label mix of the shared event store, and the four analysts' auths
VIS_LABELS = np.array(["", "analyst", "analyst&secret", "secret|ops", "ops"])
VIS_SHARES = (0.50, 0.20, 0.15, 0.10, 0.05)
SECURE_AUTHS = {"none": None, "public": (), "analyst": ("analyst",),
                "analyst-secret": ("analyst", "secret")}
SECURE_WRITE_BOX = (100.0, -10.0, 115.0, 0.0)
SECURE_FOLD_BOX = (-75.0, 35.0, -65.0, 45.0)
SECURE_DELETE_BOX = (10.0, 40.0, 20.0, 50.0)
SECURE_DRIFT_BOX = (-20.0, -40.0, 0.0, -20.0)  # the rows a fold moves away (stale stats)
SECURE_AGE_OFF_MS = 7 * 86_400_000


def secure_rows(n, seed):
    """The path's rows: GDELT-shaped points and times, ``EventRootCode``,
    and a ``vis`` label drawn from its own seed (label index in
    ``vis_idx``)."""
    rng = np.random.default_rng(seed)
    x, y = gdelt_points(n, rng)
    t = T0_MS + rng.integers(0, SPAN_MS, n)
    vis_idx = np.random.default_rng(seed + 1).choice(len(VIS_LABELS), n, p=VIS_SHARES)
    return {"ids": np.arange(n), "x": x, "y": y, "t": t, "codes": root_codes(n, seed + 7),
            "vis_idx": vis_idx, "vis": VIS_LABELS[vis_idx]}


def label_visible(vis_idx, auths) -> np.ndarray:
    """The script's own label evaluator (not the port's): each of the five
    labels written out by hand."""
    if auths is None:
        return np.ones(len(vis_idx), bool)
    a = set(auths)
    lut = np.array([True, "analyst" in a, "analyst" in a and "secret" in a,
                    "secret" in a or "ops" in a, "ops" in a])
    return lut[vis_idx]


def secure_fc(sft, r, sel=None):
    from geomesa_tpu_torch import FeatureCollection

    if sel is not None:
        r = {k: v[sel] for k, v in r.items()}
    return FeatureCollection.from_columns(sft, r["ids"], {
        "EventRootCode": r["codes"], "vis": r["vis"], "dtg": r["t"], "geom": (r["x"], r["y"])})


def secure_store(torch, device, rows, sel=None, auths=None, cache=None):
    """A Z3 + Z2 store of ``rows`` (or the ``sel`` subset) whose schema
    names the ``vis`` label field; returns (store, ingest seconds)."""
    from geomesa_tpu_torch import DataStore, FeatureType
    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.security import VIS_FIELD_KEY

    sft = FeatureType.from_spec("gdelt", SECURE_SPEC)
    sft.user_data["geomesa.indices.enabled"] = "z3,z2"
    sft.user_data[VIS_FIELD_KEY] = "vis"
    ds = DataStore(device=device, auths=auths, cache=cache, metrics=MetricsRegistry())
    ds.create_schema(sft)
    t0 = time.perf_counter()
    ds.write("gdelt", secure_fc(sft, rows, sel), check_ids=False)
    torch.cuda.synchronize()
    return ds, time.perf_counter() - t0


def launch_delta(before: dict) -> dict:
    now = read_launches()
    return {k: now[k] - before[k] for k in now}


def exact_env(x, y, ids):
    if not len(ids):
        return None
    return (float(x[ids].min()), float(y[ids].min()), float(x[ids].max()), float(y[ids].max()))


def secure_stats_checks(ds, rows, measured, brute) -> dict:
    """The sketches after the write against numpy, and estimate_count's
    error factor for each measured query against its exact count."""
    from geomesa_tpu_torch.obs.accuracy import error_factor

    st = ds.stats_for("gdelt")
    x, y, t = rows["x"], rows["y"], rows["t"]
    check(st.total_count() == len(x), "stats_for counts every row")
    for name, col in (("geom.x", x), ("geom.y", y), ("dtg", t)):
        check(st.attribute_bounds(name) == (col.min(), col.max()), f"stats_for min/max of {name}")
    for attr, col in (("EventRootCode", rows["codes"]), ("vis", rows["vis"])):
        vals, cnts = np.unique(col, return_counts=True)
        want = sorted(zip(vals.tolist(), cnts.tolist()), key=lambda kv: -kv[1])[:10]
        check(st.topk[attr].top() == want, f"stats_for top-k of {attr}")
    errs, ests = [], []
    t0 = time.perf_counter()
    for (q, _), ids in zip(measured, brute):
        est = ds.estimate_count("gdelt", q)
        ests.append(est)
        errs.append(error_factor(est, len(ids)))
    est_s = time.perf_counter() - t0
    return {"estimate_error_median": float(np.median(errs)),
            "estimate_error_p90": float(np.percentile(errs, 90)),
            "estimate_error_max": float(np.max(errs)),
            "estimate_ms_per_query": est_s / len(measured) * 1e3,
            "estimates_vs_exact": [[int(e), int(len(b))] for e, b in zip(ests[:8], brute[:8])]}


def secure_aggregations(ds, rows, busy, brute_busy, auths) -> list:
    """count, both Count() forms, density, both bounds over the busiest
    queries; on a visibility store every answer equals the host brute
    force over the rows its auths see."""
    from geomesa_tpu_torch.planning.explain import Explainer

    x, y = rows["x"], rows["y"]
    out = []
    for (q, box), ids in zip(busy, brute_busy):
        seen = ids[label_visible(rows["vis_idx"][ids], auths)]
        exp = Explainer()
        res = (ds.count("gdelt", q),
               ds.stats_query("gdelt", "Count()", q, estimate=True, explain=exp)[0].count,
               ds.stats_query("gdelt", "Count()", q)[0].count,
               ds.density("gdelt", q, envelope=box[:4], width=256, height=256, explain=exp),
               ds.bounds("gdelt", q, estimate=True, explain=exp),
               ds.bounds("gdelt", q, estimate=False))
        check(res[0] == res[2] == len(seen), f"count and Count() vs brute force ({auths}): {q}")
        check(res[5] == exact_env(x, y, seen), f"exact bounds vs brute force ({auths}): {q}")
        vis_lines = [l for l in exp.lines if "fast path disabled" in l]
        if auths is not None:
            check(res[1] == len(seen), f"Count() estimate under visibility is exact: {q}")
            check(np.array_equal(res[3], host_density(x[seen], y[seen], box[:4], 256, 256)),
                  f"density under visibility vs brute force ({auths}): {q}")
            check(res[4] == res[5], f"bounds estimate under visibility is exact: {q}")
            check(len(vis_lines) == 3, f"explain signals each visibility fallback: {q}")
        else:
            check(res[1] >= len(seen) and not vis_lines, f"Count() estimate covers the hits: {q}")
        out.append(res)
    return out


def visibility_checks(torch, device, rows, base, measured, base_outs, brute, busy_idx) -> dict:
    """Four stores over the same rows (auths None is ``base``): the
    measured queries' ids in order equal the None store's filtered by the
    script's evaluator (the None store's ids equal the brute force), the
    aggregations equal the host brute force over the visible rows, K1p,
    K3 and K4 launch only on the None store, and a filter on the
    ``vis=secret`` attribute raises without ``secret``."""
    from geomesa_tpu_torch.kernels import BLOCK_SCAN_MULTI
    from geomesa_tpu_torch.planning.errors import QueryGuardError

    busy = [measured[k] for k in busy_idx]
    brute_busy = [brute[k] for k in busy_idx]
    code_q = f"EventRootCode = '01' AND {busy[0][0]}"
    code_ids = brute_busy[0][rows["codes"][brute_busy[0]] == "01"]
    out = {"vis_fallback": {}, "aggregation_launches": {}, "latency_p50_ms": {},
           "query_many_k2": {}, "ingest_s": {}}
    for name, auths in SECURE_AUTHS.items():
        if auths is None:
            ds = base
        else:
            ds, out["ingest_s"][name] = secure_store(torch, device, rows, auths=auths)
        lat, outs, _ = run_queries(ds, measured)
        out["latency_p50_ms"][name] = float(np.percentile(lat, 50) * 1e3)
        for (q, _), got, ref, ids in zip(measured, outs, base_outs, brute):
            got = np.asarray(got.ids, np.int64)
            want = np.asarray(ref.ids, np.int64)
            want = want[label_visible(rows["vis_idx"][want], auths)]
            check(np.array_equal(got, want), f"ids in order under auths {auths}: {q}")
            check(np.array_equal(np.sort(got), ids[label_visible(rows["vis_idx"][ids], auths)]),
                  f"ids vs the masked f64 brute force under auths {auths}: {q}")
        k2 = BLOCK_SCAN_MULTI.launches
        many = ds.query_many("gdelt", [q for q, _ in measured])
        out["query_many_k2"][name] = BLOCK_SCAN_MULTI.launches - k2
        check(out["query_many_k2"][name] > 0, f"query_many under auths {auths} launches K2")
        check_same_ids(many, outs, f"query_many under auths {auths}")
        fallback0 = ds.metrics.counter_value("geomesa.query.vis_fallback")
        before = read_launches()
        secure_aggregations(ds, rows, busy, brute_busy, auths)
        d = launch_delta(before)
        out["aggregation_launches"][name] = d
        out["vis_fallback"][name] = ds.metrics.counter_value("geomesa.query.vis_fallback") - fallback0
        aggs = (d["block_pops"], d["density"], d["bounds"])
        if auths is None:
            check(all(a > 0 for a in aggs) and out["vis_fallback"][name] == 0,
                  "the None store's aggregations launch K1p, K3 and K4")
        else:
            check(aggs == (0, 0, 0) and d["block_scan"] > 0,
                  f"no K1p, K3 or K4 launch with visibility active ({auths}); K1 scans")
            check(out["vis_fallback"][name] == 3 * len(busy),
                  f"geomesa.query.vis_fallback counts each aggregation ({auths})")
        hidden = auths is not None and "secret" not in auths
        check(("EventRootCode" in outs[0].columns) != hidden,
              f"EventRootCode projected out exactly for auths without secret ({auths})")
        if hidden:
            try:
                ds.query("gdelt", code_q)
                raised = False
            except QueryGuardError:
                raised = True
            check(raised, f"a filter on EventRootCode raises for auths {auths}")
        else:
            got = np.sort(np.asarray(ds.query("gdelt", code_q).ids, np.int64))
            want = code_ids[label_visible(rows["vis_idx"][code_ids], auths)]
            check(np.array_equal(got, want), f"EventRootCode filter under auths {auths}")
        if ds is not base:
            del ds, many
            torch.cuda.empty_cache()
    return out


def view_checks(torch, device, rows, base, measured, base_outs, busy_idx) -> dict:
    """Two stores split by id parity: a MergedView gives the whole
    store's ids as a set, its counts, density grids and both bounds; a
    RoutedView by time half answers each query as the store it routes
    to."""
    from geomesa_tpu_torch.filter.extract import extract_intervals
    from geomesa_tpu_torch.views import MergedView, RoutedView

    even, s_even = secure_store(torch, device, rows, sel=rows["ids"] % 2 == 0)
    odd, s_odd = secure_store(torch, device, rows, sel=rows["ids"] % 2 == 1)
    merged = MergedView([even, odd], "gdelt")
    t0 = time.perf_counter()
    for (q, _), ref in zip(measured, base_outs):
        got = np.sort(np.asarray(merged.query(q).ids, np.int64))
        check(np.array_equal(got, np.sort(np.asarray(ref.ids, np.int64))),
              f"MergedView ids equal the whole store's as a set: {q}")
    merged_s = time.perf_counter() - t0
    for k in busy_idx:
        q, box = measured[k]
        check(merged.count(q) == len(base_outs[k]), f"MergedView count: {q}")
        check(np.array_equal(merged.density(q, envelope=box[:4], width=256, height=256),
                             base.density("gdelt", q, envelope=box[:4], width=256, height=256)),
              f"MergedView density grid: {q}")
        for est in (True, False):
            check(merged.bounds(q, estimate=est) == base.bounds("gdelt", q, estimate=est),
                  f"MergedView bounds (estimate={est}): {q}")
    mid = T0_MS + SPAN_MS // 2

    def by_half(f):
        iv = extract_intervals(f, "dtg")
        return None if not iv.values else int(max(i.hi for i in iv.values) > mid)

    routed = RoutedView([even, odd], "gdelt", by_half, default=0)
    routes = [0, 0]
    for q, (_, _, _, _, lo, hi) in measured:
        target = int(hi > mid)
        routes[target] += 1
        want = (even, odd)[target].query("gdelt", q)
        check(np.array_equal(np.asarray(routed.query(q).ids), np.asarray(want.ids)),
              f"RoutedView answers as the store it routes to: {q}")
    del even, odd, merged, routed
    torch.cuda.empty_cache()
    return {"ingest_s": s_even + s_odd, "merged_ms_per_query": merged_s / len(measured) * 1e3,
            "routes": routes}


def tile_boxes(seed):
    """Dashboard boxes: N_TILE_VIEWS views of 30-60 degrees, each panned 8
    times by up to a tenth of its size (the repeated and shifted bboxes a
    dashboard sends), as (ecql, box)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_TILE_VIEWS):
        w = float(rng.uniform(30, 60))
        h = w / 2
        cx, cy = float(rng.uniform(-150 + w, 150 - w)), float(rng.uniform(-60 + h, 60 - h))
        for _ in range(8):
            x0 = round(cx - w / 2 + float(rng.uniform(-0.1, 0.1)) * w, 4)
            y0 = round(cy - h / 2 + float(rng.uniform(-0.1, 0.1)) * h, 4)
            box = (x0, y0, round(x0 + w, 4), round(y0 + h, 4))
            out.append((f"bbox(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]})", box))
    return out


def cell_span(box):
    from geomesa_tpu_torch.cache.generations import _cell_span

    return _cell_span(box)


def spans_meet(a, b) -> bool:
    return not (a[1] < b[0] or b[1] < a[0] or a[3] < b[2] or b[3] < a[2])


def cached_queries(ds, model, measured, op):
    """Every measured query through the cache, against a bypass query (ids
    in order) and the model's brute force; returns (per-query status,
    latencies): "hit", "invalidated" (a miss whose entry a mutation
    invalidated) or "miss" (no entry under the query's key: evicted, or a
    new key, when the mutation changed the plan's index choice)."""
    from geomesa_tpu_torch.planning.hints import QueryHints

    status, lat = [], []
    m = ds.metrics
    for q, (x0, y0, x1, y1, lo, hi) in measured:
        h0 = m.counter_value("geomesa.cache.hit")
        i0 = m.counter_value("geomesa.cache.invalidation")
        s = time.perf_counter()
        got = ds.query("gdelt", q)
        lat.append(time.perf_counter() - s)
        status.append("hit" if m.counter_value("geomesa.cache.hit") > h0 else
                      "invalidated" if m.counter_value("geomesa.cache.invalidation") > i0 else
                      "miss")
        ref = ds.query("gdelt", q, hints=QueryHints(cache="bypass"))
        check(np.array_equal(np.asarray(got.ids), np.asarray(ref.ids)),
              f"after {op}: the cached answer equals a bypass query, in order: {q}")
        check(np.array_equal(np.sort(np.asarray(got.ids, np.int64)),
                             model.hits((x0, y0, x1, y1), lo, hi)),
              f"after {op}: the cached answer equals the brute force: {q}")
    return status, np.array(lat)


def tile_pass(ds, model, boxes, op) -> dict:
    """count and bounds of every tile box against the model; returns the
    tile counters' movement."""
    m = ds.metrics
    r0, f0 = m.counter_value("geomesa.cache.tile.reused"), m.counter_value("geomesa.cache.tile.filled")
    s = time.perf_counter()
    for q, box in boxes:
        ids = model.hits(box)
        check(ds.count("gdelt", q) == len(ids), f"{op}: tile-composed count vs brute force: {q}")
        check(ds.bounds("gdelt", q, estimate=False) == exact_env(model.x, model.y, ids),
              f"{op}: tile-composed bounds vs brute force: {q}")
    return {"reused": m.counter_value("geomesa.cache.tile.reused") - r0,
            "filled": m.counter_value("geomesa.cache.tile.filled") - f0,
            "ms_per_box": (time.perf_counter() - s) / len(boxes) * 1e3}


def cache_checks(torch, device, rows, measured, base_outs) -> dict:
    """DataStore(cache=True) over the same rows: cold then warm (64 result
    hits, no K1 launch), tile-composed counts and bounds twice, then a
    fold, a write and a delete, each followed by every query against a
    bypass query and the brute force (entries away from the mutated
    region stay hits), then save and load with the warm cache."""
    import shutil

    from geomesa_tpu_torch.cache import collection_nbytes
    from geomesa_tpu_torch.storage import persist

    from geomesa_tpu_torch import conf

    n = len(rows["x"])
    conf.CACHE_MAX_BYTES.set(SECURE_CACHE_BYTES)
    try:
        ds, ingest_s = secure_store(torch, device, rows, cache=True)
    finally:
        conf.CACHE_MAX_BYTES.clear()
    m = ds.metrics
    steps = {}
    before = read_launches()
    lat_cold, cold, _ = run_queries(ds, measured)
    steps["cold"] = launch_delta(before)
    check(steps["cold"]["block_scan"] > 0, "the cold pass launches K1")
    h0 = m.counter_value("geomesa.cache.hit")
    before = read_launches()
    lat_warm, warm, _ = run_queries(ds, measured)
    steps["warm"] = launch_delta(before)
    check(m.counter_value("geomesa.cache.hit") - h0 == len(measured),
          f"the warm pass: 64 result hits ({len(ds.cache.result)} entries, "
          f"{ds.cache.result.bytes_resident} bytes)")
    check(steps["warm"]["block_scan"] == 0, "the warm pass launches no K1")
    for (q, _), w, c, b in zip(measured, warm, cold, base_outs):
        check(np.array_equal(np.asarray(w.ids), np.asarray(c.ids)),
              f"warm ids identical to cold, in order: {q}")
        check(np.array_equal(np.asarray(c.ids), np.asarray(b.ids)),
              f"the cached store's ids equal the uncached store's, in order: {q}")

    model = PointModel(n + N_SECURE_WRITE + N_SECURE_FOLD, rows["x"], rows["y"], rows["t"], n)
    boxes = tile_boxes(SEED + 84)
    before = read_launches()
    tiles = {"pass1": tile_pass(ds, model, boxes, "pass 1"),
             "pass2": tile_pass(ds, model, boxes, "pass 2")}
    steps["tiles"] = launch_delta(before)
    check(tiles["pass2"]["reused"] > 0, "the second pass reuses tiles")

    sft = ds.get_schema("gdelt")
    rng = np.random.default_rng(SEED + 85)
    spans = [cell_span(box[:4]) for _, box in measured]
    mutations = {}

    def mutate(op, fn, regions):
        before = read_launches()
        e0 = m.counter_value("geomesa.cache.eviction")
        s = time.perf_counter()
        fn()
        mut_s = time.perf_counter() - s
        status, lat = cached_queries(ds, model, measured, op)
        away = [k for k, sp in enumerate(spans)
                if not any(spans_meet(sp, cell_span(r)) for r in regions)]
        tile = tile_pass(ds, model, boxes, f"after {op}")
        steps[op] = launch_delta(before)
        mutations[op] = {"seconds": mut_s, "hits": status.count("hit"),
                         "invalidated": status.count("invalidated"), "away": len(away),
                         "away_hits": sum(status[k] == "hit" for k in away),
                         "away_invalidated": sum(status[k] == "invalidated" for k in away),
                         "evictions": m.counter_value("geomesa.cache.eviction") - e0,
                         "bytes": ds.cache.result.bytes_resident,
                         "entries": len(ds.cache.result),
                         "p50_ms": float(np.percentile(lat, 50) * 1e3), "tiles": tile}
        return away, status

    def scoped(op, away, status):
        """Scoped invalidation: no entry away from the mutated box was
        invalidated (the away queries that miss have a new key: the
        mutation moved their plan to the other index, counted in
        ``away_hits``)."""
        rec = mutations[op]
        check(rec["away_invalidated"] == 0 and rec["away_hits"] > 0,
              f"after the {op}, no entry away from its box is invalidated ({rec})")

    # the fold: half the batch replaces rows inside the fold box, half are
    # new ids, all placed in the box
    fx0, fy0, fx1, fy1 = SECURE_FOLD_BOX
    in_box = model.hits(SECURE_FOLD_BOX)
    k_old = min(N_SECURE_FOLD // 2, len(in_box))
    fold_ids = np.concatenate([rng.choice(in_box, k_old, replace=False),
                               n + np.arange(N_SECURE_FOLD - k_old)])
    f_rows = {"ids": fold_ids, "x": rng.uniform(fx0, fx1, len(fold_ids)),
              "y": rng.uniform(fy0, fy1, len(fold_ids)),
              "t": T0_MS + rng.integers(0, SPAN_MS, len(fold_ids)),
              "codes": root_codes(len(fold_ids), SEED + 86),
              "vis": np.full(len(fold_ids), "")}

    def fold():
        ds.fold_upsert("gdelt", secure_fc(sft, f_rows))
        model.set(fold_ids, f_rows["x"], f_rows["y"], f_rows["t"])

    scoped("fold_upsert", *mutate("fold_upsert", fold, [SECURE_FOLD_BOX]))

    wx0, wy0, wx1, wy1 = SECURE_WRITE_BOX
    w_ids = n + N_SECURE_FOLD + np.arange(N_SECURE_WRITE)
    w_rows = {"ids": w_ids, "x": rng.uniform(wx0, wx1, N_SECURE_WRITE),
              "y": rng.uniform(wy0, wy1, N_SECURE_WRITE),
              "t": T0_MS + rng.integers(0, SPAN_MS, N_SECURE_WRITE),
              "codes": root_codes(N_SECURE_WRITE, SEED + 87),
              "vis": np.full(N_SECURE_WRITE, "analyst")}

    def write():
        ds.write("gdelt", secure_fc(sft, w_rows), check_ids=False)
        model.set(w_ids, w_rows["x"], w_rows["y"], w_rows["t"])

    scoped("write", *mutate("write", write, [SECURE_WRITE_BOX]))

    def delete():
        x0, y0, x1, y1 = SECURE_DELETE_BOX
        gone = model.hits(SECURE_DELETE_BOX)
        check(ds.delete_features("gdelt", f"bbox(geom, {x0}, {y0}, {x1}, {y1})") == len(gone),
              "delete_features removes the box's rows")
        model.alive[gone] = False

    # the delete rebuilds every table (a major compaction), and a table
    # build bumps the whole type's generation: every entry fills again
    mutate("delete_features", delete, [SECURE_DELETE_BOX])

    root = tempfile.mkdtemp(prefix="geomesa_cache_")
    try:
        last = [np.sort(np.asarray(o.ids, np.int64)) for o in run_queries(ds, measured)[1]]
        entries = len(ds.cache.result)
        s = time.perf_counter()
        persist.save(ds, root)
        back = persist.load(root, device=device, cache=ds.cache, metrics=m)
        torch.cuda.synchronize()
        reload_s = time.perf_counter() - s
        check(back.cache is ds.cache, "the loaded store takes the warm cache")
        h0, mi0 = m.counter_value("geomesa.cache.hit"), m.counter_value("geomesa.cache.miss")
        before = read_launches()
        _, outs, _ = run_queries(back, measured)
        steps["after_load"] = launch_delta(before)
        reload_hits = m.counter_value("geomesa.cache.hit") - h0
        check(reload_hits == 0 and m.counter_value("geomesa.cache.miss") - mi0 == len(measured),
              "after the load every entry is revalidated: no stale hit")
        for (q, _), o, want in zip(measured, outs, last):
            check(np.array_equal(np.sort(np.asarray(o.ids, np.int64)), want),
                  f"the loaded store answers as before the save: {q}")
        del back
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record = {
        "ingest_s": ingest_s, "warm_entries": len(warm), "cold_result_bytes":
        sum(collection_nbytes(o) for o in cold),
        "latency_p50_ms_cold": float(np.percentile(lat_cold, 50) * 1e3),
        "latency_p50_ms_warm": float(np.percentile(lat_warm, 50) * 1e3),
        "latency_p99_ms_cold": float(np.percentile(lat_cold, 99) * 1e3),
        "latency_p99_ms_warm": float(np.percentile(lat_warm, 99) * 1e3),
        "tiles": tiles, "mutations": mutations, "entries_before_save": entries,
        "save_load_s": reload_s, "launches_by_step": steps,
        "counters": {k: v for k, v in sorted(m.counters.items()) if k.startswith("geomesa.cache")},
    }
    del ds
    torch.cuda.empty_cache()
    return record


def cache_section(torch, device, rows, measured) -> dict:
    """The cache checks on the first ``N_SECURE_CACHE`` of the path's
    seeded rows: an uncached store of that subset answers the 64 queries
    (held against the f64 brute force over the subset), and cache_checks
    holds the cached store's answers to it."""
    n = min(N_SECURE_CACHE, len(rows["x"]))
    sub = {k: v[:n] for k, v in rows.items()}
    s = time.perf_counter()
    ref, _ = secure_store(torch, device, sub)
    _, ref_outs, _ = run_queries(ref, measured)
    src = (sub["x"], sub["y"], sub["t"])
    for (q, box), o in zip(measured, ref_outs):
        check(np.array_equal(np.sort(np.asarray(o.ids, np.int64)), brute_ids(src, box)),
              f"the cache section's uncached store vs the f64 brute force: {q}")
    ref_s = time.perf_counter() - s
    del ref
    torch.cuda.empty_cache()
    out = cache_checks(torch, device, sub, measured, ref_outs)
    out.update({"n_points": n, "reference_store_s": ref_s})
    return out


def stats_mutation_checks(torch, base, rows, measured) -> dict:
    """On the None store: delete_features of one region and age_off of the
    span's first 7 days, then analyze_stats equals a StatsStore.build of
    the surviving numpy rows; then a fold that moves the rows of one
    region away (the sketches only accumulate) and, with auto-analyze on
    and a stale window forced, one query from each of 8 serve() threads:
    exactly one analyze trips."""
    import threading

    from geomesa_tpu_torch import conf
    from geomesa_tpu_torch.stats import StatsStore

    x0, y0, x1, y1 = SECURE_DELETE_BOX
    base.delete_features("gdelt", f"bbox(geom, {x0}, {y0}, {x1}, {y1})")
    base.age_off("gdelt", ttl_ms=0, now_ms=T0_MS + SECURE_AGE_OFF_MS)
    x, y, t = rows["x"], rows["y"], rows["t"]
    keep = ~((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)) & (t >= T0_MS + SECURE_AGE_OFF_MS)
    check(base.row_count("gdelt") == int(keep.sum()), "delete and age-off leave the survivors")
    s = time.perf_counter()
    fresh = base.analyze_stats("gdelt")
    analyze_s = time.perf_counter() - s
    want = StatsStore.build(base.get_schema("gdelt"), secure_fc(base.get_schema("gdelt"), rows, keep))
    check(fresh.to_json() == want.to_json(), "analyze_stats equals a build of the survivors")
    for k, h in want.histograms.items():
        g = fresh.histograms[k]
        check((g.lo, g.hi) == (h.lo, h.hi) and np.array_equal(g.counts, h.counts),
              f"analyze_stats histogram {k} equals the survivors'")
    for k, f in want.frequencies.items():
        check(np.array_equal(fresh.frequencies[k].table, f.table), f"frequency sketch {k}")

    # move every row of the drift box away: estimates over it go stale
    dx0, dy0, dx1, dy1 = SECURE_DRIFT_BOX
    live = np.flatnonzero(keep)
    moved = live[(x[live] >= dx0) & (x[live] <= dx1) & (y[live] >= dy0) & (y[live] <= dy1)]
    sft = base.get_schema("gdelt")
    drift = {k: v[moved] for k, v in rows.items()}
    drift["x"] = drift["x"] + 120.0  # into the eastern Indian Ocean
    base.fold_upsert("gdelt", secure_fc(sft, drift))
    sub = [f"bbox(geom, {dx0 + i}, {dy0 + i}, {dx0 + i + 8}, {dy0 + i + 8})"
           for i in range(N_SERVE_THREADS)]  # inside the drift box
    index = base.planner.plan("gdelt", sub[0]).index
    conf.PLAN_ESTIMATE_AUTO_ANALYZE.set(True)
    conf.PLAN_ESTIMATE_MIN_COUNT.set(8)
    analyze0 = base.metrics.counter_value("geomesa.plan.estimate.analyze")
    for _ in range(8):  # a stale window: eight recorded 1000x misestimates
        base.accuracy.record("gdelt", index, 1000.0, 0.0)
    check(any(tn == "gdelt" for tn, _, _ in base.accuracy.stale()), "the forced window is stale")
    sched = base.serve()
    barrier = threading.Barrier(N_SERVE_THREADS)
    served = [None] * N_SERVE_THREADS

    def client(i):
        barrier.wait()
        served[i] = sched.submit("gdelt", sub[i]).result(600)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(N_SERVE_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        base.close()
        conf.PLAN_ESTIMATE_AUTO_ANALYZE.clear()
        conf.PLAN_ESTIMATE_MIN_COUNT.clear()
    trips = base.metrics.counter_value("geomesa.plan.estimate.analyze") - analyze0
    check(all(len(o) == 0 for o in served), "the drifted region is empty")
    check(trips == 1, f"eight serve() threads trip exactly one analyze ({trips})")
    return {"analyze_s": analyze_s, "survivors": int(keep.sum()), "drift_rows": int(len(moved)),
            "auto_analyze_trips": trips, "accuracy_report": base.accuracy.report()["indexes"]}


def secure_cached_path(torch, device) -> dict:
    """gdelt-z3-10M-secure-cached: N_SECURE GDELT-shaped events on Z3 and Z2
    with ``EventRootCode`` (declared ``vis=secret``) and a ``vis`` label
    column (50 % public, 20 % ``analyst``, 15 % ``analyst&secret``, 10 %
    ``secret|ops``, 5 % ``ops``): analysts with different clearances
    query one shared event store, and dashboards repeat the same queries
    and counts. Statistics (stats_for against numpy, estimate_count's
    error factors over the 64 main queries, analyze_stats after a delete
    and an age-off, one auto-analyze trip under 8 serve() threads),
    visibility (four stores by auths: ids in order, aggregations against
    the host brute force, the device aggregations launching only without
    auths), views (a MergedView and a RoutedView over the rows split by
    id parity) and the cache tier (cold and warm, tile composition,
    scoped invalidation after a fold, a write and a delete, a reload with
    the warm cache). Launch and native counts are zeroed before, read
    after."""
    zero_launches()
    t_path = time.perf_counter()
    rows = secure_rows(N_SECURE, SEED + 80)
    base, ingest_s = secure_store(torch, device, rows)
    measured = query_set(SEED + 2, N_MEASURED)
    src = (rows["x"], rows["y"], rows["t"])
    brute = [brute_ids(src, box) for _, box in measured]
    lat, base_outs, _ = run_queries(base, measured)
    for (q, _), o, ids in zip(measured, base_outs, brute):
        check(np.array_equal(np.sort(np.asarray(o.ids, np.int64)), ids),
              f"the None store's ids vs the f64 brute force: {q}")
    busy_idx = list(np.argsort([-len(b) for b in brute], kind="stable")[:N_SECURE_AGG])
    sections = {"build_and_check": time.perf_counter() - t_path}

    def timed(name, fn, *a):
        s = time.perf_counter()
        out = fn(*a)
        sections[name] = time.perf_counter() - s
        return out

    stats = timed("stats", secure_stats_checks, base, rows, measured, brute)
    vis = timed("visibility", visibility_checks, torch, device, rows, base, measured, base_outs,
                brute, busy_idx)
    views = timed("views", view_checks, torch, device, rows, base, measured, base_outs, busy_idx)
    cache = timed("cache", cache_section, torch, device, rows, measured)
    stats.update(timed("stats_mutations", stats_mutation_checks, torch, base, rows, measured))
    launches = read_launches()
    rec = {
        "phase": "secure_cached_path", "cell": "gdelt-z3-10M-secure-cached",
        "launches": launches, "native": read_native(), "n_points": N_SECURE,
        "ingest_s": ingest_s, "n_queries": len(measured),
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "hits_total": int(sum(len(b) for b in brute)),
        "stats": stats, "visibility": vis, "views": views, "cache": cache,
        "reduced": {"n_points": {"cell": 10_000_000, "run": N_SECURE},
                    "cache_rows": {"cell": 10_000_000, "run": N_SECURE_CACHE}},
        "section_s": sections, "path_s": time.perf_counter() - t_path,
    }
    del base
    torch.cuda.empty_cache()
    return rec


# -- the serving tier and the ops plane ------------------------------------

N_SERVED = 10_000_000
N_SERVED_CLIENTS = 16  # 8 per tenant
N_SERVED_REPEAT = 4  # each main query sent this many times in the fair mix
N_SERVED_BRUTE = 16
N_FLOOD_BRONZE = 200
N_FLOOD_GOLD = 16
N_DEADLINE = 16
N_COALESCE = 8  # copies of each query staged in one window
N_WINDOW_QUERIES = 9  # distinct queries in that window: more than 8 always fuse
N_EPOCH_WRITE = 50_000
N_SCRAPES = 50
SERVED_QUEUE_MAX = 256
# the result cache sized to the path's working set: the 64 main queries'
# results (a few MB each at 10M rows) and the flood's, with room to spare
SERVED_CACHE_BYTES = 1 << 30
TENANTS = {"gold": (8.0, 64), "bronze": (1.0, 8)}  # weight, admission quota
OPS_ROUTES = ("/metrics", "/health", "/stats", "/debug/slow", "/debug/trace", "/debug/vars",
              "/debug/audit")
SERVING_THREADS = ("geomesa-serving", "geomesa-ops", "geomesa-telemetry")


def parse_prometheus(text: str) -> dict:
    """A strict parser of the exposition subset the registry emits:
    {family: (type, [(sample name, labels, value)])}; raises on a line
    outside the grammar, a repeated family or a sample outside its
    family."""
    import re

    families: dict = {}
    current = None
    line_re = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
                         r"(?:\{(?P<labels>[^}]*)\})? (?P<value>\S+)$")
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, fam, kind = line.split(" ")
            check(fam not in families and kind in ("counter", "gauge", "summary", "histogram"),
                  f"/metrics: one TYPE line per family: {line!r}")
            families[fam] = (kind, [])
            current = fam
            continue
        m = line_re.match(line)
        check(m is not None, f"/metrics: a well-formed sample line: {line!r}")
        labels = m.group("labels")
        if labels:
            for pair in labels.split(","):
                check(re.fullmatch(r'[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"', pair) is not None,
                      f"/metrics: a well-formed label: {pair!r}")
        check(current is not None and m.group("name").startswith(current),
              f"/metrics: the sample belongs to its family: {line!r}")
        families[current][1].append((m.group("name"), labels, float(m.group("value"))))
    return families


def http_get(url: str):
    """(status, body) of one GET; a non-2xx answer still returns its body."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read().decode()


def serving_threads() -> list:
    import threading

    return [t.name for t in threading.enumerate() if t.name in SERVING_THREADS and t.is_alive()]


def queue_wait_ms(exp):
    """The queue wait the scheduler wrote into one query's explain trail
    (None for a query served at admission, which never queued)."""
    for line in exp.lines:
        if line.strip().startswith("serving: queue wait "):
            return float(line.split("queue wait ", 1)[1].split("ms", 1)[0])
    return None


def pcts(values) -> dict:
    v = np.asarray([x for x in values if x is not None], np.float64)
    if not len(v):
        return {"n": 0, "p50": None, "p99": None}
    return {"n": int(len(v)), "p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99))}


def tenant_rows(tenants) -> dict:
    return {r["tenant"]: r for r in tenants.report()["tenants"]}


def tenant_delta(before: dict, after: dict) -> dict:
    keys = ("submitted", "shed", "served", "cache_hits", "errors")
    return {t: {k: after[t][k] - before.get(t, {}).get(k, 0) for k in keys} for t in after}


def fair_mix(ds, sched, measured, seq_ids, brute_rows) -> dict:
    """16 client threads (8 gold, 8 bronze) send each main query 4 times in
    a seeded order, each client all its queries at once; every answer's
    ids equal the sequential query's in order, and a seeded 16 the f64
    brute force."""
    from concurrent.futures import ThreadPoolExecutor

    from geomesa_tpu_torch.planning.explain import Explainer

    m = sched.metrics
    order = np.random.default_rng(SEED + 90).permutation(
        np.repeat(np.arange(len(measured)), N_SERVED_REPEAT))
    per = len(order) // N_SERVED_CLIENTS
    clients = [("gold" if c < N_SERVED_CLIENTS // 2 else "bronze", order[c * per:(c + 1) * per])
               for c in range(N_SERVED_CLIENTS)]
    c0, h0, t0_rows = serving_counts(m), m.counter_value("geomesa.cache.hit"), \
        tenant_rows(sched.tenants)

    def client(spec):
        tenant, idx = spec
        sent = []
        for i in idx:
            exp = Explainer()
            sent.append((i, exp, time.perf_counter(),
                         sched.submit("gdelt", measured[i][0], explain=exp, tenant=tenant)))
        got = []
        for i, exp, s, fut in sent:
            out = fut.result(600)
            got.append((tenant, int(i), out, time.perf_counter() - s, queue_wait_ms(exp)))
        return got

    t0 = time.perf_counter()
    with ThreadPoolExecutor(N_SERVED_CLIENTS) as ex:
        answers = [a for got in ex.map(client, clients) for a in got]
    wall = time.perf_counter() - t0
    c = {k: v - c0[k] for k, v in serving_counts(m).items()}
    hits = m.counter_value("geomesa.cache.hit") - h0
    per_tenant = tenant_delta(t0_rows, tenant_rows(sched.tenants))
    for tenant, i, out, _, _ in answers:
        check(np.array_equal(np.asarray(out.ids), seq_ids[i]),
              f"fair mix ({tenant}): ids equal the sequential query's, in order: {measured[i][0]}")
    brute_pick = np.random.default_rng(SEED + 95).choice(len(answers), N_SERVED_BRUTE,
                                                         replace=False)
    for k in brute_pick:
        _, i, out, _, _ = answers[k]
        check(np.array_equal(np.sort(np.asarray(out.ids, np.int64)), brute_rows(measured[i][1])),
              f"fair mix: ids equal the f64 brute force: {measured[i][0]}")
    n = len(answers)
    check(n == len(order) and c["submitted"] == n and c["shed"] == 0, f"fair mix: {n} served, {c}")
    check(c["coalesced"] > 0, f"fair mix: identical queries coalesced ({c})")
    check(c["batched_queries"] + c["coalesced"] + hits == n,
          f"fair mix: leaders {c['batched_queries']} + coalesced {c['coalesced']} + cache hits "
          f"{hits} == {n}")
    for t, row in per_tenant.items():
        check(row["served"] + row["cache_hits"] == row["submitted"] == n // 2 and not row["shed"],
              f"fair mix: every {t} submission served or answered from the cache: {row}")
    return {
        "queries": n, "wall_s": wall, "served_queries_per_s": n / wall, "counters": c,
        "cache_hits": hits, "mean_batch": c["batched_queries"] / max(c["batches"], 1),
        "coalesced_share": c["coalesced"] / n, "tenants": per_tenant,
        "wall_ms": {t: pcts([a[3] * 1e3 for a in answers if a[0] == t]) for t in TENANTS},
        "queue_wait_ms": {t: pcts([a[4] for a in answers if a[0] == t]) for t in TENANTS},
        "checked_in_order": n, "checked_vs_brute_force": N_SERVED_BRUTE,
    }


def flood(sched, gold_qs, bronze_qs) -> dict:
    """bronze sends 200 new queries at once without blocking while gold
    sends 16 (blocking): bronze sheds at its own quota, gold sheds none."""
    import threading

    from geomesa_tpu_torch.serving import ServingRejected

    r0 = tenant_rows(sched.tenants)
    shed_msgs, served = [], {"gold": 0, "bronze": 0}
    lock = threading.Lock()
    jobs = [("bronze", bronze_qs[k::8], False) for k in range(8)] + \
        [("gold", gold_qs[k::2], True) for k in range(2)]
    barrier = threading.Barrier(len(jobs))

    def client(tenant, qs, block):
        barrier.wait()
        futs = [sched.submit("gdelt", q, block=block, tenant=tenant) for q, _ in qs]
        for f in futs:
            try:
                f.result(600)
                with lock:
                    served[tenant] += 1
            except ServingRejected as e:
                with lock:
                    shed_msgs.append((tenant, str(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=j) for j in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    d = tenant_delta(r0, tenant_rows(sched.tenants))
    check(d["gold"]["shed"] == 0 and served["gold"] == len(gold_qs), f"flood: gold sheds 0: {d}")
    check(d["bronze"]["shed"] > 0 and all(t == "bronze" for t, _ in shed_msgs),
          f"flood: bronze sheds: {d}")
    check(all("admission quota full" in msg for _, msg in shed_msgs),
          f"flood: bronze sheds at its tenant quota: {shed_msgs[:2]}")
    for t, row in d.items():
        check(row["served"] + row["cache_hits"] + row["shed"] == row["submitted"],
              f"flood: {t} served + shed == submitted: {row}")
    check(d["bronze"]["submitted"] == len(bronze_qs) and d["gold"]["submitted"] == len(gold_qs),
          f"flood: every submission counted: {d}")
    return {"wall_s": wall, "tenants": d, "shed_message": shed_msgs[0][1] if shed_msgs else None}


def deadlines(ds, sched, qs) -> dict:
    """Queries with a 1 us timeout hint are shed before dispatch."""
    from geomesa_tpu_torch.planning.errors import QueryTimeout
    from geomesa_tpu_torch.planning.hints import QueryHints

    m = sched.metrics
    s0 = m.counter_value("geomesa.serving.shed")
    futs = [sched.submit("gdelt", q, hints=QueryHints(timeout=1e-6), tenant="gold")
            for q, _ in qs]
    timed_out = 0
    for f in futs:
        try:
            f.result(600)
        except QueryTimeout:
            timed_out += 1
    shed = m.counter_value("geomesa.serving.shed") - s0
    check(timed_out == len(qs), f"deadlines: {timed_out} of {len(qs)} time out")
    check(shed == len(qs), f"deadlines: geomesa.serving.shed counts all {len(qs)} ({shed})")
    return {"queries": len(qs), "timed_out": timed_out, "shed": shed}


def staged_checks(torch, ds, qs) -> dict:
    """On unstarted schedulers over the same store: 8 copies each of 9 new
    queries in one window scan once per distinct query (K2 slots plus
    the K1 launches of members the table sends alone), not once per
    copy; one query, a 50k-row write into its box and window, the query
    again: two leaders, none coalesced, the second answer holds the new
    rows."""
    from geomesa_tpu_torch import FeatureCollection
    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.planning.hints import QueryHints
    from geomesa_tpu_torch.serving import QueryScheduler, ServingConfig

    window_qs = [q for q, _ in qs[:N_WINDOW_QUERIES]]
    qe, (x0, y0, x1, y1, lo, hi) = qs[N_WINDOW_QUERIES]
    reg = MetricsRegistry()
    sched = QueryScheduler(ds, ServingConfig(), metrics=reg)
    futs = [sched.submit("gdelt", q) for _ in range(N_COALESCE) for q in window_qs]
    before = read_launches()
    with chunk_recorder() as members:
        sched.start()
        outs = [f.result(600) for f in futs]
        sched.close()
    window = {"counters": serving_counts(reg), "chunk_members": members,
              "launches": launch_delta(before)}
    n_w = len(window_qs)
    check(window["counters"]["coalesced"] == n_w * (N_COALESCE - 1)
          and window["counters"]["batched_queries"] == n_w,
          f"window: {n_w * N_COALESCE} queries, {n_w} leaders: {window['counters']}")
    check(sum(members) > 0 and sum(members) + window["launches"]["block_scan"] == n_w,
          f"window: one scan per distinct query ({n_w}), not one per copy: K2 slots "
          f"{members}, K1 launches {window['launches']['block_scan']}")
    for q, out in zip(window_qs * N_COALESCE, outs):
        ref = ds.query("gdelt", q, hints=QueryHints(cache="bypass"))
        check(np.array_equal(np.asarray(out.ids), np.asarray(ref.ids)),
              f"window: coalesced ids equal a sequential query's, in order: {q}")

    reg = MetricsRegistry()
    sched = QueryScheduler(ds, ServingConfig(), metrics=reg)
    e0 = ds.planner.mutation_epoch
    f1 = sched.submit("gdelt", qe)
    r = np.random.default_rng(SEED + 96)
    n0 = ds.row_count("gdelt")
    new_ids = np.arange(n0, n0 + N_EPOCH_WRITE)
    sft = ds.get_schema("gdelt")
    t_w = time.perf_counter()
    ds.write("gdelt", FeatureCollection.from_columns(sft, new_ids, {
        "EventRootCode": root_codes(N_EPOCH_WRITE, SEED + 97),
        "dtg": r.integers(lo, hi, N_EPOCH_WRITE),
        "geom": (r.uniform(x0, x1, N_EPOCH_WRITE), r.uniform(y0, y1, N_EPOCH_WRITE))}),
        check_ids=False)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t_w
    check(ds.planner.mutation_epoch > e0, "epoch: the write moved the mutation epoch")
    f2 = sched.submit("gdelt", qe)
    sched.start()
    r1, r2 = f1.result(600), f2.result(600)
    sched.close()
    c = serving_counts(reg)
    check(c["batched_queries"] == 2 and c["coalesced"] == 0,
          f"epoch: two leaders, none coalesced across the write: {c}")
    got = set(np.asarray(r2.ids, np.int64).tolist())
    check(set(new_ids.tolist()) <= got, "epoch: the second answer holds the written rows")
    ref = ds.query("gdelt", qe, hints=QueryHints(cache="bypass"))
    check(np.array_equal(np.asarray(r2.ids), np.asarray(ref.ids)),
          "epoch: the second answer equals a sequential query after the write, in order")
    return {"window": window, "epoch": {"counters": c, "write_s": write_s,
                                        "first_hits": len(r1), "second_hits": len(r2)}}


def ops_checks(ds, sched, port_url) -> dict:
    """/metrics parses strictly with the registry's serving counters;
    /health ready; /stats equal to stats_for; the debug routes answer
    JSON; the p50 of 50 scrapes of each route; then a 1 us query
    objective and one query turn /health degraded with slo.breach."""
    from geomesa_tpu_torch.obs.slo import SloObjective

    code, text = http_get(port_url + "/metrics")
    fams = parse_prometheus(text)
    check(code == 200, f"/metrics answers 200 ({code})")
    counts = serving_counts(sched.metrics)
    for k, v in counts.items():
        fam = f"geomesa_serving_{k}"
        check(fams.get(fam, ("counter", [(fam, None, 0.0)]))[1][0][2] == v,
              f"/metrics {fam} equals the registry's {v}")
    check(fams["geomesa_serving_queue_wait_seconds"][0] == "histogram",
          "/metrics carries the queue-wait histogram")
    statuses = []
    for _ in range(2):  # the first evaluation reads the sheds since the monitor began
        code, body = http_get(port_url + "/health")
        statuses.append(json.loads(body))
    check(statuses[-1]["status"] == "ready" and code == 200,
          f"/health is ready once the earlier sheds are read: {statuses[-1]['reasons']}")
    code, body = http_get(port_url + "/stats")
    want = json.loads(json.dumps(ds.stats_for("gdelt").to_json(), default=str))
    check(code == 200 and json.loads(body)["gdelt"] == want, "/stats equals stats_for")
    for path in OPS_ROUTES[3:]:
        code, body = http_get(port_url + path)
        check(code == 200, f"{path} answers 200")
        json.loads(body)
    scrape_ms = {}
    for path in OPS_ROUTES:
        lat = []
        for _ in range(N_SCRAPES):
            s = time.perf_counter()
            http_get(port_url + path)
            lat.append((time.perf_counter() - s) * 1e3)
        scrape_ms[path] = float(np.percentile(lat, 50))
    http_get(port_url + "/health")  # the scrapes' own reading
    ds.attach_slo([SloObjective("query_p99", "geomesa.query.scan", 0.99, 1e-6)])
    ds.query("gdelt", "bbox(geom, 0, 0, 1, 1)")
    code, body = http_get(port_url + "/health")
    breach = json.loads(body)
    check(code == 200 and breach["status"] == "degraded"
          and {r["reason"] for r in breach["reasons"]} == {"slo.breach"},
          f"/health degraded with slo.breach under a 1 us objective: {breach['reasons']}")
    return {"scrape_p50_ms": scrape_ms,
            "health": [h["status"] for h in statuses] + [breach["status"]],
            "health_reasons": [[r["reason"] for r in h["reasons"]] for h in statuses]
            + [[r["reason"] for r in breach["reasons"]]],
            "metrics_families": len(fams)}


def close_checks(ds, port) -> dict:
    """DataStore.close: scheduler and ops socket closed, no serving or ops
    thread alive, the port rebinds at once, the store still answers and
    serve() returns a fresh scheduler; then close again."""
    sched, ops = ds.scheduler, ds.ops
    t0 = time.perf_counter()
    ds.close()
    close_s = time.perf_counter() - t0
    check(sched.closed and ops.closed, "close: the scheduler and the ops server are closed")
    left = serving_threads()
    check(left == [], f"close: no serving or ops thread alive: {left}")
    ops2 = ds.serve_ops(port=port)
    check(ops2 is not ops and ops2.port == port, "close: serve_ops rebinds the same port at once")
    check(http_get(ops2.url + "/health")[0] == 200, "close: the rebound ops plane answers")
    check(len(ds.query("gdelt", "bbox(geom, -10, -10, 10, 10)")) > 0, "close: query still answers")
    sched2 = ds.serve()
    check(sched2 is not sched and not sched2.closed, "close: serve() returns a fresh scheduler")
    ds.close()
    ds.close()
    check(sched2.closed and ops2.closed and serving_threads() == [],
          "close: the second close leaves nothing running")
    return {"close_s": close_s}


def served_path(torch, device) -> dict:
    """gdelt-z3-10M-served: 10M GDELT-shaped events on Z3 with
    ``EventRootCode`` on a cached store behind the serving tier (queue
    256; tenants gold weight 8 quota 64 and bronze weight 1 quota 8), an
    SLO tracker and the ops plane: dashboard clients of two teams query
    one shared event store while operators scrape it. The fair mix, the
    cache peek, the flood, the deadline sheds, the staged window and
    epoch checks, the ops plane and close, each with its launch counts.
    Launch and native counts are zeroed before, read after."""
    from geomesa_tpu_torch import conf
    from geomesa_tpu_torch.audit import AuditWriter
    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.planning.hints import QueryHints
    from geomesa_tpu_torch.serving import ServingConfig, TenantRegistry

    zero_launches()
    t_path = time.perf_counter()
    conf.CACHE_MAX_BYTES.set(SERVED_CACHE_BYTES)
    try:
        ds, src, ingest_s = build_store(torch, device, N_SERVED, seed=SEED + 100,
                                        with_root_code=True, cache=True,
                                        metrics=MetricsRegistry(), audit=AuditWriter())
    finally:
        conf.CACHE_MAX_BYTES.clear()
    measured = query_set(SEED + 2, N_MEASURED)
    bypass = QueryHints(cache="bypass")
    steps, sections = {}, {}
    before = read_launches()
    seq = [ds.query("gdelt", q, hints=bypass) for q, _ in measured]
    seq_ids = [np.asarray(o.ids) for o in seq]
    steps["sequential"] = launch_delta(before)
    check(len(ds.cache.result) == 0, "the sequential reference bypassed the cache")

    sched = ds.serve(ServingConfig(queue_max=SERVED_QUEUE_MAX))
    tenants = TenantRegistry(metrics=ds.metrics)
    for t, (w, quota) in TENANTS.items():
        tenants.configure(t, weight=w, queue_max=quota)
    sched.tenants = tenants
    ds.attach_slo()
    ops = ds.serve_ops(port=0)
    check(ops.host == "127.0.0.1", "the ops plane binds loopback")

    def step(name, fn, *a):
        b = read_launches()
        s = time.perf_counter()
        out = fn(*a)
        sections[name] = time.perf_counter() - s
        steps[name] = launch_delta(b)
        return out

    mix = step("fair_mix", fair_mix, ds, sched, measured, seq_ids,
               lambda box: brute_ids(src, box))
    check(steps["fair_mix"]["block_scan_multi"] > 0, "fair mix: the fused dispatches launch K2")

    m = ds.metrics
    h0, c0 = m.counter_value("geomesa.cache.hit"), serving_counts(m)

    def cached_pass():
        outs = [sched.query("gdelt", q, wait=600) for q, _ in measured]
        for (q, _), o, ref in zip(measured, outs, seq_ids):
            check(np.array_equal(np.asarray(o.ids), ref), f"cache peek: ids in order: {q}")
        return len(outs)

    step("cache_peek", cached_pass)
    peek = {"hits": m.counter_value("geomesa.cache.hit") - h0,
            "counters": {k: v - c0[k] for k, v in serving_counts(m).items()}}
    check(peek["hits"] == len(measured), f"cache peek: {len(measured)} result hits ({peek})")
    check(steps["cache_peek"]["block_scan"] == 0 and steps["cache_peek"]["block_scan_multi"] == 0,
          f"cache peek: no K1 and no K2 launch: {steps['cache_peek']}")
    check(peek["counters"]["batched_queries"] == 0 and peek["counters"]["batches"] == 0,
          f"cache peek: nothing queued: {peek['counters']}")

    flooded = step("flood", flood, sched, query_set(SEED + 92, N_FLOOD_GOLD),
                   query_set(SEED + 91, N_FLOOD_BRONZE))
    dl = step("deadlines", deadlines, ds, sched, query_set(SEED + 93, N_DEADLINE))
    staged = step("staged", staged_checks, torch, ds,
                  query_set(SEED + 94, N_WINDOW_QUERIES + 1))
    opsrec = step("ops", ops_checks, ds, sched, ops.url)
    closed = step("close", close_checks, ds, ops.port)
    launches = read_launches()
    rec = {
        "phase": "served_path", "cell": "gdelt-z3-10M-served", "launches": launches,
        "native": read_native(), "n_points": N_SERVED, "ingest_s": ingest_s,
        "n_queries": len(measured), "fair_mix": mix, "cache_peek": peek, "flood": flooded,
        "deadlines": dl, "staged": staged, "ops": opsrec, "close": closed,
        "tenant_report": tenants.report(), "slo": ds.slo_report(),
        "step_launches": steps, "section_s": sections, "path_s": time.perf_counter() - t_path,
    }
    del ds, src, seq
    torch.cuda.empty_cache()
    return rec


# -- the streaming tier: write-ahead log, hot tier, flusher, LambdaStore ------

STREAM_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
STREAM_T0 = 1_717_200_000_000  # 2024-06-01T00:00:00Z
STREAM_DAY = 86_400_000
N_STREAM = 3_000_000  # tracked objects in the cold store
STREAM_BATCH = 20_000  # rows per flush: half updates, half new ids
# config_stream's 24 flushes, cut to 12 for the script's wall once paths
# 22-24 came (the record's ``reduced``)
STREAM_FLUSHES = 6  # 12 until the pod path came, 8 until the scripts path (the record's "reduced")
STREAM_LEGACY_FLUSHES = 2  # of the reference's 12 (its per-flush cost is stationary)
STREAM_CLIENTS = 4  # the reference's max(2, cpus // 2) on the card's 8-CPU host
STREAM_POLL_MS = 150.0
STREAM_PROBES = 24
STREAM_SUB_BATCH = 2048  # the consumer loop's write size
N_WAL_COLD = 200_000
# the path's wall on the card passed 90 s at the reference's sizes (142.0 s,
# the WAL section 100.5 of it): the WAL modes' rows are cut from 400k,
# then the recovery run's from 1M (the record's "reduced" lists both)
N_WAL_STREAM = 100_000  # streamed rows per WAL mode (200k until the pod path came)
N_WAL_REPLAY = 250_000  # rows of the recovery run (500k until PR 19)
WAL_MODES = ("nowal", "off", "interval", "always")
WAL_PROBES = ("bbox(geom, -40, -40, 0, 0)", "bbox(geom, 10, 10, 60, 50)",
              "IN ('0', '1', 'a1', 'a2')")
OPS_FOLD_ROWS = 20_000  # the recovered store's fold threshold for the occupancy check
STREAM_THREADS = ("geomesa-wal-sync", "geomesa-stream", "geomesa-serving", "geomesa-ops",
                  "geomesa-telemetry")


def stream_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate()
                  if t.is_alive() and t.name.split("_")[0] in STREAM_THREADS)


def stream_store(torch, device, n, seed, metrics=None):
    """A cold Z3 store of n tracked objects (ids "0".."n-1", name "v", one
    day of times from the seed), compacted; returns (store, (x, y, t),
    ingest seconds)."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    rng = np.random.default_rng(seed)
    t = STREAM_T0 + rng.integers(0, STREAM_DAY, n)
    x = rng.uniform(-170, 170, n)
    y = rng.uniform(-80, 80, n)
    sft = FeatureType.from_spec("mv", STREAM_SPEC)
    ds = DataStore(device=device, metrics=metrics)
    ds.create_schema(sft)
    s = time.perf_counter()
    ds.write("mv", FeatureCollection.from_columns(sft, np.arange(n).astype(str), {
        "name": np.full(n, "v"), "dtg": t, "geom": (x, y)}), check_ids=False)
    ds.compact("mv")
    torch.cuda.synchronize()
    return ds, (x, y, t), time.perf_counter() - s


class StreamModel:
    """The expected state of the sustained run, by id: the cold rows, then
    the stream's new ids ("new{k}_{j}" -> n + k * half + j); name code -1
    is the cold rows' "v", k is "r{k}"."""

    def __init__(self, n, x, y, t, n_new):
        self.n = n
        self.half = STREAM_BATCH - STREAM_BATCH // 2
        self.alive = np.zeros(n + n_new, bool)
        self.alive[:n] = True
        self.x = np.concatenate([x, np.zeros(n_new)])
        self.y = np.concatenate([y, np.zeros(n_new)])
        self.t = np.concatenate([t, np.zeros(n_new, np.int64)])
        self.name = np.full(n + n_new, -1, np.int64)

    def index(self, ids) -> np.ndarray:
        out = np.empty(len(ids), np.int64)
        for i, fid in enumerate(ids):
            if fid.startswith("new"):
                k, j = fid[3:].split("_")
                out[i] = self.n + int(k) * self.half + int(j)
            else:
                out[i] = int(fid)
        return out

    def hits(self, q) -> np.ndarray:
        x0, y0, x1, y1, during = q
        m = (self.alive & (self.x >= x0) & (self.x <= x1) & (self.y >= y0)
             & (self.y <= y1))
        if during:
            m &= (self.t >= STREAM_T0) & (self.t < STREAM_T0 + 9 * STREAM_DAY)
        return np.flatnonzero(m)


def stream_messages(n, flushes, seed, prefix="new"):
    """The producer side, prebuilt: per flush, half updates of cold ids
    (fresh positions and times) and half new ids; rows are dicts with Point
    geometries, as a consumer hands them over."""
    from geomesa_tpu_torch import geometry as geo

    rng = np.random.default_rng(seed)
    half = STREAM_BATCH // 2
    out = []
    for k in range(flushes):
        upd = rng.choice(n, half, replace=False)
        ids = [str(i) for i in upd.tolist()] + [f"{prefix}{k}_{j}"
                                                for j in range(STREAM_BATCH - half)]
        xs = rng.uniform(-170, 170, STREAM_BATCH)
        ys = rng.uniform(-80, 80, STREAM_BATCH)
        ts = STREAM_T0 + 8 * STREAM_DAY + rng.integers(0, STREAM_DAY, STREAM_BATCH)
        rows = [{"name": f"r{k}", "dtg": int(t), "geom": geo.Point(float(a), float(b))}
                for a, b, t in zip(xs.tolist(), ys.tolist(), ts.tolist())]
        out.append((rows, ids, upd, xs, ys, ts))
    return out


def stream_queries(seed, n=256):
    """Dashboard windows: small boxes (0.5 to 2 degrees), 30 % with a DURING
    over the stream's days; (ecql, (x0, y0, x1, y1, during)) with the bounds
    as the parser reads them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = float(rng.choice([0.5, 1.0, 2.0]))
        qx = rng.uniform(-165, 165 - w)
        qy = rng.uniform(-75, 75 - w / 2)
        b = (f"{qx:.3f}", f"{qy:.3f}", f"{qx + w:.3f}", f"{qy + w / 2:.3f}")
        q = f"bbox(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"
        during = bool(rng.random() < 0.3)
        if during:
            q += " AND dtg DURING 2024-06-01T00:00:00Z/2024-06-10T00:00:00Z"
        out.append((q, (*(float(v) for v in b), during)))
    return out


def consume(lam, rows, ids) -> None:
    """The consumer loop: messages apply in sub-batches, as a stream
    consumer polls."""
    for s in range(0, len(rows), STREAM_SUB_BATCH):
        lam.write(rows[s : s + STREAM_SUB_BATCH], ids=ids[s : s + STREAM_SUB_BATCH])


def sustained_section(torch, device) -> dict:
    """The reference's config_stream, its 24 flushes cut to STREAM_FLUSHES:
    flushes of 20k rows (write, flush) into a 3M-object cold store under 4
    polling query clients, a final persist_hot inside the timed wall, the
    identical check against the numpy model, then the legacy flush for
    STREAM_LEGACY_FLUSHES flushes."""
    import threading

    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.streaming import LambdaStore, StreamConfig

    ds, (x, y, t), ingest_s = stream_store(torch, device, N_STREAM, SEED + 90,
                                           metrics=MetricsRegistry())
    s = time.perf_counter()
    stream = stream_messages(N_STREAM, STREAM_FLUSHES, SEED + 91)
    build_msgs_s = time.perf_counter() - s
    model = StreamModel(N_STREAM, x, y, t, STREAM_FLUSHES * (STREAM_BATCH - STREAM_BATCH // 2))
    reg = ds.metrics
    # the fold threshold above the run's updates: the one fold is the final
    # persist, timed as the fold window
    lam = LambdaStore(ds, "mv", config=StreamConfig(fold_rows=STREAM_BATCH * STREAM_FLUSHES + 1))
    lam.serve()
    s = time.perf_counter()
    warm_calls = ds.warmup("mv")
    pool = stream_queries(SEED + 92)
    for q, _ in pool[:8]:
        lam.query(q)
    ds.query_many("mv", [q for q, _ in pool[8:16]])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - s
    stop = threading.Event()
    lat: list = []
    lat_lock = threading.Lock()

    def client(seed):
        qs = [q for q, _ in stream_queries(seed)]
        local, i = [], 0
        while not stop.is_set():
            s0 = time.perf_counter()
            lam.query(qs[i % len(qs)])
            dt = time.perf_counter() - s0
            local.append((s0, dt))
            i += 1
            stop.wait(max(STREAM_POLL_MS / 1e3 - dt, 0.0))
        with lat_lock:
            lat.extend(local)

    threads = [threading.Thread(target=client, args=(SEED + 100 + c,))
               for c in range(STREAM_CLIENTS)]
    for th in threads:
        th.start()
    t0 = time.perf_counter()
    flush_s = []
    for k, (rows, ids, upd, xs, ys, ts) in enumerate(stream):
        consume(lam, rows, ids)
        f0 = time.perf_counter()
        lam.flush()
        flush_s.append(time.perf_counter() - f0)
    fold_t0 = time.perf_counter()
    lam.persist_hot()
    torch.cuda.synchronize()
    fold_t1 = time.perf_counter()
    stop.set()
    for th in threads:
        th.join()
    streamed_s = fold_t1 - t0
    streamed_rps = STREAM_FLUSHES * STREAM_BATCH / streamed_s
    steady = np.array([d for s0, d in lat if s0 + d < fold_t0]) * 1e3
    in_fold = np.array([d for s0, d in lat if s0 + d >= fold_t0]) * 1e3
    check(len(steady) > 0, "the query clients ran during the stream")
    report = ds.last_fold_report or {}
    slice_ms = np.asarray(report.get("slice_s", []), np.float64) * 1e3
    check(len(slice_ms) > 0, "the final persist folded the pending updates")
    check(len(lam.hot) == 0, "persist_hot drained the hot tier")

    # the expected final state, then the identical flag: ids and every value
    for k, (rows, ids, upd, xs, ys, ts) in enumerate(stream):
        half = len(upd)
        new = N_STREAM + k * model.half + np.arange(STREAM_BATCH - half)
        idx = np.concatenate([upd, new])
        model.alive[idx] = True
        model.x[idx], model.y[idx], model.t[idx], model.name[idx] = xs, ys, ts, k
    identical, n_hits = True, 0
    for q, params in stream_queries(SEED + 93)[:STREAM_PROBES]:
        got = lam.query(q)
        gids = [str(i) for i in np.asarray(got.ids).tolist()]
        gi = model.index(gids)
        order = np.argsort(gi)
        want = model.hits(params)
        n_hits += len(want)
        g = got.geom_column
        names = np.asarray(got.columns["name"])
        want_names = np.where(model.name[want] < 0, "v",
                              np.char.add("r", model.name[want].astype(str)))
        same = (len(gids) == len(set(gids)) and np.array_equal(gi[order], want)
                and np.array_equal(np.asarray(g.x)[order], model.x[want])
                and np.array_equal(np.asarray(g.y)[order], model.y[want])
                and np.array_equal(np.asarray(got.columns["dtg"], np.int64)[order], model.t[want])
                and np.array_equal(names[order], want_names))
        if not same:
            identical = False
            emit({"phase": "stream_mismatch", "query": q, "got": len(gids), "want": len(want)})
    check(identical, "sustained: every probe query equals the numpy model (ids and values)")
    check(n_hits > 0, "sustained: the probes hit rows")
    prestaged = reg.counter_value("geomesa.stream.fold.prestaged")
    snap = reg.snapshot()["histograms"]

    # the legacy flush (delete-and-rewrite of the whole cold table per
    # flush), on the same store, no query load
    legacy = stream_messages(N_STREAM, STREAM_LEGACY_FLUSHES, SEED + 94, prefix="old")
    t0 = time.perf_counter()
    for rows, ids, *_ in legacy:
        consume(lam, rows, ids)
        lam.persist_hot(incremental=False)
    torch.cuda.synchronize()
    legacy_s = time.perf_counter() - t0
    legacy_rps = STREAM_LEGACY_FLUSHES * STREAM_BATCH / legacy_s
    n_cold = len(ds.features("mv"))
    check(n_cold == N_STREAM + (STREAM_FLUSHES + STREAM_LEGACY_FLUSHES) * (
        STREAM_BATCH - STREAM_BATCH // 2), f"the legacy flushes published their rows ({n_cold})")
    lam.close()
    ds.close()
    return {
        "cold_rows": N_STREAM, "batch_rows": STREAM_BATCH, "flushes": STREAM_FLUSHES,
        "ingest_s": ingest_s, "build_messages_s": build_msgs_s, "warmup_s": warm_s,
        "warmup_calls": warm_calls,
        "streamed_s": streamed_s, "streamed_rows_per_s": streamed_rps,
        "flush_ms_p50": float(np.percentile(flush_s, 50) * 1e3),
        "flush_ms_max": float(np.max(flush_s) * 1e3),
        "legacy_flushes": STREAM_LEGACY_FLUSHES, "legacy_s": legacy_s,
        "legacy_rows_per_s": legacy_rps, "speedup": streamed_rps / legacy_rps,
        "identical": identical, "probe_hits": n_hits, "host_cpus": os.cpu_count(),
        "query": {
            "clients": STREAM_CLIENTS, "poll_ms": STREAM_POLL_MS, "queries": len(lat),
            "p50_ms": float(np.percentile(steady, 50)), "p99_ms": float(np.percentile(steady, 99)),
            "fold_window_s": fold_t1 - fold_t0, "in_fold_queries": int(len(in_fold)),
            "fold_window_p99_ms": float(np.percentile(in_fold, 99)) if len(in_fold) else None,
        },
        "fold": {
            "rows": int(report.get("rows", 0)), "slices": int(report.get("slices", 0)),
            "slice_pause_ms_p50": float(np.percentile(slice_ms, 50)),
            "slice_pause_ms_max": float(slice_ms.max()), "prestaged_rows": int(prestaged),
        },
        "stage_p99_ms": {k.rsplit(".", 1)[1]: v["p99_s"] * 1e3 for k, v in snap.items()
                         if k in ("geomesa.stream.parse", "geomesa.stream.keys",
                                  "geomesa.stream.sort", "geomesa.stream.commit")},
    }


def wal_rows(n_cold, n, seed, prefix="a"):
    """Prebuilt (ids, rows) batches: half updates of cold ids, half arrivals;
    identical across every mode."""
    from geomesa_tpu_torch import geometry as geo

    rng = np.random.default_rng(seed)
    out, arrivals = [], 0
    for s in range(0, n, STREAM_BATCH):
        k = min(STREAM_BATCH, n - s)
        upd = rng.integers(0, n_cold, k // 2) if n_cold else np.zeros(0, np.int64)
        xs, ys = rng.uniform(-170, 170, k), rng.uniform(-80, 80, k)
        ids = [str(i) for i in upd.tolist()]
        ids += [f"{prefix}{arrivals + j + 1}" for j in range(k - len(ids))]
        arrivals += k - len(upd)
        rows = [{"name": "u", "dtg": STREAM_T0 + s + j, "geom": geo.Point(a, b)}
                for j, (a, b) in enumerate(zip(xs.tolist(), ys.tolist()))]
        out.append((ids, rows))
    return out


def probe_values(lam) -> list:
    """Each WAL probe's (id, name, x, y, dtg) rows, sorted by id."""
    out = []
    for q in WAL_PROBES:
        fc = lam.query(q)
        g = fc.geom_column
        out.append(sorted(zip(
            (str(i) for i in np.asarray(fc.ids).tolist()),
            np.asarray(fc.columns["name"]).tolist(), np.asarray(g.x).tolist(),
            np.asarray(g.y).tolist(), np.asarray(fc.columns["dtg"], np.int64).tolist())))
    return out


def wal_section(torch, device, tmp) -> dict:
    """The reference's config_wal: the same micro-batch write + flush
    workload with no WAL and under sync off, interval and always; a
    checkpoint and a crash of the always store, recovered on the card
    equal to the live one; the ops plane on that recovered store
    (hot.occupancy raised and cleared, an unreplayed log refused and
    reported, recover clearing it); then the recovery run (streamed rows
    with a flush watermark per batch, a crash, recover timed on the
    card)."""
    import json as _json

    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.obs.ops import HealthMonitor
    from geomesa_tpu_torch.storage import persist
    from geomesa_tpu_torch.streaming import (LambdaStore, StreamConfig, WalConfig, WalError,
                                             WriteAheadLog)

    def root_of(name, save=False):
        """A 200k cold store and its root (saved where a recovery reads it;
        the other modes' logs only live under it)."""
        ds, _, _ = stream_store(torch, device, N_WAL_COLD, SEED + 95, metrics=MetricsRegistry())
        root = os.path.join(tmp, name)
        if save:
            persist.save(ds, root)
        return ds, root

    stream = wal_rows(N_WAL_COLD, N_WAL_STREAM, SEED + 96)
    dsw, _ = root_of("warm")  # one discarded short run: the first mode pays no first calls
    lamw = LambdaStore(dsw, "mv", config=StreamConfig())
    for ids, rows in stream[:3]:
        lamw.write(rows, ids=ids)
        lamw.flush()
    lamw.close()
    del dsw, lamw
    modes, keep = {}, None
    for mode in WAL_MODES:
        ds, root = root_of(mode, save=mode == "always")
        kw = {} if mode == "nowal" else dict(
            wal_dir=os.path.join(root, "_wal"), wal_config=WalConfig(sync=mode))
        lam = LambdaStore(ds, "mv", config=StreamConfig(), **kw)
        t0 = time.perf_counter()
        for ids, rows in stream:
            lam.write(rows, ids=ids)
            lam.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        h = ds.metrics.snapshot()["histograms"].get("geomesa.stream.wal.fsync")
        modes[mode] = {"rows_per_s": N_WAL_STREAM / dt, "seconds": dt,
                       "fsyncs": ds.metrics.counter_value("geomesa.stream.wal.syncs"),
                       "fsync_p50_ms": h["p50_s"] * 1e3 if h else None,
                       "fsync_p99_ms": h["p99_s"] * 1e3 if h else None}
        if mode == "always":
            keep = (lam, root)
        else:
            lam.close()
            ds.close()
    lam, root = keep
    live = probe_values(lam)
    s = time.perf_counter()
    lam.checkpoint(root)
    checkpoint_s = time.perf_counter() - s
    lam.wal.crash()
    lam.flusher.close()
    lam.cold.close()
    del lam
    rec = LambdaStore.recover(root, config=StreamConfig(fold_rows=OPS_FOLD_ROWS))
    check(rec.cold.device.type == "cuda", "recover loads the cold store onto the card")
    identical = probe_values(rec) == live and rec.cold.store_health.status == "ok"
    check(identical, "the always store, checkpointed and crashed, recovers equal to the live one")

    # the ops plane on the recovered LambdaStore: hot.occupancy raised and
    # cleared, the scrapes launch nothing
    ops = rec.serve_ops()
    scrapes = {}

    def health(name):
        before = read_launches()
        code, body = http_get(ops.url + "/health")
        scrapes[name] = launch_delta(before)
        rep = _json.loads(body)
        return code, rep["status"], [r["reason"] for r in rep["reasons"]], rep["hot"]

    h0 = health("recovered")
    check(h0[1] == "ready" and h0[2] == [], f"the recovered store is ready: {h0}")
    occ = wal_rows(N_WAL_COLD, 3 * OPS_FOLD_ROWS, SEED + 98, prefix="o")
    for ids, rows in occ:
        rec.write(rows, ids=ids)
    h1 = health("occupied")
    check(h1[0] == 200 and "hot.occupancy" in h1[2] and h1[3]["rows"] > 2 * OPS_FOLD_ROWS,
          f"/health names hot.occupancy over 2 x fold_rows: {h1}")
    rec.persist_hot()
    h2 = health("drained")
    check("hot.occupancy" not in h2[2] and h2[3]["rows"] == 0,
          f"/health drops hot.occupancy after persist_hot: {h2}")
    check(all(sum(v.values()) == 0 for v in scrapes.values()),
          f"the scrapes launch no kernel: {scrapes}")
    # a WAL with records past its cover: the constructor refuses it; an
    # explicitly opened log reports needs_recovery; recover clears it
    rec.write(occ[0][1][:100], ids=occ[0][0][:100])
    rec.wal.crash()
    rec.flusher.close()
    try:
        LambdaStore(rec.cold, "mv", wal_dir=os.path.join(root, "_wal"))
        refused = False
    except WalError:
        refused = True
    check(refused, "the constructor refuses a WAL with records past its cover")
    wal = WriteAheadLog(os.path.join(root, "_wal"))
    held = LambdaStore(rec.cold, "mv", wal=wal)
    verdict = HealthMonitor(rec.cold, lam=held).evaluate()
    check(verdict["status"] == "unhealthy"
          and [r["reason"] for r in verdict["reasons"]] == ["wal.needs_recovery"],
          f"/health: wal.needs_recovery is unhealthy ({verdict['reasons']})")
    held.close()
    rec.cold.close()
    again = LambdaStore.recover(root)
    verdict2 = HealthMonitor(again.cold, lam=again).evaluate()
    check(not again.wal.needs_recovery and verdict2["status"] == "ready"
          and len(again.hot) == 100, f"recover clears the state ({verdict2['reasons']})")
    again.close()
    again.cold.close()
    del rec, again, held
    torch.cuda.empty_cache()

    # the recovery run: streamed rows with a flush watermark per batch,
    # crashed, recovered on the card
    ds, root = root_of("replay", save=True)
    lam = LambdaStore(ds, "mv", config=StreamConfig(), wal_dir=os.path.join(root, "_wal"),
                      wal_config=WalConfig(sync="off"))
    replay_stream = wal_rows(0, N_WAL_REPLAY, SEED + 97, prefix="r")
    t0 = time.perf_counter()
    for ids, rows in replay_stream:
        lam.write(rows, ids=ids)
        lam.flush()
    stream_s = time.perf_counter() - t0
    live = probe_values(lam)
    lam.wal.sync()  # sync=off: drains the buffer to the file (no fsync)
    lam.wal.crash()
    lam.flusher.close()
    ds.close()
    wal_bytes = sum(os.path.getsize(os.path.join(root, "_wal", f))
                    for f in os.listdir(os.path.join(root, "_wal")))
    del lam, ds, replay_stream
    torch.cuda.empty_cache()
    progress = []
    t0 = time.perf_counter()
    rec = LambdaStore.recover(root, on_progress=lambda *a: progress.append(a),
                              metrics=MetricsRegistry())
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    replayed = len(rec.cold.features("mv")) + len(rec.hot) - N_WAL_COLD
    check(replayed == N_WAL_REPLAY, f"recovery surfaced every streamed row ({replayed})")
    check(probe_values(rec) == live, "the recovered store answers every probe as the live one")
    check(rec.cold.device.type == "cuda", "recover loads the cold store onto the card")
    check(len(progress) > 0 and rec.cold.metrics.gauges.get(
        "geomesa.replica.replay.progress", -1) >= 0, "replay reported its progress")
    rec.close()
    rec.cold.close()
    return {
        "cold_rows": N_WAL_COLD, "streamed_rows": N_WAL_STREAM, "batch": STREAM_BATCH,
        "modes": modes,
        "interval_over_nowal": modes["interval"]["rows_per_s"] / modes["nowal"]["rows_per_s"],
        "interval_over_nowal_bound": 0.85,
        "always_over_nowal": modes["always"]["rows_per_s"] / modes["nowal"]["rows_per_s"],
        "checkpoint_s": checkpoint_s, "identical": identical,
        "replay": {"rows": N_WAL_REPLAY, "stream_s": stream_s, "wal_bytes": wal_bytes,
                   "recover_s": recover_s, "rows_per_s": N_WAL_REPLAY / recover_s,
                   "progress_calls": len(progress)},
        "ops": {"health": {"recovered": h0[:3], "occupied": h1[:3], "drained": h2[:3]},
                "scrape_launches": scrapes, "constructor_refused": refused,
                "needs_recovery_verdict": verdict["status"], "after_recover": verdict2["status"]},
    }


def stream_path(torch, device) -> dict:
    """moving-z3-3M-stream: fleet, vessel and courier trackers report new
    positions every few seconds into one store while dashboards query the
    live picture: the reference's own streaming scenarios at their own
    sizes. ``sustained`` (config_stream) and ``wal`` (config_wal), each
    timed; ``close()`` of every store leaves no thread. Launch and native
    counts are zeroed before, read after."""
    import gc
    import shutil
    import tempfile

    # the objects earlier paths left behind stay out of the collector's
    # full passes, so the path is timed as it would be in a process of its
    # own (the hot tier's own rows are not frozen)
    gc.collect()
    gc.freeze()
    zero_launches()
    t_path = time.perf_counter()
    threads0 = stream_threads()
    sections = {}
    s = time.perf_counter()
    sustained = sustained_section(torch, device)
    sections["sustained"] = time.perf_counter() - s
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="geomesa_stream_")
    try:
        s = time.perf_counter()
        wal = wal_section(torch, device, tmp)
        sections["wal"] = time.perf_counter() - s
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    left = [t for t in stream_threads() if t not in threads0]
    check(left == [], f"close() of every store leaves no streaming, serving or ops thread: {left}")
    launches = read_launches()
    reduced = {"legacy_flushes": {"cell": 12, "run": STREAM_LEGACY_FLUSHES},
               "wal_mode_repeats": {"cell": 2, "run": 1},
               "flushes": {"cell": 24, "run": STREAM_FLUSHES}}
    if N_WAL_STREAM != 400_000:
        reduced["wal_mode_rows"] = {"cell": 400_000, "run": N_WAL_STREAM}
    if N_WAL_REPLAY != 1_000_000:
        reduced["recovery_rows"] = {"cell": 1_000_000, "run": N_WAL_REPLAY}
    gc.unfreeze()
    rec = {
        "phase": "stream_path", "cell": "moving-z3-3M-stream", "launches": launches,
        "native": read_native(), "n_points": N_STREAM, "reduced": reduced,
        "sustained": sustained, "wal": wal, "section_s": sections,
        "path_s": time.perf_counter() - t_path,
    }
    torch.cuda.empty_cache()
    return rec


# -- standing queries (moving-standing-1M) -----------------------------------

GEOFENCE_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
N_SUBS = 1_000_000  # tiny squares; with the 96 stars and 16 rings: 1,000,112
# the reference's 200,000, halved for the 75 s budget, then cut to 60k for
# the script's wall once paths 22-24 came
N_GEOFENCE_EVENTS = 40_000  # 60,000 until the scripts path ("reduced")
GEOFENCE_BATCH = 20_000
N_GEOFENCE_ORACLE = 1_500
N_GEOFENCE_NAIVE = 16
N_CRASH_SUBS = 1_000
GEOFENCE_HOT = (0.0, 10.0, 12.0, 22.0)  # x0, y0, x1, y1: 20 % of the events
GEOFENCE_T0 = 1_717_200_000_000
STANDING_P99_MS = 250.0  # geomesa.obs.slo.standing.p99.ms
GEOFENCE_BUDGET_S = 75.0
MATCH_ROWS = 20_000  # the kernel phase's matcher batch: 5 blocks of 4,096 rows


def geofence_ring(cx, cy, r, n=24):
    from geomesa_tpu_torch import geometry as geo

    a = np.linspace(0, 2 * np.pi, n + 1)
    return geo.Polygon([(cx + r * np.cos(t), cy + r * np.sin(t)) for t in a])


def squares(cx, cy, w):
    """Axis-aligned squares of half-width w, each a closed 5-point ring in
    the reference's vertex order."""
    from geomesa_tpu_torch import geometry as geo

    sh = np.empty((len(cx), 5, 2))
    sh[:, 0, 0], sh[:, 0, 1] = cx - w, cy - w
    sh[:, 1, 0], sh[:, 1, 1] = cx + w, cy - w
    sh[:, 2, 0], sh[:, 2, 1] = cx + w, cy + w
    sh[:, 3, 0], sh[:, 3, 1] = cx - w, cy + w
    sh[:, 4] = sh[:, 0]
    return [geo.Polygon(s) for s in sh]


def geofence_population(seed):
    """The reference's population and stream (``bench.py``
    ``config_standing``, its seed and draw order): 1,000,000 tiny squares
    (half-widths 0.005-0.03 degrees, centres over +-170 x +-80), 96 jagged
    stars of 8-120 arms in the hotspot and 16 convex rings whose interiors
    classify FULL; N_GEOFENCE_EVENTS events, 20 % in the hotspot, in 20k
    batches."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-170, 170, N_SUBS)
    cy = rng.uniform(-80, 80, N_SUBS)
    w = rng.uniform(0.005, 0.03, N_SUBS)
    geoms = squares(cx, cy, w)
    hot = GEOFENCE_HOT
    dense = []
    for k in range(96):
        arms = int(rng.integers(8, 121))  # E buckets 16..256
        dense.append((f"dense{k}", star(
            float(rng.uniform(hot[0] + 2, hot[2] - 2)), float(rng.uniform(hot[1] + 2, hot[3] - 2)),
            float(rng.uniform(0.8, 2.5)), arms, np.random.default_rng(SEED + k))))
    for k in range(16):
        dense.append((f"fence{k}", geofence_ring(
            float(rng.uniform(-160, 160)), float(rng.uniform(-70, 70)),
            float(rng.uniform(2.0, 4.0)))))
    ids = [f"s{i}" for i in range(N_SUBS)] + [i for i, _ in dense]
    geoms += [g for _, g in dense]
    # the squares' bboxes as the population drew them (each shell vertex
    # is one of these sums), for the oracle
    tiny_bbox = np.stack([cx - w, cy - w, cx + w, cy + w], axis=1)
    n = N_GEOFENCE_EVENTS
    n_hot = n // 5
    ex = np.concatenate([rng.uniform(-170, 170, n - n_hot), rng.uniform(hot[0], hot[2], n_hot)])
    ey = np.concatenate([rng.uniform(-80, 80, n - n_hot), rng.uniform(hot[1], hot[3], n_hot)])
    order = rng.permutation(n)
    return ids, geoms, tiny_bbox, ex[order], ey[order], rng


def geofence_batches(ex, ey):
    from geomesa_tpu_torch import geometry as geo

    out = []
    for s in range(0, len(ex), GEOFENCE_BATCH):
        k = min(GEOFENCE_BATCH, len(ex) - s)
        out.append(([f"e{s + j}" for j in range(k)],
                    [{"name": "e", "dtg": GEOFENCE_T0 + s + j,
                      "geom": geo.Point(float(ex[s + j]), float(ey[s + j]))} for j in range(k)]))
    return out


def ring_segments(geom) -> np.ndarray:
    """[n, 4] (x0, y0, x1, y1) edges of every ring of a polygon."""
    parts = []
    for r in [geom.shell, *geom.holes]:
        c = np.asarray(r, np.float64)
        parts.append(np.concatenate([c[:-1], c[1:]], axis=1))
    return np.concatenate(parts)


def ray_cast(px, py, segs) -> bool:
    """The plain f64 even-odd test of one point against one polygon's
    edges: an edge crosses where it spans the point's y, at the abscissa
    x0 + t (x1 - x0), t = (py - y0) / (y1 - y0), right of the point."""
    y0, y1 = segs[:, 1], segs[:, 3]
    s = segs[(y0 <= py) != (y1 <= py)]
    t = (py - s[:, 1]) / (s[:, 3] - s[:, 1])
    xi = s[:, 0] + t * (s[:, 2] - s[:, 0])
    return int((xi > px).sum()) % 2 == 1


class GeofenceOracle:
    """Each event's matches by brute force: the subscriptions whose closed
    bbox holds it (the tiny squares found through their x-sorted left
    edges, the 112 large fences checked all), each decided by
    :func:`ray_cast`."""

    def __init__(self, geoms, tiny_bbox):
        self.geoms = geoms
        self.bbox = np.concatenate([tiny_bbox, [g.bounds() for g in geoms[N_SUBS:]]])
        self.order = np.argsort(tiny_bbox[:, 0], kind="stable")
        self.x0 = tiny_bbox[self.order, 0]
        self.width = float((tiny_bbox[:, 2] - tiny_bbox[:, 0]).max())
        self.big = np.arange(N_SUBS, len(geoms))
        self.segs: dict = {}

    def matches(self, px, py) -> set:
        lo = np.searchsorted(self.x0, px - self.width, side="left")
        hi = np.searchsorted(self.x0, px, side="right")
        cand = np.concatenate([self.order[lo:hi], self.big])
        b = self.bbox[cand]
        cand = cand[(b[:, 0] <= px) & (b[:, 2] >= px) & (b[:, 1] <= py) & (b[:, 3] >= py)]
        out = set()
        for o in cand.tolist():
            segs = self.segs.get(o)
            if segs is None:
                segs = self.segs[o] = ring_segments(self.geoms[o])
            if ray_cast(px, py, segs):
                out.add(o)
        return out


def match_pairs(eng, x, y, ids=None) -> list:
    """Sorted (row, subscription id) pairs of a batch through an engine."""
    pt, ords = eng.match_points(x, y)
    names = eng.index._ids
    out = sorted((int(p), names[int(o)]) for p, o in zip(pt, ords))
    return out if ids is None else [p for p in out if p[1] in ids]


def standing_ingest(torch, device, batches, population=None):
    """One streamed run over the prebuilt batches into a WAL-backed
    LambdaStore (the default sync policy) whose cold store is on the card;
    with ``population`` (ids, geoms) the engine registers it in bulk and
    warms every fused E bucket at the batch shape, with the gate. Returns
    (rows/s, store, root, registration seconds)."""
    from geomesa_tpu_torch import DataStore, FeatureType
    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.scan import block_kernels as bk
    from geomesa_tpu_torch.streaming import LambdaStore, StreamConfig

    ds = DataStore(device=device, metrics=MetricsRegistry())
    ds.create_schema(FeatureType.from_spec("ev", GEOFENCE_SPEC))
    root = tempfile.mkdtemp(prefix="geomesa_standing_")
    lam = LambdaStore(ds, "ev", config=StreamConfig(), wal_dir=os.path.join(root, "_wal"))
    reg_s = None
    if population is not None:
        eng = lam.standing()
        s = time.perf_counter()
        eng.index.register_geofences(*population)
        reg_s = time.perf_counter() - s
        for e in bk.FUSED_E_BUCKETS:
            eng.matcher.warmup(e, n_rows=GEOFENCE_BATCH, gate=eng.gate)
    wids, wrows = batches[0]
    lam.write(wrows, ids=[f"w{j}" for j in range(len(wids))])
    lam.flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids, rows in batches:
        lam.write(rows, ids=ids)
        lam.flush()
    torch.cuda.synchronize()
    return N_GEOFENCE_EVENTS / (time.perf_counter() - t0), lam, root, reg_s


def fused_host_check(torch, device, ids, geoms, ex, ey) -> dict:
    """Every hotspot event of every batch through an engine that fuses
    every eligible candidate (gate off, one routed point enough) and one
    that keeps all on the host ray cast, over the population that reaches
    the hotspot (its stars and rings, and the tiny squares whose bbox meets
    it): the match sets must be equal bit for bit, and K2 must launch."""
    from geomesa_tpu_torch import FeatureType
    from geomesa_tpu_torch.streaming.standing import StandingConfig, StandingQueryEngine

    hot = GEOFENCE_HOT
    keep = [i for i, g in enumerate(geoms)
            if (lambda b: b[0] <= hot[2] and b[2] >= hot[0] and b[1] <= hot[3]
                and b[3] >= hot[1])(g.bounds())]
    sft = FeatureType.from_spec("ev", GEOFENCE_SPEC)
    engines = {}
    # the fused engine fuses every star, so it builds no match-time
    # raster; the host engine keeps the shipped host path, rasters on
    for label, cfg in (("fused", StandingConfig(fused_gate=False, fused_min_points=1,
                                                raster_cells=0)),
                       ("host", StandingConfig(fused_min_points=0))):
        eng = StandingQueryEngine(sft, cfg, device=device)
        eng.index.register_geofences([ids[i] for i in keep], [geoms[i] for i in keep])
        engines[label] = eng
    pairs = 0
    t = {"fused": 0.0, "host": 0.0}
    for s in range(0, len(ex), GEOFENCE_BATCH):
        x, y = ex[s: s + GEOFENCE_BATCH], ey[s: s + GEOFENCE_BATCH]
        m = (x >= hot[0]) & (x <= hot[2]) & (y >= hot[1]) & (y <= hot[3])
        got = {}
        for label, eng in engines.items():
            t0 = time.perf_counter()
            got[label] = match_pairs(eng, x[m], y[m])
            t[label] += time.perf_counter() - t0
        check(got["fused"] == got["host"],
              f"standing: fused and host match sets equal on batch {s // GEOFENCE_BATCH}")
        pairs += len(got["fused"])
    fused = engines["fused"].metrics.counter_value("geomesa.standing.fused")
    check(fused > 0, "standing: the fused engine dispatched K2")
    return {"subscriptions": len(keep), "pairs": pairs, "fused_dispatches": fused,
            "fused_s": t["fused"], "host_s": t["host"]}


def standing_crash_check(torch, device, lam, root, batch_xy) -> dict:
    """Subscriptions survive a crash: a checkpoint, then 1,000 fences more
    through ``subscribe()`` (each WAL-logged before it is acknowledged),
    ``wal.crash()`` and ``LambdaStore.recover(root)`` on the card; the
    recovered engine's matches on one batch equal the live engine's
    matches of those 1,000."""
    from geomesa_tpu_torch.streaming import LambdaStore
    from geomesa_tpu_torch.streaming.standing import Subscription

    lam.checkpoint(root)
    rng = np.random.default_rng(SEED + 141)
    hot = GEOFENCE_HOT
    cx = rng.uniform(hot[0], hot[2], N_CRASH_SUBS)
    cy = rng.uniform(hot[1], hot[3], N_CRASH_SUBS)
    w = rng.uniform(0.05, 0.3, N_CRASH_SUBS)
    names = [f"crash{i}" for i in range(N_CRASH_SUBS)]
    s = time.perf_counter()
    for name, g in zip(names, squares(cx, cy, w)):
        lam.subscribe(Subscription(name, "geofence", geom=g))
    subscribe_s = time.perf_counter() - s
    x, y = batch_xy
    live = match_pairs(lam.standing(), x, y, ids=set(names))
    lam.wal.crash()
    lam.flusher.close()
    s = time.perf_counter()
    rec = LambdaStore.recover(root, device=device)
    recover_s = time.perf_counter() - s
    try:
        check(rec.cold.device.type == "cuda", "standing: recover loads onto the card")
        check(rec.standing().index.subscription_ids() == sorted(names),
              "standing: every acknowledged subscribe() survives the crash")
        got = match_pairs(rec.standing(), x, y)
        check(got == live and len(got) > 0, "standing: the recovered engine matches as the live one")
    finally:
        rec.close()
        rec.cold.close()
    return {"subscribed": N_CRASH_SUBS, "subscribe_s": subscribe_s, "recover_s": recover_s,
            "pairs": len(live)}


def standing_path(torch, device) -> dict:
    """moving-standing-1M: geofencing and alerting services (fleet
    operators, asset trackers, maritime watch) hold about a million
    persistent fences and want an alert within a fraction of a second of
    each position report. The reference's ``config_standing`` at its
    sizes but for the events (halved, in ``reduced``): ingest with the matcher off and on, the inverted index against
    the naive evaluation, the ``identical`` oracle, the alert latency;
    then fused against host, and a crash with ``subscribe()``d fences.
    Launch and native counts are zeroed before, read after."""
    import gc
    import shutil

    from geomesa_tpu_torch.streaming.standing import _ragged_pip

    gc.collect()
    gc.freeze()
    zero_launches()
    t_path = time.perf_counter()
    threads0 = stream_threads()
    sections = {}
    s = time.perf_counter()
    ids, geoms, tiny_bbox, ex, ey, rng = geofence_population(SEED + 140)
    batches = geofence_batches(ex, ey)
    gc.freeze()  # the million fences stay out of the collector's full passes
    sections["population"] = time.perf_counter() - s
    roots = []
    try:
        s = time.perf_counter()
        off_rate, off_lam, root, _ = standing_ingest(torch, device, batches)
        roots.append(root)
        off_lam.close()
        off_lam.cold.close()
        sections["ingest_off"] = time.perf_counter() - s
        s = time.perf_counter()
        on_rate, lam, root, reg_s = standing_ingest(torch, device, batches, (ids, geoms))
        roots.append(root)
        sections["ingest_on"] = time.perf_counter() - s
        eng = lam.standing()
        reg = lam.cold.metrics
        check(len(eng.index) == N_SUBS + 112, "standing: 1,000,112 subscriptions registered")
        alerts = reg.counter_value("geomesa.standing.alerts")
        fused_timed = reg.counter_value("geomesa.standing.fused")
        gate_host = reg.counter_value("geomesa.standing.gate.host")
        errors = reg.counter_value("geomesa.standing.errors")
        check(errors == 0, "standing: no matcher fault in the timed run")
        check(alerts > 0, "standing: the timed run delivered alerts")
        p99_ms = reg.histogram_quantile("geomesa.standing.latency", 0.99) * 1e3
        # the inverted index per event, then the naive evaluation of every
        # subscription on a sample
        s = time.perf_counter()
        t0 = time.perf_counter()
        for k in range(0, len(ex), GEOFENCE_BATCH):
            eng.match_points(ex[k: k + GEOFENCE_BATCH], ey[k: k + GEOFENCE_BATCH])
        inverted_us = (time.perf_counter() - t0) / len(ex) * 1e6
        _, eoff, segs, bbox, _ = eng.index._ensure_arrays()
        sample = rng.choice(len(ex), size=N_GEOFENCE_NAIVE, replace=False)
        t0 = time.perf_counter()
        for e in sample.tolist():
            px, py = float(ex[e]), float(ey[e])
            cand = np.flatnonzero((bbox[:, 0] <= px) & (bbox[:, 2] >= px)
                                  & (bbox[:, 1] <= py) & (bbox[:, 3] >= py))
            if len(cand):
                _ragged_pip(np.full(len(cand), px), np.full(len(cand), py),
                            cand.astype(np.int64), eoff, segs)
        naive_us = (time.perf_counter() - t0) / N_GEOFENCE_NAIVE * 1e6
        sections["inverted_naive"] = time.perf_counter() - s
        # identical: the matcher against the plain ray cast over each
        # sampled event's bbox candidates
        s = time.perf_counter()
        osample = rng.choice(len(ex), size=N_GEOFENCE_ORACLE, replace=False)
        opt, oords = eng.match_points(ex[osample], ey[osample])
        got = {}
        for p, o in zip(opt.tolist(), oords.tolist()):
            got.setdefault(p, set()).add(o)
        oracle = GeofenceOracle(geoms, tiny_bbox)
        mismatches = sum(oracle.matches(float(ex[e]), float(ey[e])) != got.get(row, set())
                         for row, e in enumerate(osample.tolist()))
        oracle_pairs = len(opt)
        del oracle
        check(mismatches == 0, f"standing: identical to the f64 ray cast ({mismatches} events differ)")
        sections["oracle"] = time.perf_counter() - s
        s = time.perf_counter()
        fused_host = fused_host_check(torch, device, ids, geoms, ex, ey)
        sections["fused_vs_host"] = time.perf_counter() - s
        s = time.perf_counter()
        crash = standing_crash_check(torch, device, lam, root, (ex[:GEOFENCE_BATCH],
                                                               ey[:GEOFENCE_BATCH]))
        sections["crash"] = time.perf_counter() - s
        lam.cold.close()
    finally:
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    left = [t for t in stream_threads() if t not in threads0]
    check(left == [], f"standing: close() leaves no thread: {left}")
    launches = read_launches()
    legs = read_leg_launches()
    path_s = time.perf_counter() - t_path
    reduced = {}
    if N_GEOFENCE_EVENTS != 200_000:
        reduced["events"] = {"cell": 200_000, "run": N_GEOFENCE_EVENTS}
    gc.unfreeze()
    del ids, geoms, eng, lam
    gc.collect()
    rec = {
        "phase": "standing_path", "cell": "moving-standing-1M", "launches": launches,
        "leg_launches": legs, "native": read_native(), "reduced": reduced,
        "subscriptions": N_SUBS + 112, "events": N_GEOFENCE_EVENTS, "batch": GEOFENCE_BATCH,
        "register_s": reg_s,
        "matcher_off_rows_per_s": off_rate, "matcher_on_rows_per_s": on_rate,
        "ingest_ratio": on_rate / off_rate, "ingest_ratio_bound": 0.9,
        "naive_us_per_event": naive_us, "inverted_us_per_event": inverted_us,
        "speedup_vs_naive": naive_us / max(inverted_us, 1e-9), "speedup_floor": 50.0,
        "alerts": alerts, "fused_dispatches_timed": fused_timed, "gate_host": gate_host,
        "alert_p99_ms": p99_ms, "alert_p99_objective_ms": STANDING_P99_MS,
        "oracle_events": N_GEOFENCE_ORACLE, "oracle_pairs": oracle_pairs, "identical": True,
        "fused_vs_host": fused_host, "crash": crash,
        "section_s": sections, "path_s": path_s, "budget_s": GEOFENCE_BUDGET_S,
    }
    torch.cuda.empty_cache()
    return rec


# -- WAL-shipping replication (moving-replica-60k) ---------------------------

REPLICA_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
N_REPLICA_COLD = 60_000
N_REPLICA_STREAM = 40_000
REPLICA_BATCH = 2_000
REPLICA_READ_S = 2.0
REPLICA_STALENESS_P99_MS = 2000.0  # geomesa.obs.slo.replica.staleness.p99.ms
REPLICA_BUDGET_S = 35.0
REPLICA_PROBES = ("bbox(geom, -40, -40, 0, 0)", "bbox(geom, 10, 10, 60, 50)",
                  "bbox(geom, -170, -80, -100, 0)")
REPLICA_THREADS = ("geomesa-replica-ship", "geomesa-replica-apply", "geomesa-serving",
                   "geomesa-ops", "geomesa-telemetry", "geomesa-wal-sync", "geomesa-stream")


def replica_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate()
                  if t.is_alive() and t.name.split("_")[0] in REPLICA_THREADS)


def probe_ids(store) -> list:
    return [[str(i) for i in store.query(q).ids.tolist()] for q in REPLICA_PROBES]


def replica_path(torch, device) -> dict:
    """moving-replica-60k: read-heavy tracking deployments put read
    replicas beside the ingesting leader and need a leader's death to lose
    no acknowledged write. The reference's ``config_replica`` at its
    defaults: a leader LambdaStore over a 60,000-row cold store, 40,000
    rows streamed in 2,000-row batches under ``sync=always``, two
    ReplicaStore followers over PipeTransport, all three stores on the one
    card: read scaling, bounded staleness, and a kill of the leader
    mid-ingest with a promotion. Launch and native counts are zeroed
    before, read after."""
    import json as _json
    import shutil

    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch import geometry as geo
    from geomesa_tpu_torch.storage import persist
    from geomesa_tpu_torch.streaming import (
        LambdaStore, PipeTransport, ReplicaStore, SegmentShipper, StreamConfig, WalConfig,
    )

    zero_launches()
    t_path = time.perf_counter()
    threads0 = replica_threads()
    t0_ms = GEOFENCE_T0
    tmp = tempfile.mkdtemp(prefix="geomesa_replica_")
    rng = np.random.default_rng(SEED + 98)
    n_cold = N_REPLICA_COLD
    sections = {}
    try:
        s = time.perf_counter()
        ds = DataStore(device=device)
        sft = FeatureType.from_spec("rv", REPLICA_SPEC)
        ds.create_schema(sft)
        ds.write("rv", FeatureCollection.from_columns(sft, np.arange(n_cold).astype(str), {
            "name": np.array(["v"] * n_cold), "dtg": t0_ms + rng.integers(0, 86_400_000, n_cold),
            "geom": (rng.uniform(-170, 170, n_cold), rng.uniform(-80, 80, n_cold))}),
            check_ids=False)
        ds.compact("rv")
        root = os.path.join(tmp, "s")
        persist.save(ds, root)
        lam = LambdaStore(ds, "rv", config=StreamConfig(), wal_dir=os.path.join(root, "_wal"),
                          wal_config=WalConfig(sync="always"))
        ship = SegmentShipper(lam, giveup_s=2.0)
        fols = []
        for i in range(2):
            a, b = PipeTransport.pair()
            fols.append(ReplicaStore(root, os.path.join(tmp, f"f{i}", "_wal"), b, type_name="rv",
                                     config=StreamConfig(), device=device))
            ship.attach(a, name=f"f{i}")
        for fol in fols:
            check(fol.store.cold.device.type == "cuda", "replica: a follower bootstraps on the card")
        ship.pump()
        for fol in fols:
            fol.drain()
        sections["bootstrap"] = time.perf_counter() - s
        # 1. read scaling: each store alone, full-tilt for one window
        s = time.perf_counter()
        for store in (lam, *fols):
            for q in REPLICA_PROBES:
                store.query(q)
        lead = probe_ids(lam)
        for fol in fols:
            check(probe_ids(fol) == lead, "replica: a caught-up follower's probe ids equal the "
                                          "leader's, in order")

        def measure(store):
            n = 0
            t0 = time.perf_counter()
            while True:
                store.query(REPLICA_PROBES[n % len(REPLICA_PROBES)])
                n += 1
                dt = time.perf_counter() - t0
                if dt >= REPLICA_READ_S:
                    return n / dt

        rates = [measure(st) for st in (lam, *fols)]
        qps = {k: sum(rates[: k + 1]) for k in (0, 1, 2)}
        scaling = qps[2] / max(qps[0], 1e-9)
        sections["read_scaling"] = time.perf_counter() - s
        # the first batch ships synchronously: caught up, the followers
        # answer as the leader with its hot tier in the merge
        s = time.perf_counter()
        acked = []

        def batch_rows(start):
            k = min(REPLICA_BATCH, N_REPLICA_STREAM - start)
            xs, ys = rng.uniform(-170, 170, k), rng.uniform(-80, 80, k)
            return ([f"r{start + j}" for j in range(k)],
                    [{"name": "r", "dtg": t0_ms + start + j,
                      "geom": geo.Point(float(xs[j]), float(ys[j]))} for j in range(k)])

        ids0, rows0 = batch_rows(0)
        lam.write(rows0, ids=ids0)
        acked.extend(ids0)
        ship.pump()
        for fol in fols:
            fol.drain()
            check(fol.replayed == lam.wal.last_seq, "replica: a follower replays the leader's log")
            check(probe_ids(fol) == probe_ids(lam),
                  "replica: after catch-up the probes equal the leader's with its hot tier")
        # 2. bounded staleness under sustained ingest, rolling into 3. the
        # mid-ingest kill
        ship.start()
        for fol in fols:
            fol.start()
        kill_at = max(1, (N_REPLICA_STREAM // REPLICA_BATCH) * 7 // 10)
        for bi, start in enumerate(range(REPLICA_BATCH, N_REPLICA_STREAM, REPLICA_BATCH), 1):
            ids, rows = batch_rows(start)
            lam.write(rows, ids=ids)
            acked.extend(ids)  # sync=always: the return is the acknowledgment
            if bi + 1 == kill_at:
                lam.wal.crash()  # kill -9: the leader is gone mid-ingest
                break
        stale_p99_ms = max(fol.metrics.histogram_quantile("geomesa.replica.staleness.ms", 0.99)
                           for fol in fols) * 1e3
        ship.stop()
        for fol in fols:
            fol.stop()
        sections["stream"] = time.perf_counter() - s
        s = time.perf_counter()
        t0 = time.perf_counter()
        term = fols[0].promote(leader_wal_dir=os.path.join(root, "_wal"))
        promote_s = time.perf_counter() - t0
        got = {str(i) for i in fols[0].query("INCLUDE").ids.tolist()}
        attempted = set(acked) | {str(i) for i in range(n_cold)}
        acked_loss = sum(1 for fid in acked if fid not in got)
        invented = sum(1 for fid in got if fid not in attempted)
        lagging = {str(i) for i in fols[1].query("INCLUDE").ids.tolist()}
        check(acked_loss == 0, f"replica: {acked_loss} acknowledged rows lost")
        check(invented == 0, f"replica: {invented} rows invented")
        check(lagging <= attempted, "replica: the lagging follower holds no row never written")
        check(term == 1 and fols[0].writable, "replica: the promoted follower takes term 1")
        # a deposed leader's late shipment carries term 0: refused
        sizes = dict(fols[0]._sizes)
        fenced0 = fols[0].metrics.counter_value("geomesa.replica.fenced")
        fols[0]._handle({"m": "seg", "term": 0, "name": "wal-" + "0" * 20, "off": 0,
                         "data": "QUJD", "sealed": False})
        check(fols[0].metrics.counter_value("geomesa.replica.fenced") == fenced0 + 1
              and dict(fols[0]._sizes) == sizes, "replica: a stale-term shipment is refused")
        sections["failover"] = time.perf_counter() - s
        # the ops plane of the lagging follower: the replica section, and
        # the scrapes launch nothing
        s = time.perf_counter()
        srv = fols[1].serve_ops()
        before = read_launches()
        code, body = http_get(srv.url + "/health")
        health = _json.loads(body)
        stats_code, stats_body = http_get(srv.url + "/stats")
        check(read_launches() == before, "replica: the ops scrapes launch no kernel")
        check("replica" in health and health["replica"]["replayed"] == fols[1].replayed,
              "replica: /health carries the replica section")
        check(stats_code == 200 and "rv" in _json.loads(stats_body),
              "replica: /stats answers with the follower's sketches")
        sections["ops"] = time.perf_counter() - s
        lam.flusher.close()
        lam.cold.close()
        for fol in fols:
            fol.close()
        check(srv.closed, "replica: close() closes the follower's ops plane")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    left = [t for t in replica_threads() if t not in threads0]
    check(left == [], f"replica: close() of every store and the shipper leaves no thread: {left}")
    launches = read_launches()
    reduced = {}
    if REPLICA_READ_S != 2.0:
        reduced["read_s"] = {"cell": 2.0, "run": REPLICA_READ_S}
    rec = {
        "phase": "replica_path", "cell": "moving-replica-60k", "launches": launches,
        "native": read_native(), "reduced": reduced,
        "cold_rows": n_cold, "read_s": REPLICA_READ_S,
        "qps_0f": qps[0], "qps_1f": qps[1], "qps_2f": qps[2], "qps_scaling_2f": scaling,
        "qps_scaling_bound": 1.5, "streamed_rows": len(acked), "batch": REPLICA_BATCH,
        "staleness_p99_ms": stale_p99_ms, "staleness_objective_ms": REPLICA_STALENESS_P99_MS,
        "promote_s": promote_s, "acked_rows": len(acked), "acked_loss": acked_loss,
        "invented": invented, "health_status": health["status"],
        "health_reasons": sorted(r["reason"] for r in health["reasons"]),
        "section_s": sections, "path_s": time.perf_counter() - t_path,
        "budget_s": REPLICA_BUDGET_S,
    }
    torch.cuda.empty_cache()
    return rec


def matcher_kernels(torch, device, dev) -> tuple:
    """K2 at the standing matcher's shape: a 20,000-row batch as the
    matcher lays it out (5 blocks of SUB = 32, one word group a stripe,
    +inf pad rows past the batch) and, per fused E bucket (16, 64, 256), a
    full chunk of 128 jagged-star geofences staged as
    ``FusedMatcher.stage`` stages a dispatch (spip = 1 on the 640 real
    slots, the pad slots to the 1,024-slot bucket on the no-predicate
    leg, columns x and y only). Each held against
    ``block_scan_multi_plain`` word for word, then timed. Returns ({leg:
    record}, max_abs_err, checks)."""
    from geomesa_tpu_torch import FeatureType
    from geomesa_tpu_torch.scan import block_kernels as bk
    from geomesa_tpu_torch.streaming.standing import (
        FusedMatcher, StandingConfig, StandingQueryEngine, _BatchColumns,
    )

    rng = np.random.default_rng(SEED + 142)
    hot = GEOFENCE_HOT
    x = rng.uniform(hot[0], hot[2], MATCH_ROWS)
    y = rng.uniform(hot[1], hot[3], MATCH_ROWS)
    cols = _BatchColumns(x, y, device)
    cx, cy = cols.cols3()
    named = {"x": cx, "y": cy}
    out, err, checks = {}, 0.0, 0
    for e_bucket, arms in ((16, (4, 9)), (64, (9, 33)), (256, (33, 129))):
        eng = StandingQueryEngine(FeatureType.from_spec("ev", GEOFENCE_SPEC),
                                  StandingConfig(raster_cells=0), device=device)
        eng.index.register_geofences(
            [f"k{q}" for q in range(128)],
            [star(float(rng.uniform(hot[0] + 1, hot[2] - 1)),
                  float(rng.uniform(hot[1] + 1, hot[3] - 1)),
                  float(rng.uniform(0.8, 2.5)), int(rng.integers(*arms)), np.random.default_rng(q))
             for q in range(128)])
        members = [(q, eng.index.kernel_block(q)) for q in range(128)]
        check({bk.fused_e_bucket(b.shape[0]) for _, b in members} == {e_bucket},
              f"matcher stars land in E bucket {e_bucket}")
        st = FusedMatcher.stage(cols, members)
        bids, qids, spip, edges = st["bids"], st["qids"], st["spip"], st["edges"]
        got = bk.scan_planes_multi(cols.cols3(), **st)
        pw, pi = bk.block_scan_multi_plain(
            named, dev(bids, torch.int32), dev(qids, torch.int32),
            dev(st["boxes"], torch.float32), dev(st["wins"], torch.int32),
            has_boxes=False, has_windows=False, edges=dev(edges, torch.float32),
            spip=dev(spip, torch.int32))
        err = max(err, max_abs_err(got[0], pw), max_abs_err(got[1], pi))
        check(torch.equal(got[0], pw) and torch.equal(got[1], pi),
              f"block_scan_multi matcher E{e_bucket}: planes equal to the plain version")
        check(bool(got[0].any()) and bool(got[1].any()),
              f"block_scan_multi matcher E{e_bucket} selects rows")
        checks += 1
        _, launch = bk.multi_launcher(named, bids, qids, st["boxes"], st["wins"],
                                      has_boxes=False, has_windows=False, edges=edges, spip=spip)
        m = len(bids)
        rows = m * 32 * 128
        # per slot row the packing, per real slot the polygon leg over its
        # block's rows (the pad rows included: the kernel tests them too)
        ops = rows * 6
        for q in range(128):
            ops += polygon_ops(torch, cx.reshape(-1), cy.reshape(-1), edges[q], None)
        staged = bk.stage_multi_params(bids, qids, st["boxes"], st["wins"], spip=spip,
                                       poly=bk.poly_words(edges, None, e_bucket, 0)).nbytes
        out[f"matcher:E{e_bucket}"] = {
            "ms": event_ms(launch),
            "wrapper_ms": event_ms(lambda: bk.scan_planes_multi(cols.cols3(), **st)),
            "plain_ms": event_ms(lambda: bk.block_scan_multi_plain(
                named, dev(bids, torch.int32), dev(qids, torch.int32),
                dev(st["boxes"], torch.float32), dev(st["wins"], torch.int32),
                has_boxes=False, has_windows=False, edges=dev(edges, torch.float32),
                spip=dev(spip, torch.int32)), runs=3, warmup=1),
            **bound(rows * 4 * 2 + 2 * rows // 8 + staged, ops),
            "library_ms": None,
            "real_slots": int(spip.sum()),
            "real_edges": int(bk.active_edges_many(edges[:128]).sum()),
            "shape": f"M={m} Q=128 SUB=32 rows={MATCH_ROWS} cols=x,y E={e_bucket}",
        }
        del got, pw, pi
    return out, err, checks


# -- the pipelined bulk loader, file ingest and export ------------------------

# the cell's 20M rows cut to 10M once the pod path came (the script ran
# 965.2 s on an H100 80GB HBM3 at 700 W, over its 850 s; the record's
# ``reduced``)
N_INGEST = 10_000_000
INGEST_CHUNK = 1_000_000
# config_ingest's 1, 2 and 4 workers, cut to 1 and 4 for the path's 90 s
# (106.9 s with all three on an NVIDIA H100 80GB HBM3's 8-CPU host, where
# x2 ran no faster than x1)
INGEST_WORKERS = (1, 4)
INGEST_SPAN_MS = 80 * 86_400_000  # config_ingest's span
N_INGEST_QUERIES = 64
N_INGEST_CHECK = 8
N_FILE = 200_000
FILE_SPLITS = 8
FILE_BAD_SHARE = 0.01  # half malformed, half outside the curve's domain
FILE_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
INGEST_BUDGET_S = 90.0


def table_fingerprint(ds, type_name: str) -> str:
    """bench.py's ``_table_fingerprint``: blake2b over every index table's
    sorted keys, block layout and device columns (read back to the host)
    and the stats sketch's JSON."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for (t, name) in sorted(ds._tables):
        if t != type_name:
            continue
        tab = ds._tables[(t, name)]
        h.update(f"{name}:{tab.n}:{tab.block}:{tab.n_blocks}".encode())
        h.update(np.ascontiguousarray(tab.bins).tobytes())
        h.update(np.ascontiguousarray(tab.zs).tobytes())
        for k in tab.col_names:
            h.update(tab.cols3[k].cpu().numpy().tobytes())
    stats = ds.stats_for(type_name)
    if stats is not None:
        h.update(json.dumps(stats.to_json(), default=str, sort_keys=True).encode())
    return h.hexdigest()


def ingest_chunks(seed):
    """config_ingest's data: GDELT-shaped points over 80 days, in 1M-row
    chunks of (ids, dtg, x, y); both load paths take the same arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(0, N_INGEST, INGEST_CHUNK):
        m = min(INGEST_CHUNK, N_INGEST - s)
        x, y = gdelt_points(m, rng)
        out.append((np.arange(s, s + m, dtype=np.int64),
                    T0_MS + rng.integers(0, INGEST_SPAN_MS, m), x, y))
    return out


def bin_records_by_track(data: bytes) -> np.ndarray:
    """BIN records in track order (ids are unique, so their track ids)."""
    from geomesa_tpu_torch.utils import bin_format

    rec = np.frombuffer(data, dtype=bin_format.RECORD)
    return rec[np.argsort(rec["track"], kind="stable")]


def write_split_files(root, seed) -> dict:
    """FILE_SPLITS CSV files of N_FILE seeded GDELT-shaped rows (id,
    actor name, lon, lat, ISO time); FILE_BAD_SHARE of the rows are bad:
    half carry a longitude that does not parse, half one outside
    [-180, 180] that the ``z-bounds`` validator rejects."""
    rng = np.random.default_rng(seed)
    x, y = gdelt_points(N_FILE, rng)
    t = T0_MS + rng.integers(0, INGEST_SPAN_MS, N_FILE)
    names = np.array([f"actor{i:04d}" for i in range(2_000)])[rng.integers(0, 2_000, N_FILE)]
    bad = rng.choice(N_FILE, int(N_FILE * FILE_BAD_SHARE), replace=False)
    malformed, outside = np.zeros(N_FILE, bool), np.zeros(N_FILE, bool)
    malformed[bad[: len(bad) // 2]] = True
    outside[bad[len(bad) // 2:]] = True
    x, y = np.round(x, 4), np.round(y, 4)
    lon = np.char.mod("%.4f", x)
    lon[outside] = np.char.mod("%.4f", 180.0 + 1.0 + np.abs(x[outside]))
    lon[malformed] = np.char.add("x", lon[malformed])
    when = np.datetime_as_string(t.astype("datetime64[ms]"), unit="ms")
    ids = np.char.add("e", np.arange(N_FILE).astype(str))
    lines = np.char.add(np.char.add(np.char.add(np.char.add(np.char.add(
        ids, ","), names), ","), lon), ",")
    lines = np.char.add(np.char.add(np.char.add(np.char.add(lines, np.char.mod("%.4f", y)), ","),
                                    when), "Z\n")
    paths = []
    for i, part in enumerate(np.array_split(np.arange(N_FILE), FILE_SPLITS)):
        p = os.path.join(root, f"events-{i}.csv")
        with open(p, "w") as fh:
            fh.write("id,name,lon,lat,when\n")
            fh.write("".join(lines[part].tolist()))
        paths.append(p)
    good = ~(malformed | outside)
    return {"paths": paths, "ids": ids, "names": names, "x": x, "y": y, "t": t, "good": good,
            "n_malformed": int(malformed.sum()), "n_outside": int(outside.sum())}


def export_round_trip(ds, rows, q, root) -> dict:
    """One query's result exported as CSV, GeoJSON, Avro, Shapefile, TWKB
    and BIN and read back: ids (or, where a format keeps none, the
    rows in export order) and coordinates equal the source rows."""
    from geomesa_tpu_torch import FeatureType
    from geomesa_tpu_torch.io import avro, converters, exporters, geojson, shapefile, twkb
    from geomesa_tpu_torch.utils import bin_format

    out = ds.query("files", q)
    ids = np.asarray(out.ids).astype(str)
    pos = np.searchsorted(rows["ids_sorted"], ids)
    src = rows["order"][pos]
    check(np.array_equal(rows["ids"][src], ids), "exported ids come from the files")
    x, y, t = rows["x"][src], rows["y"][src], rows["t"][src]
    col = out.geom_column
    check(np.array_equal(col.x, x) and np.array_equal(col.y, y), "the result's coordinates")
    sizes = {}

    def same(fc, what, with_ids=True):
        got = fc.geom_column
        if with_ids:
            check(np.array_equal(np.asarray(fc.ids).astype(str), ids), f"{what}: ids in order")
        check(np.array_equal(got.x, x) and np.array_equal(got.y, y), f"{what}: coordinates")
        check(np.array_equal(np.asarray(fc.columns["name"]).astype(str),
                             rows["names"][src]), f"{what}: names")

    text = exporters.export(out, "csv")
    sizes["csv"] = len(text)
    sft = FeatureType.from_spec("back", FILE_SPEC)
    conv = converters.Converter(sft=sft, skip_lines=1, id_field="$1", drop_errors=False, fields=[
        converters.FieldSpec("name", "$2"), converters.FieldSpec("dtg", "datetime($3)"),
        converters.FieldSpec("geom", "geomFromWkt($4)")])
    back = conv.convert(text)
    same(back, "csv")
    check(np.array_equal(back.columns["dtg"], t), "csv: times")
    text = exporters.export(out, "geojson")
    sizes["geojson"] = len(text)
    same(geojson.read_geojson(text, sft=sft), "geojson")
    data = exporters.export(out, "avro")
    sizes["avro"] = len(data)
    back = avro.read_avro(data, sft)
    same(back, "avro")
    check(np.array_equal(back.columns["dtg"], t), "avro: times")
    base = os.path.join(root, "export")
    shapefile.write_shapefile(out, base)
    sizes["shapefile"] = sum(os.path.getsize(base + e) for e in (".shp", ".shx", ".dbf"))
    same(shapefile.read_shapefile(base + ".shp"), "shapefile", with_ids=False)
    blobs = [twkb.to_twkb(g) for g in out.geometries()]
    sizes["twkb"] = sum(map(len, blobs))
    pts = [twkb.from_twkb(b) for b in blobs]
    check(np.array_equal([p.x for p in pts], x) and np.array_equal([p.y for p in pts], y),
          "twkb: coordinates at precision 7")
    data = ds.bin_query("files", q)
    sizes["bin"] = len(data)
    rec = np.frombuffer(data, dtype=bin_format.RECORD)
    check(np.array_equal(rec["track"], bin_format.track_ids(ids))
          and np.array_equal(rec["lon"], x.astype(np.float32))
          and np.array_equal(rec["lat"], y.astype(np.float32))
          and np.array_equal(rec["dtg"], (t // 1000).astype(np.int32)), "bin: the result's rows")
    return {"rows": len(out), "bytes": sizes}


def file_section(torch, device) -> dict:
    """200k seeded rows as 8 CSV splits, ``ingest_files(workers=4)``
    with the ``index`` validators into a store on the card (its parse
    pool forks after CUDA and the native helpers are up), the good rows'
    ids in split order, the error reasons counted as numpy counts them,
    then one query's export round trip."""
    import shutil

    from geomesa_tpu_torch import DataStore, FeatureType
    from geomesa_tpu_torch.ingest import ingest_files
    from geomesa_tpu_torch.io.converters import Converter, FieldSpec

    root = tempfile.mkdtemp(prefix="geomesa_files_")
    try:
        t0 = time.perf_counter()
        rows = write_split_files(root, SEED + 111)
        write_s = time.perf_counter() - t0
        sft = FeatureType.from_spec("files", FILE_SPEC)
        conv = Converter(sft=sft, skip_lines=1, id_field="$1", validators="index", fields=[
            FieldSpec("name", "$2"), FieldSpec("geom", "point($3, $4)"),
            FieldSpec("dtg", "datetime($5)")])
        ds = DataStore(device=device)
        ds.create_schema(sft)
        t0 = time.perf_counter()
        res = ingest_files(ds, conv, rows["paths"], workers=4)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        good = rows["good"]
        check(res.splits == FILE_SPLITS and res.written == int(good.sum()),
              "every good row written, one split a file")
        check(np.array_equal(np.asarray(ds.features("files").ids).astype(str), rows["ids"][good]),
              "the stored ids are the good rows, in split order")
        reasons = res.error_reasons
        check(reasons.get("parse", 0) == rows["n_malformed"]
              and sum(v for k, v in reasons.items() if k.startswith("z-bounds:"))
              == rows["n_outside"] and res.errors == rows["n_malformed"] + rows["n_outside"],
              f"error reasons equal the numpy counts: {reasons}")
        check(all(ds.table("files", i.name).device == torch.device(device)
                  for i in ds.indexes("files")), "the file store's tables are on the card")
        order = np.argsort(rows["ids"], kind="stable")
        rows["order"], rows["ids_sorted"] = order, rows["ids"][order]
        # a continent-scale box over the whole span: a few thousand rows
        q = "bbox(geom, -10.0, 35.0, 30.0, 55.0)"
        t0 = time.perf_counter()
        exported = export_round_trip(ds, rows, q, root)
        export_s = time.perf_counter() - t0
        ds.close()
        del ds
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"n_rows": N_FILE, "n_splits": res.splits, "write_files_s": write_s,
            "ingest_s": ingest_s, "rows_per_s": N_FILE / ingest_s, "written": res.written,
            "errors": res.errors, "error_reasons": reasons, "split_errors": res.split_errors,
            "stage_seconds": res.stage_seconds, "export": exported, "export_s": export_s}


def ingest_path(torch, device) -> dict:
    """gdelt-ingest-20M: the reference's ``config_ingest``
    (``bench.py:487-711``) on the card. ``N_INGEST`` (10M of the cell's 20M) GDELT-shaped rows in 1M-row
    chunks (``dtg:Date,*geom:Point:srid=4326``, ``z3,z2``) load through
    ``BulkLoader`` at 1 and 4 workers (``INGEST_WORKERS``), each store
    released before the next loads (the sequential ``write`` loop is cut
    for the script's wall, ``reduced``); the x4 load's tables must be
    identical to the x1 load's by bench.py's fingerprint (device columns
    read back). On the last store: the 64 BBOX + DURING queries equal the
    x1 store's ids in order and an f64 brute force on 8, density and bounds equal
    their plain versions on 4, ``bin_query`` on 8 equals
    ``bin_format.encode`` of the brute-force rows; then 312,500 rows
    (n/64) appended and compacted under an RSS sampler (the compaction
    row; the reference's is 100M rows, ``reduced``). Then the file
    section. Launch and native counts are zeroed before, read after."""
    import gc

    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch.ingest import BulkLoader, PipelineConfig
    from geomesa_tpu_torch.scripts import hostmem
    from geomesa_tpu_torch.utils import bin_format

    zero_launches()
    t_path = time.perf_counter()
    raw = ingest_chunks(SEED + 80)
    gen_s = time.perf_counter() - t_path
    queries = query_set(SEED + 2, N_INGEST_QUERIES, span_ms=INGEST_SPAN_MS)

    def load(body):
        sft = FeatureType.from_spec("gdelt", "dtg:Date,*geom:Point:srid=4326")
        sft.user_data["geomesa.indices.enabled"] = "z3,z2"
        ds = DataStore(device=device)
        ds.create_schema(sft)
        chunks = [FeatureCollection.from_columns(sft, ids, {"dtg": t, "geom": (x, y)})
                  for ids, t, x, y in raw]
        t0 = time.perf_counter()
        extra = body(ds, chunks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        fp = table_fingerprint(ds, "gdelt")
        return ds, wall, fp, time.perf_counter() - t0, extra

    loads = []
    ref_fp = ref_wall = seq_ids = fp_s = None
    for i, w in enumerate(INGEST_WORKERS):
        def pipelined(ds, chunks, w=w):
            loader = BulkLoader(ds, "gdelt", check_ids=False, config=PipelineConfig(workers=w))
            for fc in chunks:
                loader.put(fc)
            return loader.close()

        last = i == len(INGEST_WORKERS) - 1
        if last:  # the compaction row's baseline: before the store it measures
            gc.collect()
            hostmem.malloc_trim()
            rss_baseline = hostmem.rss_bytes()
        ds, wall, fp, fp_s_w, res = load(pipelined)
        check(res.written == N_INGEST, f"the x{w} load wrote every row")
        if ref_fp is None:
            # the first load is the reference (the sequential write loop is
            # cut for the script's wall: ``reduced``)
            ref_fp, ref_wall, fp_s = fp, wall, fp_s_w
            seq_ids = [np.asarray(ds.query("gdelt", q).ids) for q, _ in queries]
        check(fp == ref_fp, f"the x{w} load's tables are identical to the reference load's")
        loads.append({"workers": w, "seconds": wall, "rows_per_s": N_INGEST / wall,
                      "speedup_over_first": ref_wall / wall, "identical_tables": fp == ref_fp,
                      "stage_seconds": res.stage_seconds})
        if not last:
            ds.close()
            del ds
            torch.cuda.empty_cache()
            gc.collect()

    # the last pipelined store: the main path's queries, aggregations, BIN
    x = np.concatenate([c[2] for c in raw])
    y = np.concatenate([c[3] for c in raw])
    t = np.concatenate([c[1] for c in raw])
    del raw
    lat, outs, wall = run_queries(ds, queries)
    hits = sum(len(o) for o in outs)
    for (q, _), a, b in zip(queries, outs, seq_ids):
        check(np.array_equal(np.asarray(a.ids), b), f"the last load's ids equal the reference "
                                                     f"load's in order: {q}")
    src = (x, y, t)
    n_brute = check_queries(ds, src, queries, outs, N_INGEST_CHECK)
    n_agg = check_aggregations(torch, ds, busiest(queries, outs, 4))
    t0 = time.perf_counter()
    for q, box in queries[:N_INGEST_CHECK]:
        b = brute_ids(src, box)
        want = bin_format.encode(x[b], y[b], t[b], b)
        got = ds.bin_query("gdelt", q)
        check(len(got) == len(want) and np.array_equal(
            bin_records_by_track(got), bin_records_by_track(want)),
            f"bin_query equals bin_format.encode of the brute-force rows: {q}")
    bin_s = time.perf_counter() - t0
    del seq_ids, outs

    # the compaction row: n/64 rows appended into the delta, then compact
    rng = np.random.default_rng(SEED + 81)
    n_delta = N_INGEST // 64
    dx, dy = gdelt_points(n_delta, rng)
    dt = T0_MS + rng.integers(0, INGEST_SPAN_MS, n_delta)
    ds.write("gdelt", FeatureCollection.from_columns(
        ds.get_schema("gdelt"), np.arange(N_INGEST, N_INGEST + n_delta),
        {"dtg": dt, "geom": (dx, dy)}), check_ids=False)
    check(ds._main_rows["gdelt"] == N_INGEST, "the append stays in the delta tier")
    gc.collect()
    hostmem.malloc_trim()
    cset = hostmem.column_set_split(ds, "gdelt")
    torch.cuda.reset_peak_memory_stats()
    dev_before = torch.cuda.memory_allocated()
    with hostmem.RssSampler() as rss:
        before = rss.peak
        t0 = time.perf_counter()
        ds.compact("gdelt")
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
    dev_peak = torch.cuda.max_memory_allocated()
    src = tuple(np.concatenate(v) for v in ((x, dx), (y, dy), (t, dt)))
    check(ds.count("gdelt") == N_INGEST + n_delta, "the compacted store holds every row")
    after = queries[N_INGEST_CHECK:2 * N_INGEST_CHECK]
    n_brute += check_queries(ds, src, after, [ds.query("gdelt", q) for q, _ in after],
                             N_INGEST_CHECK)
    compaction = {
        "n_rows": N_INGEST, "delta_rows": n_delta, "seconds": compact_s,
        "column_set_host_bytes": cset["host"], "column_set_device_bytes": cset["device"],
        "rss_baseline_bytes": rss_baseline, "rss_before_bytes": before,
        "rss_peak_bytes": rss.peak, "peak_extra_bytes": rss.peak - before,
        "peak_over_column_set_host": (rss.peak - rss_baseline) / max(cset["host"], 1),
        "device_peak_over_table_bytes": (dev_peak - dev_before) / max(cset["device"], 1),
        "device_before_bytes": dev_before, "device_peak_bytes": dev_peak,
    }
    ds.close()
    del ds, x, y, t, src
    torch.cuda.empty_cache()
    gc.collect()
    loads_s = time.perf_counter() - t_path

    files = file_section(torch, device)
    launches = read_launches()
    path_s = time.perf_counter() - t_path
    return {
        "phase": "ingest_path", "cell": "gdelt-ingest-20M", "launches": launches,
        "native": read_native(), "n_rows": N_INGEST, "chunk_rows": INGEST_CHUNK,
        "host_cpus": os.cpu_count(), "generate_s": gen_s,
        "pipelined": loads, "fingerprint_s": fp_s,
        "identical_tables": all(r["identical_tables"] for r in loads),
        "n_queries": len(queries), "hits_total": hits, "queries_wall_s": wall,
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "checked_vs_brute_force": n_brute, "checked_aggregations": n_agg,
        "checked_bin_queries": N_INGEST_CHECK, "bin_check_s": bin_s,
        "compaction": compaction, "loads_s": loads_s, "files": files,
        "path_s": path_s, "budget_s": INGEST_BUDGET_S,
        "reduced": {"rows": {"cell": 20_000_000, "run": N_INGEST},
                    "compaction_rows": {"cell": 100_000_000, "run": N_INGEST},
                    "workers": {"cell": [1, 2, 4], "run": list(INGEST_WORKERS)},
                    # cut for the script's 900 s once three paths came:
                    # the x1 load is the reference the x4 load's tables,
                    # ids and speedup are held to
                    "sequential_write_loop": {"cell": "write + compact of 20M rows",
                                              "run": "not run"}},
    }


# -- the analytics tier: kNN, joins, the tile pyramid, SQL, processes --------

N_KNN_QUERIES = 64  # config_knn's queries
KNN_K = 10
KNN_CANDIDATES = 64  # the card's f64 pre-selection of the brute force's top k
N_JOIN_STARS = 64  # config_pip_join's z2_polygon_join has 128 (the record's "reduced")
N_GRID_JOIN = 2_000_000  # config_pip_join's host_grid_join sample
JOIN_PIP_CHUNK = 65_536  # points per block of the card's brute-force ray cast
TILES_LEAF_ZOOM = 3  # the reference's geomesa.tiles.leaf.zoom default
TILES_PX = 256  # and its geomesa.tiles.px
N_TILE_WRITE = 10_000
# inside leaf tile (3, 12, 3) and clear of its edges' cells in the cache
# tier's 5.625-degree generation grid, whose spans are inclusive at the top
TILE_WRITE_BOX = (97.0, 7.0, 110.0, 16.0)
TILE_TOUCHED = ((3, 12, 3), (2, 6, 1), (1, 3, 0), (0, 1, 0))  # that leaf and its ancestors
TILE_FAR = ((3, 0, 0), (2, 0, 3), (1, 0, 1), (0, 0, 0))  # tiles far west of it
N_RENDERED = 4
N_PROCESS = 1_000_000
PROCESS_SPEC = "heading:Double,dtg:Date,*geom:Point:srid=4326"
ANALYTICS_BUDGET_S = 90.0
EARTH_R_M = 6_371_000.0
M_PER_DEG = 111_320.0


def haversine(lon1, lat1, lon2, lat2) -> np.ndarray:
    """Great-circle metres in f64 numpy (the reference's formula)."""
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(v, dtype=np.float64))
                              for v in (lon1, lat1, lon2, lat2))
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2)
    return 2 * EARTH_R_M * np.arcsin(np.minimum(1.0, np.sqrt(a)))


def knn_brute(torch, xs, ys, x, y, qx, qy, k) -> tuple:
    """The k nearest rows to (qx, qy), nearest first (ties by id): the
    card's f64 haversine over every row picks KNN_CANDIDATES candidates,
    numpy's f64 haversine orders them. Returns (ids, their distances)."""
    r = np.pi / 180.0
    lat1, lon1 = qy * r, qx * r
    lat2, lon2 = ys * r, xs * r
    a = (torch.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * torch.cos(lat2) * torch.sin((lon2 - lon1) / 2) ** 2)
    d = 2 * EARTH_R_M * torch.arcsin(torch.clamp(torch.sqrt(a), max=1.0))
    cand = np.sort(torch.topk(d, KNN_CANDIDATES, largest=False).indices.cpu().numpy())
    dc = haversine(qx, qy, x[cand], y[cand])
    order = np.argsort(dc, kind="stable")[:k]
    return cand[order], dc[order]


def ring_edges_t(torch, geom, dev):
    """Every ring edge of a (multi)polygon as f64 tensors (x1, y1, x2, y2)."""
    from geomesa_tpu_torch import geometry as geo

    parts = geom.parts if isinstance(geom, geo.MultiPolygon) else [geom]
    rings = [np.asarray(r, np.float64) for p in parts for r in (p.shell, *p.holes)]
    a = np.concatenate([r[:-1] for r in rings])
    b = np.concatenate([r[1:] for r in rings])
    return tuple(torch.as_tensor(v, device=dev) for v in (a[:, 0], a[:, 1], b[:, 0], b[:, 1]))


def pip_brute(torch, xs, ys, geom, boundary: bool) -> np.ndarray:
    """Rows of the card's f64 columns inside ``geom``: the bbox first,
    then the even-odd ray cast over every ring edge (each crossing as the
    standard construction computes it: edges spanning the point's y
    half-open, the crossing's x past the point's), in blocks of rows on
    the card; ``boundary`` adds the rows exactly on an edge (collinear
    within the edge's bbox), as an intersects predicate counts them."""
    x0, y0, x1, y1 = geom.bounds()
    cand = torch.nonzero((xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)).flatten()
    ex1, ey1, ex2, ey2 = ring_edges_t(torch, geom, xs.device)
    dy = torch.where(ey2 == ey1, torch.full_like(ey1, float("inf")), ey2 - ey1)
    keep = []
    for s in range(0, len(cand), JOIN_PIP_CHUNK):
        c = cand[s:s + JOIN_PIP_CHUNK]
        px, py = xs[c][:, None], ys[c][:, None]
        spans = (ey1 <= py) != (ey2 <= py)
        xi = ex1 + (py - ey1) / dy * (ex2 - ex1)
        inside = ((spans & (xi > px)).sum(dim=1) % 2) == 1
        if boundary:
            cross = (ex2 - ex1) * (py - ey1) - (ey2 - ey1) * (px - ex1)
            on = ((cross == 0) & (torch.minimum(ex1, ex2) <= px) & (px <= torch.maximum(ex1, ex2))
                  & (torch.minimum(ey1, ey2) <= py) & (py <= torch.maximum(ey1, ey2)))
            inside |= on.any(dim=1)
        keep.append(c[inside])
    return torch.cat(keep).cpu().numpy() if keep else np.zeros(0, np.int64)


def join_stars(seed):
    """config_pip_join's join polygons: N_JOIN_STARS (its 128) concave
    stars of 16-254 edges (8, 16, 50 or 127 arms), radii 1-6 degrees,
    centres over the lon -150..150, lat -60..60 box."""
    rng = np.random.default_rng(seed)
    return [star(float(rng.uniform(-150, 150)), float(rng.uniform(-60, 60)),
                 float(rng.uniform(1.0, 6.0)), int(rng.choice([8, 16, 50, 127])),
                 np.random.default_rng(seed + 1000 + k))
            for k in range(N_JOIN_STARS)]


def polygons_fc(polys):
    from geomesa_tpu_torch import FeatureCollection, FeatureType
    from geomesa_tpu_torch import geometry as geo

    return FeatureCollection.from_columns(
        FeatureType.from_spec("adm", "*geom:Polygon:srid=4326"), np.arange(len(polys)),
        {"geom": geo.PackedGeometryColumn.from_geometries(polys)})


def pair_keys(li, ri, n) -> np.ndarray:
    return np.asarray(li, np.int64) * n + np.asarray(ri, np.int64)


def knn_section(torch, ds, xs, ys, x, y, rng) -> dict:
    """config_knn: 64 query points near the data (source points moved up
    to half a degree), k = 10, through ``knn_many`` (every round's
    windows in one ``planner.submit_many``: K2) and per point through
    ``knn_search``; both equal, in order, the f64 brute force."""
    from geomesa_tpu_torch.process import knn_many, knn_search

    pick = rng.choice(len(x), N_KNN_QUERIES, replace=False)
    pts = [(float(np.clip(x[i] + rng.uniform(-0.5, 0.5), -179.5, 179.5)),
            float(np.clip(y[i] + rng.uniform(-0.5, 0.5), -89.5, 89.5))) for i in pick]
    knn_many(ds, "gdelt", pts[:8], k=KNN_K)  # warm-up
    rounds = []
    submit = ds.planner.submit_many

    def counting(plans, *a, **kw):
        rounds.append(len(plans))
        return submit(plans, *a, **kw)

    before = read_launches()
    ds.planner.submit_many = counting
    try:
        t0 = time.perf_counter()
        many = knn_many(ds, "gdelt", pts, k=KNN_K)
        many_s = time.perf_counter() - t0
    finally:
        del ds.planner.submit_many
    many_launch = launch_delta(before)
    before = read_launches()
    t0 = time.perf_counter()
    single = [knn_search(ds, "gdelt", qx, qy, k=KNN_K) for qx, qy in pts]
    single_s = time.perf_counter() - t0
    single_launch = launch_delta(before)
    check(many_launch["block_scan_multi"] > 0, "knn_many launched K2")
    check(single_launch["block_scan"] > 0, "knn_search launched K1")
    ties = 0
    t0 = time.perf_counter()
    for (qx, qy), got_m, got_s in zip(pts, many, single):
        gm = np.asarray(got_m.ids, np.int64)
        check(np.array_equal(gm, np.asarray(got_s.ids, np.int64)),
              f"knn_many equals knn_search at {qx}, {qy}")
        want, wd = knn_brute(torch, xs, ys, x, y, qx, qy, KNN_K)
        if not np.array_equal(gm, want):
            # equal distances have no order of their own: allowed only
            # where the distances tie exactly
            check(len(gm) == KNN_K and np.array_equal(haversine(qx, qy, x[gm], y[gm]), wd),
                  f"knn ids in order vs the f64 brute force at {qx}, {qy}")
            ties += 1
    return {
        "n_queries": N_KNN_QUERIES, "k": KNN_K,
        "knn_many_s": many_s, "knn_many_qps": N_KNN_QUERIES / many_s,
        "knn_search_s": single_s, "knn_search_qps": N_KNN_QUERIES / single_s,
        "rounds": len(rounds), "windows_per_round": rounds,
        "launches_knn_many": many_launch, "launches_knn_search": single_launch,
        "brute_force_s": time.perf_counter() - t0, "tie_reorders": ties,
    }


def join_section(torch, ds, xs, ys, x, y) -> dict:
    """config_pip_join: ``spatial_join_indexed`` of N_JOIN_STARS concave stars
    against the 20M points, ``contains`` and ``intersects``, rasters off
    and on (one fused dispatch set through K2 each), each run cold (the
    setting's first call builds the stars' rasters) and then timed warm,
    as the reference's bench times it; pairs equal across the raster
    settings and to the card's f64 ray cast; then the host grid join,
    exact and adaptive (cold, then warm), on a seeded 2M-row sample."""
    from geomesa_tpu_torch import FeatureCollection
    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.sql import spatial_join, spatial_join_indexed

    polys = join_stars(SEED + 92)
    left = polygons_fc(polys)
    n = len(x)
    out, truth = {}, {}
    t0 = time.perf_counter()
    for pred in ("contains", "intersects"):
        truth[pred] = np.sort(np.concatenate([
            pair_keys(np.full(len(r), k), r, n)
            for k, g in enumerate(polys) for r in [pip_brute(torch, xs, ys, g, pred == "intersects")]]))
    brute_s = time.perf_counter() - t0
    for pred in ("contains", "intersects"):
        for raster in ("off", "on"):
            reg = MetricsRegistry()
            with raster_knob("RASTER_ENABLED", raster == "on", ds):
                before = read_launches()
                t0 = time.perf_counter()
                cold = spatial_join_indexed(ds, "gdelt", left, pred)
                cold_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                li, ri = spatial_join_indexed(ds, "gdelt", left, pred, metrics=reg)
                wall = time.perf_counter() - t0
                launched = launch_delta(before)
            check(np.array_equal(pair_keys(*cold, n), pair_keys(li, ri, n)),
                  f"cold and warm join pairs equal: {pred} {raster}")
            keys = pair_keys(li, ri, n)
            check(np.all(np.diff(keys) > 0), f"join pairs sorted by (left, right): {pred} {raster}")
            check(np.array_equal(keys, truth[pred]),
                  f"indexed join pairs vs the f64 ray cast: {pred}, rasters {raster}")
            check(launched["block_scan_multi"] > 0, f"the indexed join launched K2: {pred} {raster}")
            out[f"{pred}_rasters_{raster}"] = {
                "ms": wall * 1e3, "cold_ms": cold_s * 1e3, "pairs": int(len(li)),
                "launches": launched,
                "strategy": {k: reg.counter_value(f"geomesa.join.strategy.{k}")
                             for k in ("probe", "host_raster")},
            }
    # the host grid join on a seeded sample of the rows
    rng = np.random.default_rng(SEED + 93)
    sample = np.sort(rng.choice(n, N_GRID_JOIN, replace=False))
    right = FeatureCollection.from_columns(
        ds.get_schema("gdelt"), sample, {"geom": (x[sample], y[sample])})
    host = {}
    for strategy in ("exact", "auto", "auto"):  # adaptive cold (rasters built), then warm
        reg = MetricsRegistry()
        t0 = time.perf_counter()
        li, ri = spatial_join(left, right, "intersects", strategy=strategy, metrics=reg)
        host.setdefault(strategy, []).append((time.perf_counter() - t0, li, ri, {
            k: reg.counter_value(f"geomesa.join.strategy.{k}") for k in ("exact", "raster")}))
    (ex_s, el, er, ec), (ad_cold_s, *_), (ad_s, al, ar, ac) = *host["exact"], *host["auto"]
    for _, al_, ar_, _ in host["auto"]:
        check(np.array_equal(el, al_) and np.array_equal(er, ar_), "host join: exact = adaptive pairs")
    want = truth["intersects"][np.isin(truth["intersects"] % n, sample)]
    check(np.array_equal(np.sort(pair_keys(el, sample[er], n)), want),
          "host join pairs vs the f64 ray cast over the sample")
    out["host_grid_join"] = {"rows": N_GRID_JOIN, "pairs": int(len(el)), "exact_ms": ex_s * 1e3,
                             "adaptive_cold_ms": ad_cold_s * 1e3, "adaptive_ms": ad_s * 1e3,
                             "exact_partitions": ec, "adaptive_partitions": ac}
    out["brute_force_s"] = brute_s
    out["n_polygons"] = N_JOIN_STARS
    return out


def pyramid_section(torch, ds, x, y) -> dict:
    """The tile pyramid at the reference's leaf zoom 3 and 256 px: every
    tile of zooms 0-3 (2 x 1, 4 x 2, 8 x 4 and 16 x 8: 170) fetched cold,
    leaves first, then warm; each grid equal to ``TilePyramid.fresh`` bit
    for bit and each zoom's total the table's rows; every kind rendered
    on 4 tiles and inflated to its size; then a 10k-row write inside one
    leaf: far tiles keep their ticks and compose nothing, the leaf and its
    ancestors recompose equal to ``fresh``."""
    import struct
    import zlib

    from geomesa_tpu_torch import FeatureCollection
    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.tiles import KINDS, TilePyramid, TilesConfig, render

    reg = MetricsRegistry()
    pyr = TilePyramid(ds, TilesConfig.from_properties(), metrics=reg)
    check((pyr.lattice.leaf_zoom, pyr.conf.px) == (TILES_LEAF_ZOOM, TILES_PX),
          "the pyramid runs at the reference's leaf zoom and tile size")
    tiles = [(z, tx, ty) for z in range(TILES_LEAF_ZOOM, -1, -1)
             for tx in range(pyr.lattice.n_tiles(z)[0]) for ty in range(pyr.lattice.n_tiles(z)[1])]
    before = read_launches()
    cold, warm = {}, {}
    for label, into in (("cold", cold), ("warm", warm)):
        for z, tx, ty in tiles:
            t0 = time.perf_counter()
            pyr.fetch("gdelt", z, tx, ty)
            into.setdefault(z, []).append(time.perf_counter() - t0)
    launched = launch_delta(before)
    check(launched["block_scan"] > 0, "the pyramid's leaf scans launched K1")
    composed = reg.counter_value("geomesa.tiles.compose")
    check(composed == len(tiles), "each tile composed once, then served warm")
    t0 = time.perf_counter()
    totals = {}
    for z, tx, ty in tiles:
        g = pyr.fetch("gdelt", z, tx, ty)
        check(np.array_equal(g.grid, pyr.fresh("gdelt", z, tx, ty).grid),
              f"tile {z}/{tx}/{ty} equals fresh")
        totals[z] = totals.get(z, 0.0) + float(g.grid.sum())
    fresh_s = time.perf_counter() - t0
    n = len(x)
    check(all(v == float(n) for v in totals.values()), "every zoom counts each row once")
    pngs = 0
    for z, tx, ty in tiles[-N_RENDERED:]:
        grid = pyr.fetch("gdelt", z, tx, ty).grid
        for kind in KINDS:
            png = render(kind, grid)
            w, h = struct.unpack(">II", png[16:24])
            i = png.index(b"IDAT")
            (length,) = struct.unpack(">I", png[i - 4:i])
            raw = zlib.decompress(png[i + 4:i + 4 + length])
            check((w, h) == (TILES_PX, TILES_PX) and len(raw) == h * (1 + w),
                  f"{kind} PNG of {z}/{tx}/{ty} inflates to its size")
            pngs += 1
    # scoped invalidation: a localized write dirties only its leaf's chain
    ticks = {t: pyr.fetch("gdelt", *t).tick for t in TILE_FAR + TILE_TOUCHED}
    rng = np.random.default_rng(SEED + 94)
    x0, y0, x1, y1 = TILE_WRITE_BOX
    wx, wy = rng.uniform(x0, x1, N_TILE_WRITE), rng.uniform(y0, y1, N_TILE_WRITE)
    ds.write("gdelt", FeatureCollection.from_columns(
        ds.get_schema("gdelt"), np.arange(n, n + N_TILE_WRITE), {"geom": (wx, wy)}),
        check_ids=False)
    c0 = reg.counter_value("geomesa.tiles.compose")
    for t in TILE_FAR:
        check(pyr.peek("gdelt", *t) is not None, f"far tile {t} stays warm")
        check(pyr.fetch("gdelt", *t).tick == ticks[t], f"far tile {t} keeps its tick")
    check(reg.counter_value("geomesa.tiles.compose") == c0, "far tiles compose nothing")
    for t in TILE_TOUCHED:
        check(pyr.peek("gdelt", *t) is None, f"touched tile {t} is stale")
    for t in TILE_TOUCHED:
        g = pyr.fetch("gdelt", *t)
        check(g.tick > ticks[t], f"touched tile {t} recomposed at a new tick")
        check(np.array_equal(g.grid, pyr.fresh("gdelt", *t).grid), f"touched tile {t} equals fresh")
    recomposed = reg.counter_value("geomesa.tiles.compose") - c0
    check(recomposed == len(TILE_TOUCHED), "the write recomposes its leaf and its ancestors")
    z0 = sum(float(pyr.fetch("gdelt", 0, tx, 0).grid.sum()) for tx in range(2))
    check(z0 == float(n + N_TILE_WRITE), "zoom 0 counts the written rows")

    def p50(d):
        return {str(z): float(np.percentile(v, 50) * 1e3) for z, v in sorted(d.items())}

    return {
        "leaf_zoom": TILES_LEAF_ZOOM, "px": TILES_PX, "tiles": len(tiles),
        "cold_fetch_p50_ms": float(np.percentile(sum(cold.values(), []), 50) * 1e3),
        "warm_fetch_p50_ms": float(np.percentile(sum(warm.values(), []), 50) * 1e3),
        "cold_fetch_p50_ms_by_zoom": p50(cold), "warm_fetch_p50_ms_by_zoom": p50(warm),
        "cold_s": float(sum(sum(v) for v in cold.values())),
        "warm_s": float(sum(sum(v) for v in warm.values())),
        "fresh_check_s": fresh_s, "launches": launched, "pngs_checked": pngs,
        "written_rows": N_TILE_WRITE, "recomposed_after_write": int(recomposed),
        "leaf_scans": reg.counter_value("geomesa.tiles.leaf.scan"),
        "stats": {k: v for k, v in pyr.stats().items()},
    }


def sql_statements(pip):
    """(sql, brute-force mask over (x, y), ordered) for the 8 statements:
    ``ordered`` is None where the statement fixes no order, else (output
    column, descending, offset, limit) of the rows sorted by x; ``pip``
    (geometry, boundary) -> the rows inside it, as a mask."""
    from geomesa_tpu_torch import geometry as geo

    rng = np.random.default_rng(SEED + 95)
    s1 = star(30.0, 10.0, 4.0, 16, rng)
    s2 = star(-60.0, -15.0, 3.0, 50, rng)
    w1, w2 = geo.to_wkt(s1), geo.to_wkt(s2)
    return [
        ("SELECT * FROM gdelt WHERE st_bbox(geom, 10, 40, 20, 45)",
         lambda x, y: (x >= 10) & (x <= 20) & (y >= 40) & (y <= 45), None),
        (f"SELECT * FROM gdelt WHERE st_intersects(geom, st_geomfromwkt('{w1}'))",
         lambda x, y: pip(s1, True), None),
        (f"SELECT * FROM gdelt WHERE st_contains(st_geomfromwkt('{w2}'), geom)",
         lambda x, y: pip(s2, False), None),
        ("SELECT * FROM gdelt WHERE st_within(geom, st_makebbox(-10, -10, 0, 0))",
         lambda x, y: (x > -10) & (x < 0) & (y > -10) & (y < 0), None),
        ("SELECT * FROM gdelt WHERE st_dwithin(geom, st_point(2.35, 48.85), 1.5)",
         lambda x, y: np.hypot(x - 2.35, y - 48.85) <= 1.5, None),
        ("SELECT st_x(geom) AS lon, st_y(geom) AS lat FROM gdelt "
         "WHERE st_bbox(geom, -80, 30, -70, 40) ORDER BY lon DESC LIMIT 25",
         lambda x, y: (x >= -80) & (x <= -70) & (y >= 30) & (y <= 40), ("lon", True, 0, 25)),
        ("SELECT * FROM gdelt WHERE st_bbox(geom, 30, 0, 32, 2) "
         "AND st_distancesphere(geom, st_point(31, 1)) < 80000",
         lambda x, y: ((x >= 30) & (x <= 32) & (y >= 0) & (y <= 2)
                       & (haversine(x, y, 31.0, 1.0) < 80000)), None),
        ("SELECT st_x(geom) AS lon FROM gdelt WHERE st_bbox(geom, 120, -40, 150, -10) "
         "AND st_y(geom) > -20 ORDER BY lon LIMIT 10 OFFSET 5",
         lambda x, y: (x >= 120) & (x <= 150) & (y >= -40) & (y <= -10) & (y > -20),
         ("lon", False, 5, 10)),
    ]


def sql_section(torch, ds, xs, ys, x, y) -> dict:
    """Eight ``sql_query`` statements over the 20M points: a bbox,
    ``ST_Intersects`` with a star, ``ST_Contains`` by a star,
    ``ST_Within`` a box, ``ST_DWithin``, ``ORDER BY`` / ``LIMIT`` on a
    select alias, a residual ``ST_DistanceSphere`` and a residual with
    ``OFFSET``; ids equal the f64 brute force (as sets where the statement
    fixes no order), the ordered ones' coordinates equal the brute force
    sorted."""
    from geomesa_tpu_torch.sql import sql_query

    def pip(geom, boundary):
        mask = np.zeros(len(x), bool)
        mask[pip_brute(torch, xs, ys, geom, boundary)] = True
        return mask

    out = []
    for sql, brute, ordered in sql_statements(pip):
        t0 = time.perf_counter()
        got = sql_query(ds, sql)
        wall = time.perf_counter() - t0
        want = np.flatnonzero(brute(x, y))
        if ordered is None:
            check(np.array_equal(np.sort(np.asarray(got.ids, np.int64)), want), f"sql vs brute: {sql}")
        else:
            col, desc, off, lim = ordered
            vals = np.sort(x[want])
            vals = vals[::-1] if desc else vals
            check(np.array_equal(np.asarray(got.columns[col], np.float64), vals[off:off + lim]),
                  f"sql ordered rows vs brute: {sql}")
        out.append({"sql": sql[:60], "rows": len(got), "ms": wall * 1e3})
    return {"statements": out, "n": len(out)}


def process_store(torch, device, n, seed):
    """A GDELT-shaped Z3 + Z2 store of n tracked points with ``dtg`` over
    the span and a compass ``heading``; returns (store, (x, y, t, h))."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    rng = np.random.default_rng(seed)
    x, y = gdelt_points(n, rng)
    t = T0_MS + rng.integers(0, SPAN_MS, n)
    h = rng.uniform(0, 360, n)
    sft = FeatureType.from_spec("track", PROCESS_SPEC)
    sft.user_data["geomesa.indices.enabled"] = "z3,z2"
    ds = DataStore(device=device)
    ds.create_schema(sft)
    ds.write("track", FeatureCollection.from_columns(
        sft, np.arange(n), {"heading": h, "dtg": t, "geom": (x, y)}), check_ids=False)
    torch.cuda.synchronize()
    return ds, (x, y, t, h)


def route_brute(x, y, h, route, buffer_m, thr) -> np.ndarray:
    """Rows within ``buffer_m`` of the route whose heading is within
    ``thr`` degrees of the closest segment's bearing, in a local
    equirectangular projection around each row (numpy f64)."""
    a, b = route[:-1], route[1:]
    best_d = np.full(len(x), np.inf)
    best_b = np.zeros(len(x))
    for s in range(len(a)):
        scale = np.cos(np.radians(y)) * M_PER_DEG
        ax, ay = (a[s, 0] - x) * scale, (a[s, 1] - y) * M_PER_DEG
        bx, by = (b[s, 0] - x) * scale, (b[s, 1] - y) * M_PER_DEG
        dx, dy = bx - ax, by - ay
        tt = np.clip(-(ax * dx + ay * dy) / np.maximum(dx * dx + dy * dy, 1e-12), 0.0, 1.0)
        cx, cy = ax + tt * dx, ay + tt * dy
        d = np.sqrt(cx * cx + cy * cy)
        bearing = (np.degrees(np.arctan2(dx, dy)) + 360.0) % 360.0
        better = d < best_d
        best_d[better], best_b[better] = d[better], bearing[better]
    diff = np.abs(best_b - h)
    diff = np.where(diff > 180.0, np.abs(diff - 360.0), diff)
    return np.flatnonzero((best_d <= buffer_m) & (diff <= thr))


def process_section(torch, device) -> dict:
    """``proximity_search``, ``tube_select`` and ``route_search`` once
    each on a 1M-row Z3 + Z2 store of tracked points (its own seed), each
    against an f64 brute force over every row."""
    from geomesa_tpu_torch.process import proximity_search, route_search, tube_select

    t0 = time.perf_counter()
    ds, (x, y, t, h) = process_store(torch, device, N_PROCESS, SEED + 96)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 97)
    pts = np.stack([x, y], 1)[rng.choice(N_PROCESS, 8, replace=False)]
    cx, cy = cluster_centres(SEED + 96)
    out = {"build_s": build_s, "n_rows": N_PROCESS}
    t0 = time.perf_counter()
    got = proximity_search(ds, "track", pts, 50_000.0)
    out["proximity_ms"] = (time.perf_counter() - t0) * 1e3
    d = np.min([haversine(px, py, x, y) for px, py in pts], axis=0)
    want = np.flatnonzero(d <= 50_000.0)
    check(np.array_equal(np.sort(np.asarray(got.ids, np.int64)), want), "proximity vs brute force")
    out["proximity_hits"] = len(want)
    track = np.stack([cx[0] + np.linspace(-4, 4, 20), cy[0] + np.linspace(-2, 2, 20)], 1)
    times = T0_MS + np.linspace(0, 30 * 86_400_000, 20).astype(np.int64)
    t0 = time.perf_counter()
    got = tube_select(ds, "track", track, times, buffer_m=200_000.0)
    out["tube_ms"] = (time.perf_counter() - t0) * 1e3
    live = (t >= times[0]) & (t <= times[-1])
    px, py = np.interp(t, times, track[:, 0]), np.interp(t, times, track[:, 1])
    want = np.flatnonzero(live & (haversine(x, y, px, py) <= 200_000.0))
    check(np.array_equal(np.sort(np.asarray(got.ids, np.int64)), want), "tube vs brute force")
    out["tube_hits"] = len(want)
    route = np.array([[cx[1] - 3, cy[1] - 1], [cx[1], cy[1] - 1], [cx[1], cy[1] + 1],
                      [cx[1] + 3, cy[1] + 2], [cx[1] + 4, cy[1] - 1]])
    t0 = time.perf_counter()
    got = route_search(ds, "track", route, 25_000.0, 30.0, heading_field="heading")
    out["route_ms"] = (time.perf_counter() - t0) * 1e3
    want = route_brute(x, y, h, route, 25_000.0, 30.0)
    check(np.array_equal(np.sort(np.asarray(got.ids, np.int64)), want), "route vs brute force")
    out["route_hits"] = len(want)
    check(min(out["proximity_hits"], out["tube_hits"], out["route_hits"]) > 0,
          "every process finds rows")
    ds.close()
    return out


def analytics_path(torch, device) -> dict:
    """gdelt-z2-20M-analytics: the analytics tier on the Z2 polygon
    cell's 20M GDELT points, built again with the cache tier
    (``DataStore(cache=True)``) so the pyramid caches and invalidates:
    kNN (``config_knn``), the indexed and host joins
    (``config_pip_join``), the tile pyramid (``config_tiles``' leaf zoom
    and tile size), eight SQL statements, then proximity, tube and route
    search on a 1M-row Z3 store with times and headings. Launch and
    native counts are zeroed before, read after."""
    zero_launches()
    t_path = time.perf_counter()
    ds, (x, y, _), ingest_s = build_store(torch, device, N_Z2, index="z2", seed=SEED + 30,
                                          cache=True)
    xs = torch.as_tensor(x, device=device)
    ys = torch.as_tensor(y, device=device)
    rng = np.random.default_rng(SEED + 91)
    sections = {"ingest_s": ingest_s}
    for name, fn in (("knn", lambda: knn_section(torch, ds, xs, ys, x, y, rng)),
                     ("join", lambda: join_section(torch, ds, xs, ys, x, y)),
                     ("sql", lambda: sql_section(torch, ds, xs, ys, x, y)),
                     ("pyramid", lambda: pyramid_section(torch, ds, x, y))):
        t0 = time.perf_counter()
        sections[name] = fn()
        sections[name]["section_s"] = time.perf_counter() - t0
    ds.close()
    del ds, xs, ys
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sections["process"] = process_section(torch, device)
    sections["process"]["section_s"] = time.perf_counter() - t0
    path_s = time.perf_counter() - t_path
    return {
        "phase": "analytics_path", "cell": "gdelt-z2-20M-analytics",
        "launches": read_launches(), "native": read_native(), "n_points": N_Z2,
        **sections, "path_s": path_s, "budget_s": ANALYTICS_BUDGET_S,
        "reduced": {"join_stars": {"cell": 128, "run": N_JOIN_STARS}},
    }


# -- the data plane, the S2 indexes, the tuning tier ----------------------

# config_serve_http's cold store, raised from its 40k default to the
# cell's 2M, run at 1M since the pod path came (the record's "reduced")
N_HTTP = 1_000_000
HTTP_SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
HTTP_T0 = 1_717_200_000_000  # config_serve_http's t0
HTTP_PROBES = ("bbox(geom, -40, -40, 0, 0)", "bbox(geom, 10, 10, 60, 50)",
               "bbox(geom, -170, -80, -100, 0)")
HTTP_READ_S = 2.0  # config_serve_http's mixed loop
HTTP_FAIR_S = 2.0  # and its fairness loops, cut from its 6 s (the record's "reduced")
HTTP_DEGRADATION_BOUND = 1.5  # its gate on the compliant tenant's p99
HTTP_BURST = 16  # concurrent /query requests of one burst (a fused batch)
HTTP_TILES = (("density", 1, 1, 0), ("count", 2, 5, 2), ("heat", 0, 0, 0), ("density", 3, 11, 4))
HTTP_CLI_Q = "bbox(geom, 10, 10, 20, 20)"
HTTP_BUDGET_S = 60.0
SERVE_THREADS = ("geomesa-serve", "geomesa-serving", "geomesa-ops", "geomesa-telemetry")


def serve_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate()
                  if t.is_alive() and t.name in SERVE_THREADS)


def http_rows(prefix, b, k, t0):
    """One ingest batch as config_serve_http posts it: k points, ids
    ``<prefix><b>-<j>``."""
    return {"type": "FeatureCollection", "features": [
        {"type": "Feature", "id": f"{prefix}{b}-{j}",
         "geometry": {"type": "Point", "coordinates": [float(b % 90), float(j % 45)]},
         "properties": {"name": prefix, "dtg": t0 + b * k + j}} for j in range(k)]}


def http_mixed(srv, seconds) -> dict:
    """config_serve_http's mixed closed loop: two readers (limit 256) and
    one ingester of 200-row GeoJSON batches, each on its own kept-alive
    client."""
    import threading

    from geomesa_tpu_torch.serving import DataClient

    stop = threading.Event()
    reads, rows, errors = [0, 0], [0], []

    def reader(slot):
        c = DataClient(srv.url, keep_alive=True)
        try:
            while not stop.is_set():
                c.query("sv", cql=HTTP_PROBES[reads[slot] % len(HTTP_PROBES)], limit=256)
                reads[slot] += 1
        except Exception as e:  # noqa: BLE001 - reported by the check below
            errors.append(repr(e))
        finally:
            c.close()

    def ingester():
        c = DataClient(srv.url, keep_alive=True)
        b = 0
        try:
            while not stop.is_set():
                rows[0] += c.ingest("sv", http_rows("m", b, 200, HTTP_T0))["acked"]
                b += 1
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))
        finally:
            c.close()

    ts = [threading.Thread(target=reader, args=(i,)) for i in range(2)]
    ts.append(threading.Thread(target=ingester))
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in ts:
        t.join(60)
    dt = time.perf_counter() - t0
    check(not errors, f"the mixed loop's clients saw no error: {errors[:3]}")
    return {"read_qps": sum(reads) / dt, "ingest_rows_per_s": rows[0] / dt,
            "reads": sum(reads), "ingested_rows": rows[0], "seconds": dt}


def http_fairness(srv, seconds) -> dict:
    """config_serve_http's fairness: the compliant tenant's read p99
    alone, then under an adversary (quota 1) flooding from 3 threads that
    back off only by the server's Retry-After."""
    import threading

    from geomesa_tpu_torch.serving import DataClient, ServeError

    def compliant_loop(warm_s=1.0):
        c = DataClient(srv.url, tenant="compliant", keep_alive=True)
        lats, i, t0 = [], 0, time.perf_counter()
        while True:
            q0 = time.perf_counter()
            c.query("sv", cql=HTTP_PROBES[i % len(HTTP_PROBES)], limit=256)
            if q0 - t0 >= warm_s:
                lats.append(time.perf_counter() - q0)
            i += 1
            if time.perf_counter() - t0 >= warm_s + seconds:
                c.close()
                return lats

    iso = compliant_loop()
    srv.tenants.configure("adversary", queue_max=1)
    stop = threading.Event()
    statuses: dict = {}

    def adversary():
        c = DataClient(srv.url, tenant="adversary", timeout=10.0, keep_alive=True)
        while not stop.is_set():
            try:
                c.query("sv", cql="bbox(geom, 3.0, 3.0, 3.5, 3.5)", limit=1)
                statuses[200] = statuses.get(200, 0) + 1
            except ServeError as e:
                statuses[e.status] = statuses.get(e.status, 0) + 1
                time.sleep(min(e.retry_after or 0.05, 0.25))
            except OSError:
                pass
        c.close()

    floods = [threading.Thread(target=adversary) for _ in range(3)]
    for t in floods:
        t.start()
    try:
        flooded = compliant_loop()
    finally:
        stop.set()
        for t in floods:
            t.join(30)
    p99_iso = float(np.percentile(np.array(iso) * 1e3, 99))
    p99_flood = float(np.percentile(np.array(flooded) * 1e3, 99))
    rows = {r["tenant"]: r for r in srv.tenants.report()["tenants"]}
    adv = rows.get("adversary", {})
    check(adv.get("shed", 0) > 0 and statuses.get(429, 0) > 0,
          "the adversary was shed with 429s")
    check(adv.get("shed", 0) == statuses.get(429, 0),
          "every 429 the adversary saw is accounted to it")
    check(rows["compliant"]["shed"] == 0, "the compliant tenant shed nothing")
    return {"compliant_p99_isolated_ms": p99_iso, "compliant_p99_flood_ms": p99_flood,
            "degradation": p99_flood / max(p99_iso, 1e-9),
            "degradation_bound": HTTP_DEGRADATION_BOUND,
            "compliant_requests": len(iso) + len(flooded),
            "adversary_submitted": adv.get("submitted"), "adversary_shed": adv.get("shed"),
            "adversary_statuses": {str(k): v for k, v in sorted(statuses.items())}}


def http_burst(srv, rounds=2) -> dict:
    """HTTP_BURST readers released together, each with its own box: one
    scheduler window collects them, so the scans fuse (K2)."""
    import threading

    from geomesa_tpu_torch.serving import DataClient

    rng = np.random.default_rng(SEED + 131)
    boxes = [(float(x), float(y)) for x, y in
             zip(rng.uniform(-160, 120, HTTP_BURST), rng.uniform(-70, 30, HTTP_BURST))]
    answers = {}
    for r in range(rounds):
        gate = threading.Barrier(HTTP_BURST)

        def one(i, r=r, gate=gate):
            x0, y0 = boxes[i]
            q = f"bbox(geom, {x0 + r:.4f}, {y0:.4f}, {x0 + r + 30:.4f}, {y0 + 30:.4f})"
            c = DataClient(srv.url)
            gate.wait(30)
            answers[(r, i)] = (q, [f["id"] for f in c.query("sv", cql=q, limit=256)["features"]])

        ts = [threading.Thread(target=one, args=(i,)) for i in range(HTTP_BURST)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
    check(len(answers) == rounds * HTTP_BURST, "every burst request answered")
    return {"requests": len(answers), "answers": answers}


def http_statuses(srv) -> dict:
    """400, 403, 404, 413 and 429, each from one request."""
    from geomesa_tpu_torch.serving import DataClient

    c = DataClient(srv.url)
    srv.tenants.configure("flood", queue_max=0)
    got = {
        400: c.request("GET", "/query/sv?fmt=csv")[0],
        403: c.request("GET", "/query/sv", headers={"X-Geomesa-Auths": "admin"})[0],
        404: c.request("GET", "/query/nope")[0],
        413: c.request("POST", "/ingest/sv",
                       headers={"Content-Length": str(srv.max_body_bytes + 1)})[0],
        429: c.request("GET", "/query/sv", headers={"X-Geomesa-Tenant": "flood"})[0],
    }
    for want, status in got.items():
        check(status == want, f"the data plane answers {want}")
    _, hdrs, _ = c.request("GET", "/query/sv", headers={"X-Geomesa-Tenant": "flood"})
    check(float(hdrs.get("Retry-After", 0)) > 0, "a 429 carries Retry-After")
    return {str(k): v for k, v in got.items()}


def http_tiles(srv, lam) -> dict:
    """Four PNG tiles equal to TilePyramid.fresh rendered; an If-None-Match
    replay answers 304 with no aggregation; an ingest into one leaf
    re-renders that leaf's tiles (ancestors included) and leaves far
    tiles at 304; after the flush the touched leaf equals fresh."""
    from geomesa_tpu_torch.serving import DataClient
    from geomesa_tpu_torch.tiles import render

    c = DataClient(srv.url)
    metrics = srv.metrics
    etags = {}
    t0 = time.perf_counter()
    for kind, z, x, y in HTTP_TILES:
        st, h, body = c.tile("sv", kind, z, x, y)
        check(st == 200 and body[:8] == b"\x89PNG\r\n\x1a\n", f"tile {kind} {z}/{x}/{y} is a PNG")
        check(body == render(kind, srv.tiles.fresh("sv", z, x, y).grid),
              f"tile {kind} {z}/{x}/{y} equals TilePyramid.fresh rendered")
        etags[(kind, z, x, y)] = h["ETag"]
    cold_s = time.perf_counter() - t0
    work = ("geomesa.tiles.compose", "geomesa.tiles.leaf.scan", "geomesa.tiles.fresh")
    before = [metrics.counter_value(n) for n in work]
    nm0 = metrics.counter_value("geomesa.tiles.not_modified")
    for key, etag in etags.items():
        st, _, body = c.tile("sv", *key, etag=etag)
        check(st == 304 and body == b"", f"If-None-Match replay of {key} answers 304")
    check([metrics.counter_value(n) for n in work] == before, "the 304s aggregated nothing")
    check(metrics.counter_value("geomesa.tiles.not_modified") == nm0 + len(etags),
          "each 304 counted")
    lz = srv.tiles.lattice.leaf_zoom
    touched = [(lz - k, 12 >> k, 3 >> k) for k in range(lz + 1)]  # leaf (lz, 12, 3), ancestors
    far = [(lz - k, 0, 0) for k in range(lz + 1)]
    tags = {t: c.tile("sv", "density", *t)[1]["ETag"] for t in touched + far}
    # a 200-row batch inside the touched leaf's box (x 97.5..99, y 7.0..8.4)
    batch = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "id": f"tile-{j}",
         "geometry": {"type": "Point", "coordinates": [97.5 + (j % 20) * 0.07, 7.0 + (j // 20) * 0.14]},
         "properties": {"name": "tile", "dtg": HTTP_T0 + j}} for j in range(200)]}
    check(c.ingest("sv", batch)["acked"] == 200, "the tile batch acked")
    rerendered = 0
    for t in touched:
        st, h, _ = c.tile("sv", "density", *t, etag=tags[t])
        check(st == 200 and h["ETag"] != tags[t], f"touched tile {t} re-rendered")
        rerendered += 1
    for t in far:
        st, _, _ = c.tile("sv", "density", *t, etag=tags[t])
        check(st == 304, f"far tile {t} stays at 304")
    lam.flush()  # the batch folds into the cold store the tiles aggregate
    leaf = srv.tiles.fetch("sv", *touched[0]).grid
    check(float(leaf.sum()) >= 200, "the flushed batch shows in its leaf")
    check(np.array_equal(leaf, srv.tiles.fresh("sv", *touched[0]).grid),
          "the touched leaf equals fresh after the flush")
    return {"tiles": len(HTTP_TILES), "cold_fetch_s": cold_s, "not_modified": len(etags),
            "rerendered": rerendered, "far_304": len(far)}


def http_ops_surfaces(srv) -> dict:
    from geomesa_tpu_torch.serving import DataClient

    c = DataClient(srv.url)
    text = c.metrics_text()
    check("geomesa_serve_requests" in text, "/metrics on the data port")
    health = c.health()
    check(health["http_status"] == 200, "/health on the data port")
    check(bool(c.stats()), "/stats on the data port")
    rep = c.tenants()
    check({"default_weight", "tenants"} <= set(rep), "/tenants on the data port")
    return {"health": health["status"], "tenants": len(rep["tenants"])}


def http_cli(torch, root) -> dict:
    """The CLI's ``serve`` over the saved catalog on the card (its
    default device) and one DataClient query through it."""
    import contextlib
    import io

    from geomesa_tpu_torch import cli
    from geomesa_tpu_torch.io.exporters import _geojson
    from geomesa_tpu_torch.serving import DataClient

    args = cli.build_parser().parse_args(["serve", "-c", root, "--port", "0"])
    check(args.device == "cuda", "the CLI defaults to the card")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        srv = cli.cmd_serve(args, hold=False)
    load_s = time.perf_counter() - t0
    try:
        check(srv.cold.device.type == "cuda", "the CLI's store is on the card")
        check(f"at {srv.url}" in out.getvalue(), "the CLI prints its URL")
        from urllib.parse import quote

        status, _, raw = DataClient(srv.url).request("GET", "/query/sv?cql=" + quote(HTTP_CLI_Q))
        check(status == 200 and raw == _geojson(srv.cold.query("sv", HTTP_CLI_Q)).encode(),
              "a query through the CLI's server equals the in-process export")
    finally:
        srv.store.close()
    return {"load_s": load_s, "rows": len(json.loads(raw)["features"])}


def serve_http_path(torch, device) -> dict:
    """moving-z3-2M-http: the reference's data-plane scenario
    (``config_serve_http``) with its cold store raised from 40k to
    ``N_HTTP`` rows (1M of the cell's 2M): a WAL-backed LambdaStore (``sync=always``) over a saved cold
    store on the card, mounted with ``serve(port=0)`` on loopback. Wire
    equals in-process, the mixed closed loop, a fused burst, fairness
    under an adversarial tenant, ack durability through a crash, then on
    the recovered store (cache tier on, auths ``ops``): tiles and ETags,
    the ops surfaces, one status of each kind; then the CLI's ``serve``.
    Launch and native counts are zeroed before, read after."""
    from urllib.parse import quote

    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch.cache import CacheConfig
    from geomesa_tpu_torch.io.exporters import _geojson
    from geomesa_tpu_torch.metrics import MetricsRegistry
    from geomesa_tpu_torch.serving import DataClient
    from geomesa_tpu_torch.storage import persist
    from geomesa_tpu_torch.streaming import LambdaStore, StreamConfig, WalConfig

    zero_launches()
    t_path = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="geomesa_http_")
    root = os.path.join(tmp, "s")
    rng = np.random.default_rng(SEED + 130)
    sft = FeatureType.from_spec("sv", HTTP_SPEC)
    ds = DataStore(device=device, metrics=MetricsRegistry())
    ds.create_schema(sft)
    t0 = time.perf_counter()
    ds.write("sv", FeatureCollection.from_columns(
        sft, np.arange(N_HTTP).astype(str),
        {"name": np.array(["v"] * N_HTTP), "dtg": HTTP_T0 + rng.integers(0, 86_400_000, N_HTTP),
         "geom": (rng.uniform(-170, 170, N_HTTP), rng.uniform(-80, 80, N_HTTP))}),
        check_ids=False)
    ds.compact("sv")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    persist.save(ds, root)
    save_s = time.perf_counter() - t0
    lam = LambdaStore(ds, "sv", config=StreamConfig(), wal_dir=os.path.join(root, "_wal"),
                      wal_config=WalConfig(sync="always"))
    srv = lam.serve(port=0)
    check(srv.lam is lam and srv.cold.device.type == "cuda", "the data plane serves the card store")
    sections = {}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        sections[name] = now - mark
        mark = now

    warm = DataClient(srv.url, keep_alive=True)
    for q in HTTP_PROBES:
        warm.query("sv", cql=q, limit=256)
    lap("warm_s")
    # wire == in-process, at the default page size and at 1,000 rows
    for q in HTTP_PROBES:
        direct = lam.query(q)
        want = _geojson(direct).encode()
        for page in (None, 1000):
            path = "/query/sv?cql=" + quote(q) + (f"&page_rows={page}" if page else "")
            status, hdrs, raw = warm.request("GET", path)
            check(status == 200 and raw == want, f"wire equals in-process: {q} page {page}")
            check(hdrs["X-Geomesa-Rows"] == str(len(direct)), f"rows header: {q}")
    warm.close()
    lap("wire_s")
    mixed = http_mixed(srv, HTTP_READ_S)
    lap("mixed_s")
    burst = http_burst(srv)
    for (r, i), (q, ids) in list(burst.pop("answers").items())[:4]:
        check(ids == [str(v) for v in lam.query(q).ids.tolist()[:256]],
              f"burst answer in order: {q}")
    lap("burst_s")
    fair = http_fairness(srv, HTTP_FAIR_S)
    lap("fairness_s")
    # ack durability: every HTTP-acked row survives wal.crash() + recover
    dur = DataClient(srv.url, keep_alive=True)
    acked = []
    for b in range(10):
        feats = http_rows("dur", b, 100, HTTP_T0)
        ack = dur.ingest("sv", feats)
        if ack["acked"] == 100 and ack["durable"]:
            acked.extend(f["id"] for f in feats["features"])
    dur.close()
    posted_m = mixed["ingested_rows"]
    lap("acks_s")
    srv.close()
    lam.wal.crash()
    lam.flusher.close()
    lam.cold.close()
    del lam, ds
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = LambdaStore.recover(root, device=device, metrics=MetricsRegistry(),
                              cache=CacheConfig(max_bytes=256 << 20), auths=("ops",))
    recover_s = time.perf_counter() - t0
    check(rec.cold.device.type == "cuda", "recover loads the cold store onto the card")
    got = {str(i) for i in rec.query("INCLUDE").ids.tolist()}
    lost = sum(1 for fid in acked if fid not in got)
    invented = sum(1 for fid in got if not fid.isdigit() and not fid.startswith(("m", "dur")))
    cold_ids = sum(1 for fid in got if fid.isdigit())
    check(len(acked) == 1000 and lost == 0, "no acked row lost")
    check(invented == 0 and cold_ids == N_HTTP, "no row invented, every cold row back")
    check(len(got) == N_HTTP + len(acked) + posted_m, "every mixed-loop ack is back")
    lap("recover_and_check_s")
    srv = rec.serve(port=0)
    tiles = http_tiles(srv, rec)
    lap("tiles_s")
    ops = http_ops_surfaces(srv)
    statuses = http_statuses(srv)
    srv.close()
    rec.close()
    rec.cold.close()
    lap("ops_and_statuses_s")
    cli = http_cli(torch, root)
    lap("cli_s")
    del rec
    torch.cuda.empty_cache()
    left = []
    for _ in range(100):
        left = serve_threads()
        if not left:
            break
        time.sleep(0.05)
    check(left == [], f"close() leaves no serve, serving or ops thread: {left}")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    path_s = time.perf_counter() - t_path
    return {
        "phase": "serve_http_path", "cell": "moving-z3-2M-http",
        "launches": read_launches(), "native": read_native(), "n_points": N_HTTP,
        "ingest_s": ingest_s, "save_s": save_s, "recover_s": recover_s,
        "identical": True, "mixed": mixed, "burst": burst, "fairness": fair,
        "durability": {"acked_rows": len(acked), "acked_loss": lost, "invented": invented},
        "tiles": tiles, "ops": ops, "statuses": statuses, "cli": cli,
        "sections_s": sections, "path_s": path_s, "budget_s": HTTP_BUDGET_S,
        "reduced": {"cold_rows": {"cell": 2_000_000, "run": N_HTTP},
                    "fairness_s": {"cell": 6.0, "run": HTTP_FAIR_S}},
    }


N_S2 = 10_000_000
N_S2_S3_QUERIES = 64
N_S2_S2_QUERIES = 32
N_S2_CHECK = 8
N_S2_AGG = 4
S2_BUDGET_S = 60.0


def s2_check_aggregations(torch, ds, index, queries) -> int:
    """density / bounds(estimate=True) through the store against the plain
    versions over the same S3 or S2 device table and candidate blocks."""
    from geomesa_tpu_torch.scan import aggregations as agg

    table = ds.table("gdelt", index)
    n = 0
    for q, (x0, y0, x1, y1, *_) in queries:
        env = (x0, y0, x1, y1)
        grid = ds.density("gdelt", q, envelope=env, width=256, height=256)
        env_stats = ds.bounds("gdelt", q, estimate=True)
        plan = ds.planner.plan("gdelt", q)
        check(plan.index == index, f"{index} plans {q}")
        cols3, bids, n_real, boxes, wins, kw = table.agg_launch_args(plan.config)
        cols = dict(zip(kw["col_names"], cols3))
        dv = table.device
        targs = (cols, torch.from_numpy(bids).to(dv), torch.from_numpy(boxes).to(dv),
                 torch.from_numpy(wins).to(dv))
        flags = dict(has_boxes=kw["has_boxes"], has_windows=kw["has_windows"])
        ref = agg.density_plain(*targs, torch.tensor(env, dtype=torch.float32, device=dv),
                                width=256, height=256, **flags).cpu().numpy()
        check(np.array_equal(grid, ref), f"{index} density vs plain: {q}")
        st = agg.bounds_plain(*targs, **flags).cpu().numpy()
        check(env_stats == agg.reduce_bounds(st, n_real)[1], f"{index} bounds vs plain: {q}")
        check(float(grid.sum()) > 0 and env_stats is not None, f"{index} aggregations see hits: {q}")
        n += 1
    return n


def s2_path(torch, device) -> dict:
    """gdelt-s2-10M: 10M GDELT-shaped points on a schema with
    ``geomesa.indices.enabled=s3,s2`` (cell ids for both indexes at
    ingest), 64 BBOX + DURING queries (planned on s3) and 32 BBOX queries
    (planned on s2): ids against an f64 brute force on 8 of each (and
    their ``limit`` pages as prefixes of the full order), density and
    bounds against the plain versions on 4 of each, the planner's choice
    in the explain. Launch and native counts are zeroed before, read
    after."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType

    zero_launches()
    t_path = time.perf_counter()
    rng = np.random.default_rng(SEED + 140)
    x, y = gdelt_points(N_S2, rng)
    t = T0_MS + rng.integers(0, SPAN_MS, N_S2)
    sft = FeatureType.from_spec("gdelt", "dtg:Date,*geom:Point:srid=4326")
    sft.user_data["geomesa.indices.enabled"] = "s3,s2"
    ds = DataStore(device=device)
    ds.create_schema(sft)
    check([i.name for i in ds.indexes("gdelt")] == ["s3", "s2"], "the schema enables s3 and s2")
    t0 = time.perf_counter()
    ds.write("gdelt", FeatureCollection.from_columns(sft, np.arange(N_S2),
                                                    {"dtg": t, "geom": (x, y)}), check_ids=False)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    for idx in ("s3", "s2"):
        zs = ds.table("gdelt", idx).zs
        check(zs.dtype == np.uint64 and bool(((zs >> np.uint64(63)) == 1).any()),
              f"{idx} keys stay unsigned with bit 63 set on faces 4 and 5")
    src = (x, y, t)
    s3q = query_set(SEED + 141, N_S2_S3_QUERIES)
    r = np.random.default_rng(SEED + 142)
    s2q = []
    for (x0, y0, x1, y1) in box_queries(r, N_S2_S2_QUERIES):
        box = tuple(float(f"{v:.4f}") for v in (x0, y0, x1, y1))
        s2q.append((f"bbox(geom, {box[0]:.4f}, {box[1]:.4f}, {box[2]:.4f}, {box[3]:.4f})",
                    (*box, np.iinfo(np.int64).min, np.iinfo(np.int64).max)))
    out = {"ingest_s": ingest_s, "ingest_rows_per_s": N_S2 / ingest_s}
    for name, queries, index in (("s3", s3q, "s3"), ("s2", s2q, "s2")):
        for q, _ in queries[:2]:
            ds.query("gdelt", q)  # first plans and launches off the clock
        check(f"Strategy: {index}" in ds.explain("gdelt", queries[0][0]),
              f"the planner's explain names {index}")
        t_plan = time.perf_counter()
        for q, _ in queries:
            check(ds.planner.plan("gdelt", q).index == index, f"{index} plans {q}")
        plan_ms = (time.perf_counter() - t_plan) / len(queries) * 1e3
        lat, outs, wall = run_queries(ds, queries)
        for (q, box), res in list(zip(queries, outs))[:N_S2_CHECK]:
            ids = np.asarray(res.ids, np.int64)
            check(np.array_equal(np.sort(ids), brute_ids(src, box)),
                  f"{index} ids vs brute force: {q}")
            for lim in (1, 10, 100):
                page = np.asarray(ds.query("gdelt", q, limit=lim).ids, np.int64)
                check(np.array_equal(page, ids[:lim]), f"{index} limit {lim} is the prefix: {q}")
        n_agg = s2_check_aggregations(torch, ds, index, busiest(queries, outs, N_S2_AGG))
        hits = sum(len(o) for o in outs)
        out[name] = {
            "n_queries": len(queries), "hits_total": hits,
            "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
            "latency_p84_ms": float(np.percentile(lat, 84) * 1e3),
            "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
            "plan_ms_per_query": plan_ms, "features_per_s": hits / wall,
            "ranges_median": float(np.median(
                [ds.planner.plan("gdelt", q).config.n_ranges for q, _ in queries[:8]])),
            "checked_vs_brute_force": N_S2_CHECK, "checked_aggregations": n_agg,
        }
    device_gb = sum(ds.table("gdelt", i).nbytes_device for i in ("s3", "s2")) / 1e9
    ds.close()
    del ds, src, x, y, t
    torch.cuda.empty_cache()
    return {
        "phase": "s2_path", "cell": "gdelt-s2-10M", "launches": read_launches(),
        "native": read_native(), "n_points": N_S2, "indexes": ["s3", "s2"],
        "device_gb": device_gb, **out, "path_s": time.perf_counter() - t_path,
        "budget_s": S2_BUDGET_S, "reduced": {},
    }


N_DRIFT = 1_000_000  # config_drift's defaults: points, queries, passes
N_DRIFT_QUERIES = 12
DRIFT_REPS = 6
N_DRIFT_SMALL = 50_000  # its disarmed bit-identity stores
N_LINK = 8_000_000  # the link seam's store: past 256 blocks, so the slot cap shows
N_LINK_QUERIES = 64
DRIFT_BOUNDS = {"frozen_degradation_min": 1.30, "tuned_over_oracle_max": 1.5,
                "decisions_min": 1}  # scripts/bench_gate.py's config_drift rows
DRIFT_BUDGET_S = 60.0


def drift_star(cx, cy, r_out, r_in, points=60):
    th = np.linspace(0.0, 2.0 * np.pi, 2 * points, endpoint=False)
    rr = np.where(np.arange(2 * points) % 2 == 0, r_out, r_in)
    xs, ys = cx + rr * np.cos(th), cy + rr * np.sin(th)
    coords = ", ".join(f"{a:.4f} {b:.4f}" for a, b in zip(xs, ys))
    return f"POLYGON(({coords}, {xs[0]:.4f} {ys[0]:.4f}))"


def drift_queries():
    arng = np.random.default_rng(SEED + 91)
    qa = [f"INTERSECTS(geom, {drift_star(float(arng.uniform(-130.0, -50.0)), float(arng.uniform(-35.0, 35.0)), 40.0, 18.0)})"
          for _ in range(N_DRIFT_QUERIES)]
    brng = np.random.default_rng(SEED + 92)
    qb = []
    for _ in range(N_DRIFT_QUERIES):
        x0, y0 = float(brng.uniform(5.0, 173.0)), float(brng.uniform(-85.0, 84.0))
        qb.append(f"bbox(geom, {x0:.4f}, {y0:.4f}, {x0 + 1.5:.4f}, {y0 + 1.0:.4f})")
    return qa, qb


def drift_store(torch, device, x, y, n, min_cost=None, tuned=False, interval=None, **kw):
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType, conf
    from geomesa_tpu_torch.metrics import MetricsRegistry

    if min_cost is not None:
        conf.CACHE_MIN_COST.set(float(min_cost))
    sft = FeatureType.from_spec("dash", "*geom:Point:srid=4326")
    sft.user_data["geomesa.indices.enabled"] = "z2"
    ds = DataStore(device=device, metrics=MetricsRegistry(), **kw)
    ds.create_schema(sft)
    ds.write("dash", FeatureCollection.from_columns(sft, np.arange(n), {"geom": (x[:n], y[:n])}),
             check_ids=False)
    mgr = ds.attach_tuning(enabled=True, interval=interval) if tuned else None
    return ds, mgr


def drift_section(torch, device, x, y) -> dict:
    """config_drift: frozen, oracle and self-tuned stores over one
    dashboard workload whose hotspot moves from concave-star polygons to
    cheap boxes; the frozen pin is calibrated between the two hotspots'
    measured scan costs on this card."""
    from geomesa_tpu_torch import conf
    from geomesa_tpu_torch.planning.hints import QueryHints

    qa, qb = drift_queries()
    bypass = QueryHints(cache="bypass")
    probe, _ = drift_store(torch, device, x, y, N_DRIFT, cache=True)
    for q in qa + qb:
        probe.query("dash", q, hints=bypass)

    def cost(queries):
        out = []
        for q in queries:
            s = time.perf_counter()
            probe.query("dash", q, hints=bypass)
            out.append(time.perf_counter() - s)
        return float(np.median(out))

    t_hi, t_lo = cost(qa), cost(qb)
    thr = float(np.sqrt(max(t_lo, 1e-6) * max(t_hi, 1e-6)))
    if 1.25 * t_lo <= 0.8 * t_hi:
        thr = max(1.25 * t_lo, min(thr, 0.8 * t_hi))
    thr = min(thr, 0.05)
    probe.close()
    del probe

    def qps(ds, queries, passes):
        t0 = time.perf_counter()
        for _ in range(passes):
            for q in queries:
                ds.query("dash", q)
        return passes * len(queries) / (time.perf_counter() - t0)

    results, decisions = {}, []
    for name, pin, tuned in (("frozen", thr, False), ("oracle", 0.0, False), ("tuned", thr, True)):
        try:
            ds, mgr = drift_store(torch, device, x, y, N_DRIFT, min_cost=pin, tuned=tuned,
                                  interval=max(1, N_DRIFT_QUERIES // 2), cache=True)
            for q in qa + qb:
                ds.query("dash", q, hints=bypass)
            for _ in range(2):
                for q in qa:
                    ds.query("dash", q)
            pre = qps(ds, qa, DRIFT_REPS)
            for _ in range(6):
                for q in qb:
                    ds.query("dash", q)
            post = qps(ds, qb, DRIFT_REPS)
            results[name] = {"pin_ms": pin * 1e3, "qps_pre": pre, "qps_post": post}
            if mgr is not None:
                rep = mgr.report()
                decisions = [d for d in rep["decisions"] if d.get("controller") == "cache_min_cost"]
                results[name]["final_pin_ms"] = ds.cache.result.conf.min_cost_s * 1e3
                results[name]["pulses"] = rep["pulses"]
            ds.close()
        finally:
            conf.CACHE_MIN_COST.clear()
        del ds
        torch.cuda.empty_cache()
    frozen = results["frozen"]["qps_pre"] / max(results["frozen"]["qps_post"], 1e-9)
    tuned_over_oracle = results["oracle"]["qps_post"] / max(results["tuned"]["qps_post"], 1e-9)
    return {"pin_ms": thr * 1e3, "hotspot_scan_ms": {"pre": t_hi * 1e3, "post": t_lo * 1e3},
            **results, "frozen_degradation": frozen, "tuned_over_oracle": tuned_over_oracle,
            "decisions_recorded": len(decisions), "decisions": decisions[:8],
            "bounds_printed_not_enforced": DRIFT_BOUNDS}


def drift_disarmed(torch, device, x, y) -> dict:
    """Two 50k stores, one with a disarmed tier: ids and explains (less
    timings) identical on config_drift's queries."""
    from geomesa_tpu_torch.planning.explain import Explainer

    qa, qb = drift_queries()
    plain, _ = drift_store(torch, device, x, y, N_DRIFT_SMALL, cache=True)
    disarmed, _ = drift_store(torch, device, x, y, N_DRIFT_SMALL, cache=True)
    mgr = disarmed.attach_tuning(enabled=False)
    check(not mgr.enabled and disarmed.planner.reweighter is None, "the tier is disarmed")
    n = 0
    for q in qa + qb:
        e1, e2 = Explainer(), Explainer()
        r1 = plain.query("dash", q, explain=e1)
        r2 = disarmed.query("dash", q, explain=e2)
        check(np.array_equal(np.asarray(r1.ids), np.asarray(r2.ids)), f"disarmed ids: {q[:40]}")
        check([ln for ln in e1.lines if "ms" not in ln] == [ln for ln in e2.lines if "ms" not in ln],
              f"disarmed explain: {q[:40]}")
        n += 1
    check(mgr.report()["pulses"] == 0, "a disarmed tier never pulses")
    plain.close()
    disarmed.close()
    return {"identical": True, "queries": n}


def link_rtt_ms(torch, device, reps=15) -> float:
    """The pull floor the reference's link probe measures: a small
    device-to-host copy after warm-up, the median of ``reps``."""
    small = torch.ones((8, 128), dtype=torch.float32, device=device)
    small.cpu()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        small.cpu()
        out.append(time.perf_counter() - t0)
    return float(np.median(out) * 1e3)


@contextmanager
def fused_m_recorder():
    """The M (padded slots) of every fused chunk the tables launch."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    shapes: list = []
    launch = bk.scan_planes_multi

    def recording(cols3, bids, *args, **kw):
        shapes.append(len(bids))
        return launch(cols3, bids, *args, **kw)

    bk.scan_planes_multi = recording
    try:
        yield shapes
    finally:
        bk.scan_planes_multi = launch


def link_section(torch, device) -> dict:
    """The link seam: the card's pull RTT derives the fused slot cap and
    the M floor; installed on a fresh store, K2's chunks take the derived
    slot count and ``query_many`` ids equal the untuned store's."""
    from geomesa_tpu_torch.scan import block_kernels as bk

    rng = np.random.default_rng(SEED + 151)
    x, y = gdelt_points(N_LINK, rng)
    queries = [f"bbox(geom, {a:.4f}, {b:.4f}, {a + w:.4f}, {b + w / 2:.4f})"
               for (a, b, *_), w in zip(box_queries(rng, N_LINK_QUERIES),
                                        rng.choice([5.0, 10.0, 20.0], N_LINK_QUERIES))]
    rtt = link_rtt_ms(torch, device)
    derived = bk.derive_link_constants(rtt)
    ds, _ = drift_store(torch, device, x, y, N_LINK)
    table = ds.table("dash", "z2")
    untuned_slots = table.fused_slots
    with fused_m_recorder() as m_untuned:
        ref = [np.asarray(fc.ids).tolist() for fc in ds.query_many("dash", queries)]
    try:
        bk.set_link_constants(derived)
        tuned_slots = table.fused_slots
        want = min(derived["fused_chunk_slots"], bk.bucket_of(table.n_blocks))
        check(tuned_slots == want, "the table's fused slots follow the link constants")
        with fused_m_recorder() as m_tuned:
            got = [np.asarray(fc.ids).tolist() for fc in ds.query_many("dash", queries)]
        check(got == ref, "query_many ids under the link constants equal the untuned store's")
        check(len(m_tuned) > 0 and set(m_tuned) == {tuned_slots},
              "every K2 chunk takes the derived slot count")
        check(bk.m_bucket_of(1) == derived["m_floor"], "the single-query M floor follows the link")
    finally:
        bk.set_link_constants(None)
    check(table.fused_slots == untuned_slots, "the link constants reset")
    ds.close()
    del ds
    torch.cuda.empty_cache()
    return {"link_rtt_ms": rtt, "derived": derived, "n_points": N_LINK,
            "n_blocks": table.n_blocks, "slots_untuned": untuned_slots,
            "slots_tuned": tuned_slots, "chunks_untuned": len(m_untuned),
            "chunks_tuned": len(m_tuned)}


def burn_section(torch, device, x, y) -> dict:
    """An armed tier behind ``serve()`` under a 1 us query objective: the
    burn gate sheds the low-weight tenant first (``geomesa.tuning.shed``),
    top-weight work admits, and the gate releases once the window empties."""
    from geomesa_tpu_torch.obs.slo import SloObjective, SloTracker
    from geomesa_tpu_torch.serving import ServingRejected, TenantRegistry

    ds, _ = drift_store(torch, device, x, y, N_DRIFT)
    ds.attach_slo(SloTracker([SloObjective("query_p99", "geomesa.query.scan", 0.99, 1e-6)],
                             window_s=1.0))
    sched = ds.serve()
    sched.tenants = TenantRegistry(metrics=ds.metrics)
    sched.tenants.configure("gold", weight=8.0)
    sched.tenants.configure("bronze", weight=1.0)
    mgr = ds.attach_tuning(enabled=True, interval=1_000_000)
    check(sched.burn_gate is mgr.burnshed, "the burn gate is wired onto the scheduler")
    _, qb = drift_queries()
    for q in qb:
        sched.submit("dash", q, tenant="gold").result(60)
    # the gate re-reads the burn at most every refresh_s (the submits
    # above read it before any query was observed)
    time.sleep(2 * mgr.burnshed.refresh_s)
    mgr.pulse()
    check(mgr.burnshed.report()["engaged"], "the 1 us objective burns: the gate engages")
    shed = 0
    try:
        sched.submit("dash", qb[0], tenant="bronze").result(60)
    except ServingRejected as e:
        shed += "slo burn" in str(e)
    check(shed == 1 and ds.metrics.counter_value("geomesa.tuning.shed") == 1,
          "the low-weight tenant sheds first")
    check(len(sched.submit("dash", qb[1], tenant="gold").result(60)) >= 0,
          "top-weight work admits through the burn")
    time.sleep(1.6)  # the window slides empty
    mgr.pulse()
    check(not mgr.burnshed.report()["engaged"], "the gate releases")
    sched.submit("dash", qb[2], tenant="bronze").result(60)
    check(ds.metrics.counter_value("geomesa.tuning.shed") == 1, "bronze admits after release")
    rep = mgr.burnshed.report()
    ds.close()
    del ds
    return {"shed": 1, "released": True, "burn_after": rep["burn"]}


def tuning_cli_section(torch, device, x, y) -> dict:
    """``close()`` writes ``_tuning.json`` beside the catalog; the CLI's
    ``tune`` and ``ops`` read the catalog on the card."""
    import contextlib
    import io

    from geomesa_tpu_torch import cli, conf
    from geomesa_tpu_torch.storage import persist

    tmp = tempfile.mkdtemp(prefix="geomesa_tune_")
    cat = os.path.join(tmp, "cat")
    try:
        ds, _ = drift_store(torch, device, x, y, N_DRIFT, cache=True, min_cost=0.04)
        persist.save(ds, cat)
        mgr = ds.attach_tuning(enabled=True, interval=1,
                               state_path=os.path.join(cat, "_tuning.json"))
        for hits in (100, 100, 10):  # seeded readings: the hits collapse
            ds.metrics.counter("geomesa.cache.hit", hits)
            mgr.pulse()
        decided = [d for d in mgr.report()["decisions"] if d["controller"] == "cache_min_cost"]
        check(len(decided) == 1, "the seeded readings move cache_min_cost once")
        ds.close()
    finally:
        conf.CACHE_MIN_COST.clear()
    state = json.load(open(os.path.join(cat, "_tuning.json")))
    check(state["decisions"] == decided, "close() writes the decisions to _tuning.json")
    outs = {}
    for argv in (["tune", "-c", cat], ["tune", "-c", cat, "--json"], ["ops", "-c", cat]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli.main(argv) == 0, f"the CLI's {' '.join(argv[:1])} runs on the card")
        outs[" ".join(a for a in argv if a != cat)] = buf.getvalue()
    check("cache_min_cost geomesa.cache.min.cost: 0.04 -> 0.027" in outs["tune -c"],
          "tune reports the saved decision")
    check(json.loads(outs["tune -c --json"])["decisions"] == decided, "tune --json too")
    check(outs["ops -c"].startswith("status: "), "ops reports the catalog")
    conf.CACHE_MIN_COST.clear()
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {"decisions": len(decided), "tune_lines": len(outs["tune -c"].splitlines()),
            "ops_status": outs["ops -c"].splitlines()[0]}


def drift_path(torch, device) -> dict:
    """gdelt-z2-1M-drift: the reference's ``config_drift`` at its defaults
    (1M points on z2, 12 queries, 6 passes) on the card, the disarmed
    bit-identity on two 50k stores, the link seam on an 8M-row store, the
    burn gate behind ``serve()``, and the state file through the CLI.
    Launch and native counts are zeroed before, read after."""
    zero_launches()
    t_path = time.perf_counter()
    rng = np.random.default_rng(SEED + 90)
    x, y = rng.uniform(-180.0, 180.0, N_DRIFT), rng.uniform(-90.0, 90.0, N_DRIFT)
    sections = {}
    for name, fn in (("drift", lambda: drift_section(torch, device, x, y)),
                     ("disarmed", lambda: drift_disarmed(torch, device, x, y)),
                     ("link", lambda: link_section(torch, device)),
                     ("burn", lambda: burn_section(torch, device, x, y)),
                     ("cli", lambda: tuning_cli_section(torch, device, x, y))):
        t0 = time.perf_counter()
        sections[name] = fn()
        sections[name]["section_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return {
        "phase": "drift_path", "cell": "gdelt-z2-1M-drift", "launches": read_launches(),
        "native": read_native(), "n_points": N_DRIFT, **sections,
        "path_s": time.perf_counter() - t_path, "budget_s": DRIFT_BUDGET_S, "reduced": {},
    }


# -- the multi-device tier: the shard mesh, the pod table, the pod store -----

# config_pod's scan rows, raised from its 150,000 (10M until the scripts
# path, 5M until the examples path)
N_POD = 2_000_000
N_POD_INGEST = 1_000_000  # its host-local ingest rows, raised from its 400,000 (2M until the examples path)
POD_HOSTS = 4
POD_SHARDS = 2  # per host: 4 x 2 shards, the flat mesh's 8, all on the one card
POD_SPEC = "dtg:Date,*geom:Point:srid=4326"  # config_pod's spec
POD_SPAN_MS = 20 * 86_400_000  # and its 20-day span
N_POD_PROBES = 12  # its probes: 4 x 3 degree boxes
N_POD_BRUTE = 4
N_POD_AGG = 4
POD_READ_S = 3.0  # its closed loop
N_POD_STREAM = 200_000
POD_STREAM_BATCH = 20_000
POD_KILL_AFTER = 5  # batches written before host POD_KILLED is killed
POD_KILLED = 1
N_POD_FENCES = 1_000
POD_BUDGET_S = 60.0


def pod_probes(seed) -> list:
    """config_pod's 12 selective probes: 4 x 3 degree boxes with lower
    corners in [-55, 40) x [-40, 30), printed to 3 decimals."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_POD_PROBES):
        x0, y0 = rng.uniform(-55, 40), rng.uniform(-40, 30)
        box = tuple(float(f"{v:.3f}") for v in (x0, y0, x0 + 4, y0 + 3))
        out.append((f"bbox(geom, {box[0]:.3f}, {box[1]:.3f}, {box[2]:.3f}, {box[3]:.3f})", box))
    return out


def brute_box_ids(x, y, box) -> np.ndarray:
    x0, y0, x1, y1 = box
    return np.flatnonzero((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1))


@contextmanager
def shard_recorder():
    """Record every shard table's scan launch: (shard table, shards with
    candidate blocks) per ``DistributedIndexTable._device_scan_submit``."""
    from geomesa_tpu_torch.parallel import DistributedIndexTable

    calls: list = []
    orig = DistributedIndexTable._device_scan_submit

    def recording(self, blocks, *a, **kw):
        calls.append((self, int(np.count_nonzero(self._split_blocks(blocks)[1]))))
        return orig(self, blocks, *a, **kw)

    DistributedIndexTable._device_scan_submit = recording
    try:
        yield calls
    finally:
        DistributedIndexTable._device_scan_submit = orig


def closed_loop(ds, probes, seconds) -> float:
    """Queries per second of one client sending the probes in turn."""
    k = 0
    t0 = time.perf_counter()
    while True:
        ds.query("gdelt", probes[k % len(probes)][0])
        k += 1
        dt = time.perf_counter() - t0
        if dt >= seconds:
            return k / dt


def pod_scan_section(torch, device) -> dict:
    """Three stores over the same 10M rows (each ``write`` + ``compact``):
    the pod (4 sim hosts x 2 shards of the card), the flat 8-shard mesh
    over the same devices and a one-device store; the probes, a fused
    batch, grids, bounds and count estimates, equal across the three and
    to an f64 brute force; the pod's selective probes launch only on the
    hosts that own their blocks; the closed loops."""
    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch.kernels import BLOCK_SCAN
    from geomesa_tpu_torch.pod import PodIndexTable, make_host_group

    rng = np.random.default_rng(SEED + 160)
    x, y = gdelt_points(N_POD, rng)
    t = T0_MS + rng.integers(0, POD_SPAN_MS, N_POD)
    group = make_host_group(hosts=POD_HOSTS, devices_per_host=POD_SHARDS, driver="sim",
                            devices=[device] * (POD_HOSTS * POD_SHARDS))
    stores, build_s = {}, {}
    for name, mesh in (("pod", group), ("flat", group.flat_mesh()), ("one", None)):
        sft = FeatureType.from_spec("gdelt", POD_SPEC)
        ds = DataStore(device=device, mesh=mesh)
        ds.create_schema(sft)
        t0 = time.perf_counter()
        ds.write("gdelt", FeatureCollection.from_columns(sft, np.arange(N_POD),
                                                        {"dtg": t, "geom": (x, y)}),
                 check_ids=False)
        ds.compact("gdelt")
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        stores[name] = ds
    pod = stores["pod"]
    check(all(isinstance(pod._tables[("gdelt", i.name)], PodIndexTable)
              for i in pod.indexes("gdelt")), "the pod store's tables are pod tables")
    probes = pod_probes(SEED + 161)
    for ds in stores.values():
        for q, _ in probes[:2]:
            ds.query("gdelt", q)  # first plans and launches off the clock
    outs = {name: [np.asarray(ds.query("gdelt", q).ids, np.int64) for q, _ in probes]
            for name, ds in stores.items()}
    hits = []
    for i, (q, box) in enumerate(probes):
        got = outs["pod"][i]
        check(np.array_equal(got, outs["flat"][i]) and np.array_equal(got, outs["one"][i]),
              f"pod, flat mesh and one-device ids equal in order: {q}")
        if i < N_POD_BRUTE:
            check(np.array_equal(np.sort(got), brute_box_ids(x, y, box)),
                  f"pod ids vs brute force: {q}")
        hits.append(len(got))
    batch = [q for q, _ in probes] * 2
    many = {name: [np.asarray(r.ids, np.int64) for r in ds.query_many("gdelt", batch)]
            for name, ds in stores.items()}
    for name, res in many.items():
        check(all(np.array_equal(a, outs["pod"][i % N_POD_PROBES]) for i, a in enumerate(res)),
              f"query_many on the {name} store equals the probes' ids")
    for q, box in sorted(probes, key=lambda p: -len(brute_box_ids(x, y, p[1])))[:N_POD_AGG]:
        grids = [ds.density("gdelt", q, envelope=box, width=64, height=64)
                 for ds in stores.values()]
        check(all(np.array_equal(g, grids[2]) for g in grids) and grids[2].sum() > 0,
              f"pod, flat and one-device grids equal: {q}")
        bounds = [ds.bounds("gdelt", q, estimate=True) for ds in stores.values()]
        check(bounds[0] == bounds[1] == bounds[2] and bounds[2] is not None,
              f"pod, flat and one-device bounds equal: {q}")
        est = [ds.stats_query("gdelt", "Count()", q, estimate=True)[0].count
               for ds in stores.values()]
        check(est[0] == est[1] == est[2] > 0, f"pod, flat and one-device count estimates: {q}")
    # non-owning hosts launch nothing
    owners_per_probe = []
    for q, _ in probes:
        plan = pod.planner.plan("gdelt", q)
        table = pod._tables[("gdelt", plan.index)]
        host_of = {id(sh): h for h, sh in enumerate(table.shards)}
        blocks = table.candidate_blocks(table.candidate_spans_split(plan.config)[0])
        owners = {h for h, _ in table._host_blocks(blocks)}
        before = BLOCK_SCAN.launches
        with shard_recorder() as calls:
            pod.query("gdelt", q)
        launched = {host_of[id(sh)] for sh, _ in calls}
        check(launched <= owners, f"only owning hosts launch: {q} ({launched} vs {owners})")
        check(BLOCK_SCAN.launches - before == sum(n for _, n in calls),
              f"K1 launches once per shard with candidates: {q}")
        owners_per_probe.append(len(owners))
    check(min(owners_per_probe) < POD_HOSTS, "a selective probe leaves hosts out")
    qps = {name: closed_loop(ds, probes, POD_READ_S) for name, ds in stores.items()}
    device_gb = {name: sum(ds.table("gdelt", i.name).nbytes_device
                           for i in ds.indexes("gdelt")) / 1e9 for name, ds in stores.items()}
    for ds in stores.values():
        ds.close()
    del stores, x, y, t
    return {
        "n_points": N_POD, "hosts": POD_HOSTS, "shards_per_host": POD_SHARDS,
        "build_s": build_s, "device_gb": device_gb, "probe_hits": hits,
        "checked_vs_brute_force": N_POD_BRUTE, "checked_aggregations": N_POD_AGG,
        "owning_hosts_per_probe": owners_per_probe,
        "qps": qps, "pod_over_flat": qps["pod"] / qps["flat"], "read_s": POD_READ_S,
    }


def pod_ingest_section(torch, device) -> dict:
    """config_pod's host-local ingest: 2M rows partitioned by the crc32
    owner of their ids, each host's BulkLoader leg timed alone (a host is
    its own machine in a deployment), against one load on the flat
    mesh; the union of the host stores answers as the flat store does."""
    import zlib

    from geomesa_tpu_torch import DataStore, FeatureCollection, FeatureType
    from geomesa_tpu_torch.ingest.pipeline import BulkLoader
    from geomesa_tpu_torch.pod import make_host_group

    group = make_host_group(hosts=POD_HOSTS, devices_per_host=POD_SHARDS, driver="sim",
                            devices=[device] * (POD_HOSTS * POD_SHARDS))
    rng = np.random.default_rng(SEED + 162)
    x, y = gdelt_points(N_POD_INGEST, rng)
    t = T0_MS + rng.integers(0, POD_SPAN_MS, N_POD_INGEST)
    ids = np.arange(N_POD_INGEST).astype(str)
    fc = FeatureCollection.from_columns(FeatureType.from_spec("gdelt", POD_SPEC), ids,
                                        {"dtg": t, "geom": (x, y)})
    owners = np.fromiter((zlib.crc32(i.encode()) % POD_HOSTS for i in ids.tolist()),
                         np.int64, count=N_POD_INGEST)

    def load(mesh, part):
        ds = DataStore(device=device, mesh=mesh)
        ds.create_schema(FeatureType.from_spec("gdelt", POD_SPEC))
        t0 = time.perf_counter()
        loader = BulkLoader(ds, "gdelt")
        loader.put(part)
        loader.close()
        torch.cuda.synchronize()
        return ds, time.perf_counter() - t0

    flat, flat_s = load(group.flat_mesh(), fc)
    hosts, host_s = [], []
    for h in range(POD_HOSTS):
        ds, s = load(group.mesh(h), fc.take(np.flatnonzero(owners == h)))
        hosts.append(ds)
        host_s.append(s)
    q = "bbox(geom, -20, -15, 10, 12)"
    union = np.sort(np.concatenate([np.asarray(ds.query("gdelt", q).ids).astype(str)
                                    for ds in hosts]))
    flat_ids = np.sort(np.asarray(flat.query("gdelt", q).ids).astype(str))
    check(np.array_equal(union, flat_ids) and len(flat_ids) > 0,
          "the host stores' union answers as the flat store")
    check(sum(ds.row_count("gdelt") for ds in hosts) == flat.row_count("gdelt") == N_POD_INGEST,
          "the host stores partition the rows")
    for ds in (flat, *hosts):
        ds.close()
    return {"n_rows": N_POD_INGEST, "flat_s": flat_s, "host_s": host_s,
            "pod_model_s": max(host_s), "host_parallel_speedup": flat_s / max(host_s),
            "host_rows": np.bincount(owners, minlength=POD_HOSTS).tolist()}


def pod_fences(x, y, seed) -> list:
    """N_POD_FENCES squares of 0.25-1 degree, each centred on an event
    drawn from (x, y): city-scale geofences where the events are."""
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.choice(len(x), N_POD_FENCES, replace=False):
        h = float(rng.uniform(0.125, 0.5))
        x0, y0 = float(np.clip(x[i], -179, 179)) - h, float(np.clip(y[i], -89, 89)) - h
        out.append([(x0, y0), (x0 + 2 * h, y0), (x0 + 2 * h, y0 + 2 * h), (x0, y0 + 2 * h),
                    (x0, y0)])
    return out


def pod_store_section(torch, device, tmp) -> dict:
    """A PodStore with per-host WALs on the pod's shard meshes: 200k rows
    in 20k batches with 1,000 geofences subscribed, host 1 killed after
    the fifth batch and rejoined from its WAL; its rows equal a
    never-crashed pod's and the brute force's, and the union of the
    hosts' alerts equals one LambdaStore's over the same events."""
    from geomesa_tpu_torch import DataStore, FeatureType, geometry
    from geomesa_tpu_torch.pod import PodStore, make_host_group
    from geomesa_tpu_torch.streaming import LambdaStore
    from geomesa_tpu_torch.streaming.standing import Subscription
    from geomesa_tpu_torch.streaming.wal import WalConfig

    group = make_host_group(hosts=POD_HOSTS, devices_per_host=POD_SHARDS, driver="sim",
                            devices=[device] * (POD_HOSTS * POD_SHARDS))
    sft = FeatureType.from_spec("gdelt", POD_SPEC)
    pod = PodStore(sft, group, root=os.path.join(tmp, "pod"), wal_config=WalConfig(sync="always"))
    ref = PodStore(sft, group)
    one_cold = DataStore(device=device)
    one_cold.create_schema(FeatureType.from_spec("gdelt", POD_SPEC))
    one = LambdaStore(one_cold, "gdelt")
    rng = np.random.default_rng(SEED + 164)
    x, y = gdelt_points(N_POD_STREAM, rng)
    t = T0_MS + rng.integers(0, POD_SPAN_MS, N_POD_STREAM)
    fences = pod_fences(x, y, SEED + 163)
    t0 = time.perf_counter()
    for i, ring in enumerate(fences):
        for st in (pod, one):  # the never-crashed pod is held to rows only
            st.subscribe(Subscription(f"fence{i}", "geofence", geom=geometry.Polygon(ring)))
    subscribe_s = time.perf_counter() - t0
    ids = [f"e{i}" for i in range(N_POD_STREAM)]
    pod_alerts, one_alerts = set(), set()
    write_s, rejoin_s = [], None
    for b, s in enumerate(range(0, N_POD_STREAM, POD_STREAM_BATCH)):
        rows = [{"dtg": int(t[i]), "geom": geometry.Point(float(x[i]), float(y[i]))}
                for i in range(s, s + POD_STREAM_BATCH)]
        bids = ids[s : s + POD_STREAM_BATCH]
        t1 = time.perf_counter()
        check(pod.write(rows, bids) == POD_STREAM_BATCH, "the pod acknowledges the batch")
        write_s.append(time.perf_counter() - t1)
        ref.write(rows, bids)
        one.write(rows, bids)
        pod_alerts |= {(a["sub"], a["kind"], a["id"]) for a in pod.drain_alerts()}
        one_alerts |= {(a["sub"], a["kind"], a["id"]) for a in one.standing().alerts.drain()}
        if b == 2:
            pod.flush()
            ref.flush()
        if b + 1 == POD_KILL_AFTER:
            pod.kill(POD_KILLED)
            t1 = time.perf_counter()
            pod.rejoin(POD_KILLED)
            rejoin_s = time.perf_counter() - t1
    check(pod_alerts == one_alerts and len(one_alerts) > 0,
          "the union of the hosts' alerts equals one LambdaStore's")
    got = np.sort(np.asarray(pod.query().ids).astype(str))
    check(pod.count() == ref.count() == N_POD_STREAM, "the rejoined pod holds every row")
    check(np.array_equal(got, np.sort(np.asarray(ref.query().ids).astype(str))),
          "the rejoined pod's ids equal a never-crashed pod's")
    for q, box in pod_probes(SEED + 165)[:N_POD_BRUTE]:
        want = np.sort(np.array(ids)[brute_box_ids(x, y, box)])
        check(np.array_equal(np.sort(np.asarray(pod.query(q).ids).astype(str)), want),
              f"the rejoined pod's ids vs brute force: {q}")
    owned = [pod.stores[h].count() for h in range(POD_HOSTS)]
    for st in (pod, ref):
        st.close()
    one.close()
    one_cold.close()
    return {"n_rows": N_POD_STREAM, "batch": POD_STREAM_BATCH, "fences": N_POD_FENCES,
            "killed_host": POD_KILLED, "killed_after_batches": POD_KILL_AFTER,
            "subscribe_s": subscribe_s, "write_ms": m_summary(np.array(write_s) * 1e3),
            "rejoin_s": rejoin_s, "alerts": len(one_alerts), "rows_per_host": owned}


def pod_path(torch, device) -> dict:
    """gdelt-pod-10M: the multi-device tier on the card, after the
    reference's ``config_pod``: the pod, flat-mesh and one-device stores
    over ``N_POD`` rows, host-local ingest of 2M rows, a PodStore through a
    killed and rejoined host, and the two-process gloo probe's verdict.
    The probe's three processes run beside the store section (their
    own subprocesses, waited for at the end). Launch and native counts
    are zeroed before, read after."""
    from concurrent.futures import ThreadPoolExecutor

    from geomesa_tpu_torch.pod import probe_capability

    zero_launches()
    t_path = time.perf_counter()
    sections = {}

    def probe() -> dict:
        t0 = time.perf_counter()
        return {**probe_capability(refresh=True), "probe_s": time.perf_counter() - t0}

    with tempfile.TemporaryDirectory(prefix="geomesa-pod-") as tmp, \
            ThreadPoolExecutor(max_workers=1) as ex:
        probe_future = None
        for name, fn in (("scan", lambda: pod_scan_section(torch, device)),
                         ("ingest", lambda: pod_ingest_section(torch, device)),
                         ("store", lambda: pod_store_section(torch, device, tmp))):
            if name == "store":
                probe_future = ex.submit(probe)
            t0 = time.perf_counter()
            sections[name] = fn()
            sections[name]["section_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        sections["probe"] = probe_future.result(timeout=300)
    check(sections["probe"].get("verdict") == "supported",
          f"the two-process gloo probe reads supported: {sections['probe']}")
    return {
        "phase": "pod_path", "cell": "gdelt-pod-10M", "launches": read_launches(),
        "native": read_native(), **sections, "path_s": time.perf_counter() - t_path,
        "budget_s": POD_BUDGET_S,
        "reduced": {"scan_rows": f"{N_POD:,} (config_pod's default 150,000, raised)",
                    "ingest_rows": f"{N_POD_INGEST:,} (config_pod's default 400,000, raised)",
                    "devices": "8 shards of one card (the reference: 8 virtual CPU devices)"},
    }



# -- the measurement drivers of geomesa_tpu_torch/scripts/ -----------------

N_SCRIPT_1B = 4_000_000  # validate_1b's rows (the reference's 10^9)
N_SCRIPT_LINK = 16 * 1024 * 1024  # probe_link's table (its 128M)
N_SCRIPT_DENSITY = 5_000_000  # probe_density_many's points (its 50M)
N_SCRIPT_XZ2 = 2_000_000  # the three XZ2 probes' footprints (their 50M)
N_SCRIPT_JOIN = 2_000_000  # profile_join's points (its 20M) ...
N_SCRIPT_POLYGONS = 64  # ... and polygons (its 256)
SCRIPTS_BUDGET_S = 60.0


def script_runs(torch, device) -> list:
    """(name, call, its exactness fields) of each driver at this phase's
    sizes, in the order they run."""
    from geomesa_tpu_torch.scripts import (probe_async_pull, probe_density_many, probe_floor,
                                           probe_link, probe_xz2_50m, probe_xz2_pipeline,
                                           probe_xz2_stage, profile_join, run_pod_scale,
                                           validate_1b)

    def pod_ci():
        argv = ["--ci", "--device", str(device)]
        return run_pod_scale.run(run_pod_scale._parse_args(argv), argv)

    return [
        ("validate_1b", lambda: validate_1b.run(N_SCRIPT_1B, device),
         lambda r: r["queries_exact"] == 12 and r["post_append_exact"]),
        ("run_pod_scale", pod_ci,
         lambda r: not r["ci_failures"] and r["queries"]["exact"] and r["fused_join"]["exact"]
         and r["fused_join"]["shard_legs"] > 0 and r["compaction"]["exact"]),
        ("probe_link", lambda: probe_link.run(N_SCRIPT_LINK, device),
         lambda r: r["count_scan"]["count"] > 0 and r["gather_scan"]["count"] > 0),
        ("probe_floor", lambda: probe_floor.run(device), lambda r: r["overlap"]["ms"] is not None),
        ("probe_async_pull", lambda: probe_async_pull.run(device),
         lambda r: r["async_ms"] is not None),
        ("probe_density_many", lambda: probe_density_many.run(N_SCRIPT_DENSITY, device),
         lambda r: r["grids_equal"]),
        ("probe_xz2_50m", lambda: probe_xz2_50m.run(N_SCRIPT_XZ2, device),
         lambda r: r["checked_vs_brute_force"] == probe_xz2_50m.N_QUERIES),
        ("probe_xz2_pipeline", lambda: probe_xz2_pipeline.run(N_SCRIPT_XZ2, device),
         lambda r: r["same_ids"] and r["checked_vs_brute_force"] == probe_xz2_50m.N_QUERIES),
        ("probe_xz2_stage", lambda: probe_xz2_stage.run(N_SCRIPT_XZ2, device),
         lambda r: r["checked_vs_brute_force"] == 1 and r["hits"] > 0),
        ("profile_join", lambda: profile_join.run(N_SCRIPT_JOIN, N_SCRIPT_POLYGONS, device),
         lambda r: r["checked_polygons"] == N_SCRIPT_POLYGONS and r["pairs"] > 0),
    ]


def scripts_path(torch, device) -> dict:
    """Each driver's ``run`` on the card, its record emitted on a line of
    its own with the kernels it launched (every driver checks its
    answers and raises on a wrong one; here its exactness fields are
    checked again), under ``SCRIPTS_BUDGET_S``."""
    zero_launches()
    t_path = time.perf_counter()
    drivers = {}
    for name, call, exact in script_runs(torch, device):
        before, t0 = read_launches(), time.perf_counter()
        rec = call()
        wall_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        launched = {k: v - before[k] for k, v in read_launches().items()}
        emit({"phase": "scripts", "script": name, "wall_s": wall_s, "launches": launched,
              "record": rec})
        check(exact(rec), f"the {name} driver's answers are exact on the card")
        ran_on = rec["device"] if "device" in rec else rec["provenance"]["device_name"]
        check(ran_on == torch.cuda.get_device_name(0), f"{name} ran on the card")
        drivers[name] = {"wall_s": wall_s, "launches": launched,
                         "reduced": rec["reduced"] if "reduced" in rec
                         else rec["provenance"]["reduced"]}
    path_s = time.perf_counter() - t_path
    check(path_s < SCRIPTS_BUDGET_S, f"the scripts phase took {path_s:.1f} s "
          f"(budget {SCRIPTS_BUDGET_S} s)")
    return {"phase": "scripts_path", "cell": "scripts", "launches": read_launches(),
            "native": read_native(), "drivers": drivers, "path_s": path_s,
            "budget_s": SCRIPTS_BUDGET_S,
            "reduced": "every driver at a small size (each driver's own reduced), so the "
                       "ten fit SCRIPTS_BUDGET_S; their full-size runs are not part of the "
                       "script"}


# -- the examples of geomesa_tpu_torch/examples/ -----------------------------

EXAMPLES = ("quickstart", "batch_and_update", "distributed_mesh", "sql_and_joins",
            "streaming_hot_tier")
EXAMPLES_BUDGET_S = 60.0


def run_example(name, device) -> tuple:
    """(result, printed lines, record, wall s) of one example's ``main``."""
    mod = importlib.import_module(f"geomesa_tpu_torch.examples.{name}")
    record, buf = {}, io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(device=device, record=record)
    return out, buf.getvalue().splitlines(), record, time.perf_counter() - t0


def same_value(a, b) -> bool:
    """Exact equality of two example values: arrays and tensors element
    for element (dtype and shape included), containers item for item,
    feature collections by ids in order and their columns."""
    if hasattr(a, "ids") and hasattr(a, "columns"):
        def values(col):  # a point column by its coordinates
            return (np.asarray(col.x), np.asarray(col.y)) if hasattr(col, "x") else np.asarray(col)

        return (same_value(np.asarray(a.ids), np.asarray(b.ids))
                and list(a.columns) == list(b.columns)
                and all(same_value(values(a.columns[c]), values(b.columns[c])) for c in a.columns))
    if hasattr(a, "detach"):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_value(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_value(a[k], b[k]) for k in a)
    return a == b


def examples_path(torch, device) -> dict:
    """Each example on the card, then on the CPU in this process: the
    results, the records and the printed lines equal, the CPU runs
    launching nothing; under ``EXAMPLES_BUDGET_S``."""
    zero_launches()
    t_path = time.perf_counter()
    card = {}
    for name in EXAMPLES:
        before = read_launches()
        card[name] = run_example(name, device)
        torch.cuda.synchronize()
        card[name] += ({k: v - before[k] for k, v in read_launches().items()},)
    launches, native_calls = read_launches(), read_native()
    examples = {}
    for name in EXAMPLES:
        out, lines, record, wall_s, launched = card[name]
        cpu_out, cpu_lines, cpu_record, cpu_wall_s = run_example(name, torch.device("cpu"))
        diff = [k for k in record if not same_value(record[k], cpu_record[k])]
        emit({"phase": "examples", "example": name, "wall_s": wall_s, "cpu_wall_s": cpu_wall_s,
              "launches": launched, "lines": lines, "differs": diff})
        check(lines == cpu_lines, f"the {name} example prints on the card what it prints on "
              f"the CPU: {lines} vs {cpu_lines}")
        check(same_value(out, cpu_out), f"the {name} example returns on the card what it "
              "returns on the CPU")
        check(not diff and record.keys() == cpu_record.keys(),
              f"the {name} example's {diff} equal on the card and on the CPU")
        examples[name] = {"wall_s": wall_s, "cpu_wall_s": cpu_wall_s, "launches": launched,
                          "checked": sorted(record)}
        del card[name]
        torch.cuda.empty_cache()
    check(read_launches() == launches, "the examples' CPU runs launched no kernel")
    path_s = time.perf_counter() - t_path
    check(path_s < EXAMPLES_BUDGET_S, f"the examples phase took {path_s:.1f} s "
          f"(budget {EXAMPLES_BUDGET_S} s)")
    return {"phase": "examples_path", "cell": "examples", "launches": launches,
            "native": native_calls, "examples": examples, "path_s": path_s,
            "budget_s": EXAMPLES_BUDGET_S,
            "reduced": "none: every example at the reference's seeds and sizes"}


# -- entry point -------------------------------------------------------------


def check_native(records) -> None:
    """Each path must have called the native host helpers it runs: the
    ranges wherever it plans new filters, the radix sort wherever it
    ingests, the plane decode wherever it decodes (the wide plane alone on
    the extent cells), point-in-polygon on the polygon paths."""
    natives = {r["cell"]: r["native"] for r in records}
    natives["gdelt-z2-20M-polygon-ingest"] = next(
        r["native_ingest"] for r in records if r["cell"] == "gdelt-z2-20M-polygon")
    point = ("zranges", "sort_bins_z", "bitmask_decode_pair")
    expected_native = {
        "gdelt-z3-100M": point,
        # the batch path plans the main path's 64 queries again: the
        # planner's scan-config memo serves their ranges
        "gdelt-z3-100M-batch": ("bitmask_decode_pair",),
        "gdelt-z3-100M-polygon": ("zranges", "bitmask_decode_pair", "points_in_polygon"),
        "gdelt-z3-100M-hints": ("zranges", "bitmask_decode_pair"),
        "gdelt-z3-packed-10M": point,
        "gdelt-z2-20M-polygon": ("zranges", "bitmask_decode_pair", "points_in_polygon"),
        "gdelt-z2-20M-polygon-ingest": ("sort_bins_z",),
        "osm-xz2-50M": ("xz_index", "xz_ranges", "sort_bins_z", "bitmask_decode"),
        "xz3-10M-mixed": ("xz_index", "xz_ranges", "sort_bins_z", "bitmask_decode"),
        "gdelt-z3-10M-tiered": point,
        "gdelt-z3-10M-mutate": point,
        "gdelt-attr-10M": point,
        "gdelt-z3-10M-persist": point,
        "gdelt-z3-10M-secure-cached": point,
        "gdelt-z3-10M-served": point,
        "moving-z3-3M-stream": point,
        # the flushes ingest, the matcher decodes K2's planes
        "moving-standing-1M": ("sort_bins_z", "bitmask_decode_pair"),
        "moving-replica-60k": point,
        "gdelt-ingest-20M": point,
        # the host grid join sorts by cell, the joins refine on the host
        "gdelt-z2-20M-analytics": point + ("points_in_polygon", "counting_argsort"),
        "moving-z3-2M-http": point,
        # S2 covers are numpy BFS (no native ranges); the keys sort natively
        "gdelt-s2-10M": ("sort_bins_z", "bitmask_decode_pair"),
        "gdelt-z2-1M-drift": point + ("points_in_polygon",),
        "gdelt-pod-10M": point,
        "examples": point,
    }
    for cell, names in expected_native.items():
        for name in names:
            check(natives[cell][name] > 0, f"native helper {name} called on the {cell} path")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def lint_phase() -> dict:
    """The port's static analysis over the tree this script sits in,
    through its runner (exit 0 clean, 1 findings, 2 unusable): findings,
    rule count, wall and CPU seconds (the runner's process)."""
    from geomesa_tpu_torch import analysis

    root = os.path.dirname(os.path.abspath(__file__))
    c0, t0 = os.times(), time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "geomesa_tpu_torch.scripts.check", "--json",
                          "--root", root], cwd=root, capture_output=True, text=True, timeout=300)
    wall_s, c1 = time.perf_counter() - t0, os.times()
    payload = json.loads(out.stdout) if out.stdout.strip().startswith("{") else {}
    rec = {"phase": "lint", "exit_code": out.returncode, "rules": len(analysis.ALL_RULES),
           "findings": [f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
                        for f in payload.get("findings", [])],
           "suppressed": len(payload.get("suppressed", [])),
           "wall_s": wall_s, "cpu_s": (c1.children_user - c0.children_user)
           + (c1.children_system - c0.children_system),
           "analysis_s": payload.get("seconds")}
    emit(rec)
    check(out.returncode == 0 and payload.get("clean") is True and not rec["findings"],
          f"the port's lint is clean (exit {out.returncode}): {rec['findings']} {out.stderr[-2000:]}")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from geomesa_tpu_torch import native
    from geomesa_tpu_torch.kernels import KERNELS, PROBE_KERNELS, build_all

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = nvidia_smi()
    build_s = build_all((*KERNELS, *PROBE_KERNELS))  # every source at once
    # the native host helpers: built with g++ and loaded before any path
    t_native = time.perf_counter()
    native.library()
    check(native.loaded(), "the native host helpers are built and loaded")
    emit({"phase": "device", "nvidia_smi": smi, "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s,
          "native_build_s": time.perf_counter() - t_native, "host_cpus": os.cpu_count()})

    lint_phase()

    timings = kernel_phase(torch, device)
    emit({"phase": "kernels_vs_plain", **{k: v for k, v in timings.items()}})

    probes, probe_kernels = probe_phase(torch, device)
    emit(probes)

    # tracing stays disarmed in every measured pass (the slow-query log
    # arms it by default); the hints path arms it for its own traced pass
    from geomesa_tpu_torch import conf

    conf.OBS_TRACE_SAMPLE.set(0)
    conf.OBS_SLOW_MS.set(0)
    records = main_path(torch, device)
    for rec in records:
        emit(rec)
    paths = {r["cell"]: r["launches"] for r in records}
    # each path names the kernels it is meant to run
    expected = {
        "gdelt-z3-100M": ("block_scan", "density", "bounds"),
        "gdelt-z3-100M-batch": ("block_scan_multi", "block_pops", "density"),
        "gdelt-z3-100M-polygon": ("block_scan", "block_scan_multi"),
        "gdelt-z3-100M-hints": ("block_scan", "block_scan_multi"),
        "gdelt-z3-packed-10M": tuple(k.name for k in KERNELS),
        "gdelt-z2-20M-polygon": ("block_scan", "block_scan_multi"),
        "osm-xz2-50M": tuple(k.name for k in KERNELS),
        "xz3-10M-mixed": ("block_scan", "block_scan_multi"),
        "gdelt-z3-10M-tiered": tuple(k.name for k in KERNELS),
        "gdelt-z3-10M-mutate": tuple(k.name for k in KERNELS),
        "gdelt-attr-10M": ("block_scan", "block_scan_multi"),
        "gdelt-z3-10M-persist": tuple(k.name for k in KERNELS),
        "gdelt-z3-10M-secure-cached": tuple(k.name for k in KERNELS),
        "gdelt-z3-10M-served": ("block_scan", "block_scan_multi"),
        "moving-z3-3M-stream": ("block_scan", "block_scan_multi"),
        "moving-standing-1M": ("block_scan_multi",),
        "moving-replica-60k": ("block_scan",),
        "gdelt-ingest-20M": ("block_scan", "density", "bounds"),
        "gdelt-z2-20M-analytics": ("block_scan", "block_scan_multi"),
        "moving-z3-2M-http": ("block_scan", "block_scan_multi"),
        "gdelt-s2-10M": ("block_scan", "density", "bounds"),
        "gdelt-z2-1M-drift": ("block_scan", "block_scan_multi"),
        "gdelt-pod-10M": tuple(k.name for k in KERNELS),
        "scripts": ("block_scan", "block_scan_multi", "density"),
        "examples": ("block_scan", "block_scan_multi", "density"),
    }
    for cell, names in expected.items():
        for name in names:
            check(paths[cell][name] > 0, f"kernel {name} launched on the {cell} path")
    check_native(records)
    # ... and the polygon legs they are meant to run
    leg_paths = {r["cell"]: r["leg_launches"] for r in records if "leg_launches" in r}
    expected_legs = {
        "gdelt-z3-100M-polygon": {"block_scan": ("pip", "raster", "pip+raster"),
                                  "block_scan_multi": ("pip", "raster", "pip+raster")},
        "gdelt-z2-20M-polygon": {"block_scan": ("raster",), "block_scan_multi": ()},
        # the extent leg: every kernel on the XZ2 cell, the scans on XZ3
        "osm-xz2-50M": {k.name: ("extent",) for k in KERNELS},
        "xz3-10M-mixed": {"block_scan": ("extent",), "block_scan_multi": ("extent",)},
        # the standing matcher: K2's point-in-polygon leg
        "moving-standing-1M": {"block_scan_multi": ("pip",)},
    }
    for cell, kernels in expected_legs.items():
        for name, legs in kernels.items():
            counts = leg_paths[cell][name]
            for leg in legs:
                check(counts[leg] > 0, f"{name} leg {leg} launched on the {cell} path")
            check(sum(counts.values()) > 0, f"{name} legs launched on the {cell} path")

    replaces = {
        "block_scan": "geomesa_tpu/scan/block_kernels.py:685 (_pallas_block_scan; pallas_call :727)",
        "density": "geomesa_tpu/scan/aggregations.py:244 (_pallas_density; pallas_call :273)",
        "bounds": "geomesa_tpu/scan/aggregations.py:358 (_pallas_bounds; pallas_call :378)",
        "block_scan_multi": "geomesa_tpu/scan/block_kernels.py:847 "
                            "(_pallas_block_scan_multi; pallas_call :904)",
        "block_pops": "geomesa_tpu/scan/aggregations.py:86 "
                      "(_pops_pallas; through _pallas_block_scan's pallas_call block_kernels.py:727)",
    }
    kernels = []
    for k in KERNELS:
        t = timings[k.name]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"geomesa_tpu_torch/csrc/{k.name}.cu",
            "replaces": replaces[k.name],
            "launches": sum(launches[k.name] for launches in paths.values()),
            "launches_by_path": {cell: launches[k.name] for cell, launches in paths.items()},
            "equal_to_plain": t["max_abs_err"] == 0.0, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "kernel_ms": t["ms"], "wrapper_ms": t["wrapper_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            **({"clustered": t["clustered"]} if "clustered" in t else {}),
            **({"small_m": t["small_m"]} if "small_m" in t else {}),
            **({"legs": t["legs"],
                "leg_launches_by_path": {cell: legs[k.name] for cell, legs in leg_paths.items()}}
               if "legs" in t else {}),
        })
    kernels += probe_kernels
    emit({"kernels": kernels, "wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    # the run drives one card, cuda:0
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
