"""The port's data plane (geomesa_tpu_torch/serving/http.py) against the
JAX package's, over real sockets on the CPU.

Both packages mount a ``DataServer`` on loopback over the same seeded
store and answer the same requests through the stdlib clients. Mirrors
every case of tests/test_serve_http.py:

- wire formats: GeoJSON and Arrow query bodies byte for byte equal to the
  port's in-process exporters and to the JAX server's bodies, at every
  page size; keep-alive reuse; empty results;
- paging: ``sort_by`` + ``offset`` / ``limit`` pages union to the full
  result; ``limit`` sets ``X-Geomesa-Rows``;
- the error contract: 400 / 404 / 411 / 413 statuses, the
  ``geomesa.serve.badrequest`` counter, workers alive after hostile
  bodies and hostile visibility labels;
- the ops surfaces and ``/tenants`` on the data port;
- ingest: a cold-store ingest, and on a LambdaStore with a WAL under
  ``sync=always`` every acked row survives ``wal.crash()`` +
  ``LambdaStore.recover``;
- admission: a tenant over quota and a full shared queue answer 429 with
  ``Retry-After``; concurrent tenants all accounted;
- auths: a subset masks rows, auths beyond the server's answer 403;
- replicas: unmeasured staleness answers 503 + ``Retry-After``, follower
  writes 403 + ``X-Geomesa-Leader``, the disk-tail replica;
- the CLI's ``serve`` and ``serve --replica-of``;
- tiles: PNG bytes, ETags, 304 with no aggregation, warm == fresh, the
  Arrow grid, scoped invalidation by ingest, error statuses, the
  visibility 403, the fetch histogram;
- the visibility parser under fuzz in both packages alike.

Status codes, ``Retry-After`` and ``X-Geomesa-*`` headers and bodies are
compared exactly; ``/tenants`` apart from measured times.
"""

import json
import threading

import numpy as np
import pyarrow  # noqa: F401  (imported on the main thread: see DataServer.__init__)
import pytest

from test_torch_native import ensure_jax_native
from test_torch_serving_tier import BOTH, JAX, PORT

DAY = 86_400_000
T0 = int(np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64))
Q = "BBOX(geom, -60, -45, 60, 45)"
QP = Q.replace(" ", "%20")
SPEC = "name:String:index=true,dtg:Date,*geom:Point:srid=4326"
HEADERS = ("Content-Type", "X-Geomesa-Rows", "Retry-After", "X-Geomesa-Leader", "ETag",
           "Cache-Control", "Transfer-Encoding", "Content-Length")


def _mod(P, name):
    from importlib import import_module

    return import_module(f"{P.name}.{name}")


@pytest.fixture(autouse=True)
def _native():
    from test_torch_replica import jax_global_metrics_kept

    ensure_jax_native()
    with jax_global_metrics_kept():  # JAX followers count into its global registry
        yield


def _store(P, n=300, auths=None, spec=SPEC, type_name="t", extra_cols=None, user_data=None,
           cache=None, seed=11, lo=(-50, -40), hi=(50, 40)):
    sft = P.pkg.FeatureType.from_spec(type_name, spec)
    for k, v in (user_data or {}).items():
        sft.user_data[k] = v
    ds = P.pkg.DataStore(tile=64, auths=auths, metrics=P.metrics.MetricsRegistry(), cache=cache,
                         **P.kw)
    ds.create_schema(sft)
    rng = np.random.default_rng(seed)
    cols = {
        "name": np.array([f"n{i:04d}" for i in range(n)]),
        "dtg": T0 + rng.integers(0, 20 * DAY, n),
        "geom": (rng.uniform(lo[0], hi[0], n), rng.uniform(lo[1], hi[1], n)),
    }
    cols.update(extra_cols or {})
    ds.write(type_name, P.pkg.FeatureCollection.from_columns(
        sft, [f"f{i}" for i in range(n)], cols))
    return ds


def _feature(fid, name, x=0.5, y=0.5, dtg=1704067200000, **props):
    props = dict({"name": name, "dtg": dtg}, **props)
    return {"type": "Feature", "id": fid,
            "geometry": {"type": "Point", "coordinates": [x, y]}, "properties": props}


def _payload(*features):
    return {"type": "FeatureCollection", "features": list(features)}


def _client(P, *a, **kw):
    return P.serving.DataClient(*a, **kw)


def _same(ra, rb, body=True):
    """Two (status, headers, body) answers agree: status, the data plane's
    headers and (by default) the body bytes."""
    (sa, ha, ba), (sb, hb, bb) = ra, rb
    assert sa == sb
    assert {k: ha.get(k) for k in HEADERS} == {k: hb.get(k) for k in HEADERS}
    if body:
        assert ba == bb


@pytest.fixture(scope="module")
def served():
    """{package: (store, server, client)} over module-lifetime stores."""
    ensure_jax_native()
    out = {}
    for P in BOTH:
        ds = _store(P)
        srv = ds.serve(port=0)
        out[P.name] = (ds, srv, _client(P, srv.url))
    yield out
    for ds, _srv, _c in out.values():
        ds.close()


def _req(served, method, path, **kw):
    return [served[P.name][2].request(method, path, **kw) for P in BOTH]


# -- wire formats --------------------------------------------------------------

@pytest.mark.parametrize("path", [
    f"/query/t?cql={QP}", f"/query/t?cql={QP}&page_rows=1", f"/query/t?cql={QP}&page_rows=7",
    f"/query/t?cql={QP}&page_rows=100000", "/query/t?limit=10", "/query/t",
    f"/query/t?fmt=arrow&page_rows=64&cql={QP}", "/query/t?fmt=arrow",
    "/query/t?cql=BBOX(geom,%20170,%2080,%20171,%2081)",
    "/query/t?cql=BBOX(geom,%20170,%2080,%20171,%2081)&fmt=arrow",
    "/query/t?cql=name%20=%20'n0007'", f"/query/t?cql={QP}&sort_by=name&offset=64&limit=64",
])
def test_query_bodies_equal_the_jax_server_and_the_exporters(served, path):
    ja, ta = _req(served, "GET", path)
    _same(ja, ta)
    assert ta[0] == 200


def test_geojson_bytes_identical_to_export(served):
    from geomesa_tpu_torch.io.exporters import _geojson

    ds, _srv, client = served[PORT.name]
    want = _geojson(ds.query("t", Q)).encode()
    for rows in (None, 1, 7, 100, 100000):
        status, hdrs, raw = client.request(
            "GET", f"/query/t?cql={QP}" + (f"&page_rows={rows}" if rows else ""))
        assert status == 200 and raw == want, rows
        assert hdrs["Content-Type"] == "application/geo+json"
        assert hdrs["X-Geomesa-Rows"] == str(len(ds.query("t", Q)))


def test_arrow_bytes_identical_to_stream(served):
    from geomesa_tpu_torch.io.arrow import arrow_stream, read_arrow, read_arrow_table

    ds, _srv, client = served[PORT.name]
    raw = client.query("t", cql=Q, fmt="arrow", page_rows=64)
    direct = ds.query("t", Q)
    assert raw == arrow_stream(direct, batch_rows=64)
    rt = read_arrow(raw, sft=ds.get_schema("t"))
    assert sorted(map(str, rt.ids.tolist())) == sorted(map(str, direct.ids.tolist()))
    empty = client.query("t", cql="BBOX(geom, 170, 80, 171, 81)", fmt="arrow")
    assert read_arrow_table(empty).num_rows == 0


def test_keep_alive_connection_reused(served):
    for P in BOTH:
        _ds, srv, _c = served[P.name]
        with _client(P, srv.url, keep_alive=True) as ka:
            first = ka.query("t", cql=Q, limit=5)
            conn = ka._conn
            for _ in range(3):
                assert ka.query("t", cql=Q, limit=5) == first
                assert ka._conn is conn
            conn.close()
            assert ka.query("t", cql=Q, limit=5) == first
        assert ka._conn is None


def test_paged_union_is_complete_and_duplicate_free(served):
    pages = []
    for P in BOTH:
        ds, _srv, client = served[P.name]
        got, offset = [], 0
        while True:
            feats = client.query("t", cql=Q, sort_by="name", offset=offset, limit=64)["features"]
            got.extend(f["id"] for f in feats)
            offset += 64
            if len(feats) < 64:
                break
        full = ds.query("t", Q)
        assert len(got) == len(set(got)) == len(full)
        pages.append(got)
    assert pages[0] == pages[1]


# -- the error contract --------------------------------------------------------

@pytest.mark.parametrize("path,want", [
    ("/query/nope", 404), ("/nope", 404), ("/query/t?fmt=csv", 400),
    ("/query/t?cql=NOT%20CQL(((", 400), ("/query/t?limit=banana", 400),
])
def test_statuses(served, path, want):
    ja, ta = _req(served, "GET", path)
    _same(ja, ta)
    assert ta[0] == want and "error" in json.loads(ta[2])


def test_bad_requests_counted_and_worker_survives(served):
    for P in BOTH:
        ds, _srv, client = served[P.name]
        before = ds.metrics.counters.get("geomesa.serve.badrequest", 0)
        with pytest.raises(P.serving.ServeError) as e:
            client.query("t", cql="NOT CQL(((")
        assert e.value.status == 400
        assert ds.metrics.counters["geomesa.serve.badrequest"] > before
        assert client.health()["http_status"] == 200


def test_post_requires_length_and_bounds_body(served):
    ja, ta = _req(served, "POST", "/ingest/t")
    _same(ja, ta)
    assert ta[0] == 411
    big = served[PORT.name][1].max_body_bytes + 1
    ja, ta = _req(served, "POST", "/ingest/t", headers={"Content-Length": str(big)})
    _same(ja, ta)
    assert ta[0] == 413 and "bound" in json.loads(ta[2])["error"]
    ja, ta = _req(served, "POST", "/nope", body=b"{}")
    _same(ja, ta)
    assert ta[0] == 404


def test_ops_surfaces_on_data_port(served):
    for P in BOTH:
        _ds, _srv, client = served[P.name]
        h = client.health()
        assert h["http_status"] == 200 and h["status"] in ("ready", "degraded", "unhealthy")
        assert "geomesa" in client.metrics_text()
        assert client.stats()
        assert {"default_weight", "default_queue_max", "tenants"} <= set(client.tenants())
    ja, ta = _req(served, "GET", "/stats")
    _same(ja, ta)
    ja, ta = _req(served, "GET", "/debug/tuning")
    _same(ja, ta)


def _strip_times(rep):
    """A /tenants report apart from its measured times."""
    rows = []
    for r in rep["tenants"]:
        rows.append({k: v for k, v in r.items()
                     if "_ms" not in k and not k.endswith("_s") and k not in ("slo", "latency")})
    return {**{k: v for k, v in rep.items() if k != "tenants"}, "tenants": rows}


# -- ingest ----------------------------------------------------------------------

def test_cold_store_ingest_roundtrip():
    outs = []
    for P in BOTH:
        ds = _store(P, n=10)
        with ds.serve(port=0) as srv:
            client = _client(P, srv.url)
            ack = client.ingest("t", _payload(_feature("in-0", "zz-a"),
                                              _feature("in-1", "zz-b", x=1.5)))
            assert ack == {"acked": 2, "durable": False, "type": "t"}
            outs.append(client.request("GET", "/query/t?cql=name%20=%20'zz-a'"))
        assert ds.metrics.counters["geomesa.serve.ingested"] == 2
        ds.close()
    _same(*outs)


def _leader(P, tmp_path, n=30):
    st = _mod(P, "streaming")
    ds = _store(P, n=n)
    root = str(tmp_path / P.name / "s")
    _mod(P, "storage.persist").save(ds, root)
    lam = st.LambdaStore(ds, "t", config=st.StreamConfig(chunk_rows=64, fold_rows=4096),
                         wal_dir=f"{root}/_wal",
                         wal_config=st.WalConfig(sync="always", sync_interval_ms=1e9))
    return root, lam


def test_wal_ack_survives_crash_and_recover(tmp_path):
    got = []
    for P in BOTH:
        root, lam = _leader(P, tmp_path, n=20)
        srv = lam.serve(port=0)
        client = _client(P, srv.url)
        for k in range(3):
            ack = client.ingest("t", _payload(
                *(_feature(f"d{k}-{i}", f"dur-{i}", x=i * 0.01) for i in range(15))))
            assert ack["acked"] == 15 and ack["durable"] is True
        srv.close()
        lam.wal.crash()
        rec = _mod(P, "streaming").LambdaStore.recover(root, **P.kw)
        ids = set(map(str, rec.query("INCLUDE").ids.tolist()))
        acked = {f"d{k}-{i}" for k in range(3) for i in range(15)}
        assert acked <= ids and len(ids) == 20 + 45  # none lost, none invented
        got.append(sorted(ids))
        lam.flusher.close()
        lam.cold.close()  # the scheduler the data plane started on it
        rec.close()
        rec.cold.close()
    assert got[0] == got[1]


def test_hostile_payloads_are_counted_400s(served):
    cases = [(b'{"type": "FeatureCollection", "features": [{', "geojson"),
             (b"not json at all", "geojson"), (b'{"type": "Polygon"}', "geojson"),
             (b"\xff\xfe\x00garbage-ipc", "arrow")]
    for P in BOTH:
        ds, _srv, client = served[P.name]
        before = ds.metrics.counters.get("geomesa.serve.badrequest", 0)
        for body, fmt in cases:
            with pytest.raises(P.serving.ServeError) as e:
                client.ingest("t", body, fmt=fmt)
            assert e.value.status == 400, body
        assert ds.metrics.counters["geomesa.serve.badrequest"] >= before + len(cases)
        assert client.health()["http_status"] == 200
    for body, fmt in cases:
        ctype = "application/vnd.apache.arrow.stream" if fmt == "arrow" else "application/geo+json"
        ja, ta = _req(served, "POST", "/ingest/t", body=body, headers={"Content-Type": ctype})
        _same(ja, ta)


def _vis_store(P, n=40, auths=("admin", "user"), vis=None):
    sec = _mod(P, "security")
    return _store(P, n=n, auths=auths, spec=SPEC + ",vis:String",
                  extra_cols={"vis": np.array(vis if vis is not None else ["admin", "user"] * (n // 2))},
                  user_data={sec.VIS_FIELD_KEY: "vis"})


def test_hostile_visibility_label_rejected_before_storage():
    outs = []
    for P in BOTH:
        ds = _vis_store(P, n=10, auths=("admin",), vis=[""] * 10)
        with ds.serve(port=0) as srv:
            client = _client(P, srv.url)
            with pytest.raises(P.serving.ServeError) as e:
                client.ingest("t", _payload(_feature("bad-0", "x", vis="admin & (((((")))
            assert e.value.status == 400 and "isibility" in e.value.body
            outs.append(e.value.body)
            assert client.query("t", cql="name = 'x'")["features"] == []
        ds.close()
    assert outs[0] == outs[1]


# -- admission -------------------------------------------------------------------

def test_tenant_quota_sheds_429_with_retry_after():
    reps, answers = [], []
    for P in BOTH:
        ds = _store(P, n=50)
        srv = ds.serve(port=0)
        srv.tenants.configure("flood", queue_max=0)
        flood = _client(P, srv.url, tenant="flood")
        calm = _client(P, srv.url, tenant="calm")
        with pytest.raises(P.serving.ServeError) as e:
            flood.query("t", cql=Q)
        assert e.value.status == 429 and e.value.retry_after > 0
        answers.append((e.value.status, e.value.body, e.value.headers.get("Retry-After")))
        assert len(calm.query("t", cql=Q, limit=5)["features"]) == 5
        rows = {r["tenant"]: r for r in srv.tenants.report()["tenants"]}
        assert rows["flood"]["shed"] >= 1 and rows["flood"]["served"] == 0
        assert rows["calm"]["served"] >= 1 and rows["calm"]["shed"] == 0
        reps.append({t: (r["shed"], r["served"]) for t, r in rows.items()})
        ds.close()
    assert answers[0] == answers[1] and reps[0] == reps[1]


def test_shared_queue_full_sheds_429_not_silent_queueing():
    answers = []
    for P in BOTH:
        ds = _store(P, n=50)
        sched = P.serving.QueryScheduler(ds, P.serving.ServingConfig(queue_max=1))
        ds.scheduler = sched
        srv = ds.serve(port=0)
        sched.submit("t", Q, block=False)
        with pytest.raises(P.serving.ServeError) as e:
            _client(P, srv.url).query("t", cql=Q)
        assert e.value.status == 429 and "Retry-After" in e.value.headers
        answers.append((e.value.status, e.value.body, e.value.headers["Retry-After"]))
        ds.close()
    assert answers[0] == answers[1]


def test_concurrent_mixed_tenants_all_accounted():
    for P in BOTH:
        ds = _store(P, n=100)
        srv = ds.serve(port=0)
        errs = []

        def worker(tenant, P=P, srv=srv):
            c = _client(P, srv.url, tenant=tenant)
            for _ in range(4):
                try:
                    c.query("t", cql=Q, limit=3)
                except Exception as e:  # noqa: BLE001 - collected below
                    errs.append(e)

        ts = [threading.Thread(target=worker, args=(f"w{i}",)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not errs
        rows = {r["tenant"]: r for r in srv.tenants.report()["tenants"]}
        assert all(rows[f"w{i}"]["served"] == 4 for i in range(4))
        ds.close()


# -- auths -------------------------------------------------------------------------

def test_subset_auths_mask_rows():
    outs = []
    for P in BOTH:
        ds = _vis_store(P)
        with ds.serve(port=0) as srv:
            full = _client(P, srv.url, auths=("admin", "user"))
            narrow = _client(P, srv.url, auths=("user",))
            all_rows = full.query("t", cql=Q)["features"]
            user_rows = narrow.query("t", cql=Q)["features"]
            assert 0 < len(user_rows) < len(all_rows)
            assert all(f["properties"]["vis"] == "user" for f in user_rows)
            outs.append(narrow.request("GET", f"/query/t?cql={QP}",
                                       headers={"X-Geomesa-Auths": "user"}))
        ds.close()
    _same(*outs)


def test_auths_beyond_server_403():
    outs = []
    for P in BOTH:
        ds = _vis_store(P)
        with ds.serve(port=0) as srv:
            client = _client(P, srv.url, auths=("secret",))
            for call in (lambda: client.query("t", cql=Q),
                         lambda: client.ingest("t", _payload(_feature("a", "x")))):
                with pytest.raises(P.serving.ServeError) as e:
                    call()
                assert e.value.status == 403 and "not held" in e.value.body
                outs.append(e.value.body)
        ds.close()
    assert outs[:2] == outs[2:]


# -- replicas ----------------------------------------------------------------------

def test_staleness_bound_and_follower_403(tmp_path):
    answers = []
    for P in BOTH:
        st = _mod(P, "streaming")
        root, lam = _leader(P, tmp_path)
        a, b = st.PipeTransport.pair()
        fol = st.ReplicaStore(root, str(tmp_path / P.name / "f" / "_wal"), b, type_name="t",
                              config=st.StreamConfig(chunk_rows=64, fold_rows=4096), **P.kw)
        ship = st.SegmentShipper(lam)
        ship.attach(a)
        srv = fol.serve(port=0, leader_url="http://leader.example:8080")
        client = _client(P, srv.url)
        with pytest.raises(P.serving.ServeError) as e:
            client.query("t", cql=Q, max_staleness_ms=1000)
        assert e.value.status == 503 and e.value.retry_after is not None
        answers.append((e.value.status, e.value.body, e.value.headers.get("Retry-After")))
        assert len(client.query("t", cql=Q)["features"]) > 0
        geo = _mod(P, "geometry")
        lam.write([{"name": "repl-new", "dtg": int(T0), "geom": geo.Point(1.0, 1.0)}],
                  ids=["r-new"])
        ship.pump()
        fol.drain()
        out = client.query("t", cql="name = 'repl-new'", max_staleness_ms=60_000)
        assert [f["id"] for f in out["features"]] == ["r-new"]
        with pytest.raises(P.serving.ServeError) as e:
            client.ingest("t", _payload(_feature("w", "x")))
        assert e.value.status == 403
        assert e.value.headers.get("X-Geomesa-Leader") == "http://leader.example:8080"
        answers.append((e.value.status, e.value.body))
        srv.close()
        fol.close()
        lam.close()
    assert answers[:2] == answers[2:]


class _NoTransport:
    def send(self, msg):
        pass

    def recv(self, timeout=0.0):
        return None

    def close(self):
        pass


def test_disk_tail_replica_measures_staleness(tmp_path):
    for P in BOTH:
        st = _mod(P, "streaming")
        root, lam = _leader(P, tmp_path)
        geo = _mod(P, "geometry")
        lam.write([{"name": "tailed", "dtg": int(T0), "geom": geo.Point(2.0, 2.0)}],
                  ids=["t-new"])
        fol = st.ReplicaStore(root, str(tmp_path / P.name / "f2" / "_wal"), _NoTransport(),
                              type_name="t", config=st.StreamConfig(chunk_rows=64, fold_rows=4096),
                              **P.kw)
        assert fol.tail_disk(f"{root}/_wal") >= 1 and fol.staleness_ms() is not None
        with fol.serve(port=0) as srv:
            out = _client(P, srv.url).query("t", cql="name = 'tailed'", max_staleness_ms=60_000)
            assert [f["id"] for f in out["features"]] == ["t-new"]
        fol.close()
        lam.close()


# -- the CLI ------------------------------------------------------------------------

def _cli_args(P, argv):
    return argv + (["--device", "cpu"] if P is PORT else [])


def test_serve_command_smoke(tmp_path, capsys):
    bodies = []
    for P in BOTH:
        cli = _mod(P, "cli")
        ds = _store(P, n=15)
        root = str(tmp_path / P.name / "cat")
        _mod(P, "storage.persist").save(ds, root)
        ds.close()
        args = cli.build_parser().parse_args(_cli_args(P, ["serve", "-c", root, "--port", "0"]))
        srv = cli.cmd_serve(args, hold=False)
        try:
            assert f"serving {root} at {srv.url}" in capsys.readouterr().out
            client = _client(P, srv.url)
            assert len(client.query("t", cql=Q)["features"]) == 15
            bodies.append(client.request("GET", f"/query/t?cql={QP}"))
        finally:
            srv.store.close()
    _same(*bodies)


def test_serve_replica_command_smoke(tmp_path, capsys):
    for P in BOTH:
        cli = _mod(P, "cli")
        root, lam = _leader(P, tmp_path, n=12)
        args = cli.build_parser().parse_args(_cli_args(P, [
            "serve", "-c", root, "-f", "t", "--port", "0", "--replica-of", f"{root}/_wal",
            "--replica-wal", str(tmp_path / P.name / "rw"), "--leader-url", "http://leader:1"]))
        srv = cli.cmd_serve(args, hold=False)
        try:
            client = _client(P, srv.url)
            assert len(client.query("t", cql=Q)["features"]) == 12
            with pytest.raises(P.serving.ServeError) as e:
                client.ingest("t", _payload(_feature("w", "x")))
            assert e.value.status == 403
            assert e.value.headers.get("X-Geomesa-Leader") == "http://leader:1"
        finally:
            srv.store.close()
            lam.close()
        capsys.readouterr()


# -- the visibility parser under fire -------------------------------------------------

def test_visibility_fuzz_raises_the_same_errors():
    rng = np.random.default_rng(3)
    alphabet = list("abcXYZ01&|()!~ \t\"'\\,;%$#@在界") + ["&&", "||"]
    secs = [_mod(P, "security") for P in BOTH]
    for _ in range(300):
        expr = "".join(rng.choice(alphabet) for _ in range(int(rng.integers(0, 40))))
        outs = []
        for sec in secs:
            try:
                sec.validate(expr)
                outs.append(sec.visible(expr, frozenset({"a"})))
            except sec.VisibilityError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], expr
    labels = np.array(["a", "", None, "a&zzz", "a|b"], dtype=object)
    assert [s.visibility_mask(labels, frozenset({"a"})).tolist() for s in secs] == \
        [[True, True, True, False, True]] * 2


# -- tiles ------------------------------------------------------------------------------

def _tile_store(P, n=400):
    cache = _mod(P, "cache")
    return _store(P, n=n, cache=cache.CacheConfig(max_bytes=1 << 22), seed=21,
                  lo=(-170, -80), hi=(170, 80))


def _agg_work(ds):
    return tuple(ds.metrics.counter_value(n) for n in (
        "geomesa.tiles.compose", "geomesa.tiles.leaf.scan", "geomesa.tiles.fresh"))


@pytest.fixture(scope="module")
def tiled():
    ensure_jax_native()
    out = {}
    for P in BOTH:
        ds = _tile_store(P)
        srv = ds.serve(port=0)
        out[P.name] = (ds, srv, _client(P, srv.url))
    yield out
    for ds, _s, _c in out.values():
        ds.close()


@pytest.mark.parametrize("kind,z,x,y,fmt", [
    ("density", 1, 1, 0, "png"), ("count", 0, 0, 0, "png"), ("heat", 2, 5, 2, "png"),
    ("density", 3, 11, 4, "png"), ("count", 0, 0, 0, "arrow"), ("count", 3, 11, 4, "arrow"),
])
def test_tiles_equal_the_jax_server(tiled, kind, z, x, y, fmt):
    answers = [tiled[P.name][2].tile("t", kind, z, x, y, fmt=fmt) for P in BOTH]
    _same(*answers)
    fresh = [tiled[P.name][2].tile("t", kind, z, x, y, fmt=fmt, mode="fresh") for P in BOTH]
    _same(*fresh, body=False)
    assert answers[1][2] == fresh[1][2]  # warm == fresh


def test_png_etag_304_roundtrip(tiled):
    for P in BOTH:
        ds, _srv, c = tiled[P.name]
        st, h, body = c.tile("t", "density", 1, 1, 0)
        assert st == 200 and h["Content-Type"] == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"
        assert h["Cache-Control"] == "no-cache"
        etag = h["ETag"]
        work0 = _agg_work(ds)
        nm0 = ds.metrics.counter_value("geomesa.tiles.not_modified")
        st2, h2, b2 = c.tile("t", "density", 1, 1, 0, etag=etag)
        assert (st2, b2) == (304, b"") and h2["ETag"] == etag
        assert _agg_work(ds) == work0
        assert ds.metrics.counter_value("geomesa.tiles.not_modified") == nm0 + 1
        st3, _h3, b3 = c.tile("t", "density", 1, 1, 0, etag='"t999"')
        assert st3 == 200 and b3 == body


def test_arrow_grid_decodes(tiled):
    import pyarrow as pa

    for P in BOTH:
        _ds, srv, c = tiled[P.name]
        _st, _h, data = c.tile("t", "count", 0, 0, 0, fmt="arrow")
        table = pa.ipc.open_stream(data).read_all()
        meta = table.schema.metadata
        grid = np.asarray(table["count"]).reshape(int(meta[b"rows"]), int(meta[b"cols"]))
        assert grid.shape == (256, 256)
        assert np.array_equal(grid, srv.tiles.fetch("t", 0, 0, 0).grid)


def test_ingest_invalidates_scoped_over_http():
    for P in BOTH:
        ds = _tile_store(P)
        with ds.serve(port=0) as srv:
            c = _client(P, srv.url)
            z = srv.tiles.lattice.leaf_zoom
            _st, th, _b = c.tile("t", "density", z, 8, 3)
            _st, fh, _b = c.tile("t", "density", z, 0, 0)
            assert c.ingest("t", _payload(_feature("new-0", "x", 8.0, 8.0)))["acked"] == 1
            st, h2, _b = c.tile("t", "density", z, 8, 3, etag=th["ETag"])
            assert st == 200 and h2["ETag"] != th["ETag"]
            st, _h, _b = c.tile("t", "density", z, 0, 0, etag=fh["ETag"])
            assert st == 304
        ds.close()


@pytest.mark.parametrize("path,want", [
    ("/tiles/t/viridis/0/0/0", 400), ("/tiles/t/density/9/0/0", 400),
    ("/tiles/t/density/0/5/0", 400), ("/tiles/zz/density/0/0/0", 404),
    ("/tiles/t/density/0/0/0?fmt=bmp", 400), ("/tiles/t/density/1/2", 404),
    ("/tiles/t/density/a/b/c", 400),
])
def test_tile_error_statuses(tiled, path, want):
    answers = [tiled[P.name][2].request("GET", path) for P in BOTH]
    _same(*answers)
    assert answers[1][0] == want


def test_visibility_labeled_schema_narrowed_auths_403():
    outs = []
    for P in BOTH:
        sec, cache = _mod(P, "security"), _mod(P, "cache")
        sft = P.pkg.FeatureType.from_spec("t", SPEC + ",vis:String")
        sft.user_data[sec.VIS_FIELD_KEY] = "vis"
        ds = P.pkg.DataStore(tile=64, auths=("admin", "user"), metrics=P.metrics.MetricsRegistry(),
                             cache=cache.CacheConfig(max_bytes=1 << 22), **P.kw)
        ds.create_schema(sft)
        ds.write("t", P.pkg.FeatureCollection.from_columns(
            sft, ["a", "b"], {"name": np.array(["x", "y"]), "dtg": np.full(2, T0, dtype=np.int64),
                              "geom": (np.array([1.0, 2.0]), np.array([1.0, 2.0])),
                              "vis": np.array(["admin", "user"])}))
        with ds.serve(port=0) as srv:
            c = _client(P, srv.url)
            assert c.tile("t", "density", 0, 0, 0)[0] == 200
            outs.append(c.request("GET", "/tiles/t/density/0/0/0",
                                  headers={"X-Geomesa-Auths": "user"}))
            assert outs[-1][0] == 403
        ds.close()
    _same(*outs)


def test_tile_latency_histogram_records():
    for P in BOTH:
        ds = _tile_store(P, n=50)
        with ds.serve(port=0) as srv:
            c = _client(P, srv.url)
            c.tile("t", "heat", 1, 0, 0)
            _st, h, _b = c.tile("t", "heat", 1, 0, 0)
            c.tile("t", "heat", 1, 0, 0, etag=h["ETag"])
            text = c.metrics_text()
            assert "geomesa_tiles_fetch_seconds_bucket" in text
            assert "geomesa_tiles_served 2" in text
        ds.close()


def test_tenants_report_equal_apart_from_times():
    reps = []
    for P in BOTH:
        ds = _store(P, n=50)
        with ds.serve(port=0) as srv:
            for tenant in ("a", "b", "a"):
                _client(P, srv.url, tenant=tenant).query("t", cql=Q, limit=2)
            reps.append(_strip_times(_client(P, srv.url).tenants()))
        ds.close()
    assert reps[0] == reps[1]


def test_close_leaves_no_serve_thread():
    for P in BOTH:
        ds = _store(P, n=20)
        srv = ds.serve(port=0)
        thread, sched = srv._thread, ds.scheduler
        assert thread.name == "geomesa-serve" and thread.is_alive()
        assert ds.serve(port=0) is srv  # idempotent while open
        ds.close()
        assert srv.closed and sched.closed and not thread.is_alive()
        assert not srv.ops.recorder._thread or not srv.ops.recorder._thread.is_alive()
        ds.close()  # idempotent
