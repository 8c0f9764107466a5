"""The data plane: the network-facing query and ingest service.

The port's copy of geomesa_tpu/serving/http.py.
:meth:`DataStore.serve(port=...) <geomesa_tpu_torch.datastore.DataStore.serve>`
mounts a :class:`DataServer`, a threaded HTTP front end, over the
micro-batch :class:`~geomesa_tpu_torch.serving.scheduler.QueryScheduler`,
so remote callers get the fusion, caching and shedding in-process callers
get, plus what only a network boundary needs:

- **query endpoints** (``GET /query/<type>``) returning GeoJSON or a
  streamed Arrow IPC stream, in paged chunks (``geomesa.serve.page.rows``
  rows per chunk), so one big result never head-of-line-blocks the
  socket; byte for byte the in-process exporters' output, since the
  server composes the same per-feature and per-batch serializers that
  ``io/exporters.py`` and ``io/arrow.py`` use;
- **a streaming ingest endpoint** (``POST /ingest/<type>``) whose 200
  acknowledgment rides :meth:`LambdaStore.write
  <geomesa_tpu_torch.streaming.store.LambdaStore.write>`'s WAL path: on a
  LambdaStore with a WAL under ``sync=always`` the network ack is the
  durability guarantee;
- **admission control, never silent queueing**: queries are submitted
  non-blocking; a full shared queue or a tenant over its quota sheds with
  **429 + Retry-After** (``geomesa.serve.retry.after.ms``) instead of
  parking the connection;
- **multi-tenant fairness**: each request resolves to a tenant (the
  ``X-Geomesa-Tenant`` header, else its sorted auths) and rides that
  tenant's quota, DRR weight, accounting and SLO window
  (serving/tenancy.py); ``GET /tenants`` serves the registry report;
- **per-client auths**: ``X-Geomesa-Auths`` must be a subset of the
  serving process's own authorizations (403 otherwise), and a narrower
  set post-masks results through
  :func:`~geomesa_tpu_torch.security.visibility_mask`;
- **replica awareness**: mounted on a
  :class:`~geomesa_tpu_torch.streaming.replica.ReplicaStore`, writes
  answer 403 with the leader's address in ``X-Geomesa-Leader``, and reads
  honor an ``X-Geomesa-Max-Staleness-Ms`` bound (a read the watermark
  cannot prove fresh enough answers 503 + Retry-After);
- **the ops plane on the same port**: the
  :class:`~geomesa_tpu_torch.obs.ops.OpsRoutes` table mounts beside the
  data routes, so one listener serves ``/metrics``, ``/health``,
  ``/stats`` and the debug surfaces too;
- **live map tiles** (``GET /tiles/<type>/<kind>/{z}/{x}/{y}``):
  precomposed density, count and heat tiles off the
  :class:`~geomesa_tpu_torch.tiles.TilePyramid`, as deterministic PNG or
  raw-count Arrow, with generation-derived ETags; an ``If-None-Match``
  that still matches answers **304** with no aggregation or render work
  (counted, ``geomesa.tiles.not_modified``).

Status codes: 200 served or acked, 304 tile ETag still valid, 400
malformed request (counted, ``geomesa.serve.badrequest``; a hostile body
never tracebacks a worker thread), 403 auths or leader, 404 unknown type
or path, 411 no Content-Length, 413 body over
``geomesa.serve.max.body.bytes``, 429 shed (Retry-After set), 503
staleness bound unmet (Retry-After set), 504 in-flight query deadline.
"""

from __future__ import annotations

import json
import threading
from http.client import HTTPConnection, HTTPException
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, quote, urlparse

import numpy as np

from geomesa_tpu_torch import conf
from geomesa_tpu_torch.serving.scheduler import ServingRejected
from geomesa_tpu_torch.serving.tenancy import TenantRegistry

GEOJSON_CTYPE = "application/geo+json"
ARROW_CTYPE = "application/vnd.apache.arrow.stream"

#: request headers the data plane reads (the client helper sets them)
AUTHS_HEADER = "X-Geomesa-Auths"
TENANT_HEADER = "X-Geomesa-Tenant"
STALENESS_HEADER = "X-Geomesa-Max-Staleness-Ms"
LEADER_HEADER = "X-Geomesa-Leader"
ROWS_HEADER = "X-Geomesa-Rows"


class DataServer:
    """One network listener over a served store.

    ``store`` may be a :class:`~geomesa_tpu_torch.datastore.DataStore`, a
    :class:`~geomesa_tpu_torch.streaming.store.LambdaStore` (ingest acks
    become WAL-durable), or a
    :class:`~geomesa_tpu_torch.streaming.replica.ReplicaStore` (read-only
    until promoted; ``leader_url`` is advertised on refused writes).
    Attaches (or reuses) the store's scheduler and wires a
    :class:`~geomesa_tpu_torch.serving.tenancy.TenantRegistry` into it."""

    #: the registry behind /tenants; bound to the scheduler's in __init__
    tenants: "TenantRegistry | None" = None

    def __init__(self, store, host: "str | None" = None, port: int = 0,
                 config=None, tenants: "TenantRegistry | None" = None,
                 leader_url: "str | None" = None,
                 page_rows: "int | None" = None,
                 max_body_bytes: "int | None" = None,
                 retry_after_ms: "float | None" = None, audit=None):
        from geomesa_tpu_torch.metrics import resolve
        from geomesa_tpu_torch.obs.ops import OpsRoutes

        self.store = store
        # unwrap the tiers: replica -> lambda -> cold DataStore. The
        # cold store owns schemas, metrics and the scheduler thread.
        self.replica = store if hasattr(store, "staleness_ms") else None
        base = self.replica.store if self.replica is not None else store
        self.lam = base if hasattr(base, "cold") else None
        self.cold = self.lam.cold if self.lam is not None else base
        self.sched = store.serve(config)
        if self.sched.tenants is None:
            self.sched.tenants = (
                tenants if tenants is not None
                else TenantRegistry(metrics=getattr(self.cold, "metrics", None))
            )
        self.tenants = self.sched.tenants
        self.metrics = resolve(getattr(self.cold, "metrics", None))
        # the tile pyramid mounts over the cold store (tiles aggregate
        # committed state; hot-tier writes bump the shared generations,
        # so flushed rows appear as soon as they fold in). Built
        # eagerly: handler threads must never race a lazy init.
        from geomesa_tpu_torch.tiles import TilePyramid

        self.tiles = TilePyramid(self.cold, metrics=self.metrics)
        self.ops = OpsRoutes(self.cold, lam=self.lam, audit=audit)
        self.leader_url = leader_url
        self.host = host if host is not None else str(conf.SERVE_HOST.get())
        self.page_rows = int(
            page_rows if page_rows is not None else conf.SERVE_PAGE_ROWS.get()
        )
        self.max_body_bytes = int(
            max_body_bytes if max_body_bytes is not None
            else conf.SERVE_MAX_BODY_BYTES.get()
        )
        self.retry_after_s = float(
            retry_after_ms if retry_after_ms is not None
            else conf.SERVE_RETRY_AFTER_MS.get()
        ) / 1e3
        # pyarrow's first import must not happen on a handler thread: with
        # torch loaded, a first import there can crash the process. Where
        # it is installed, it imports here (the Arrow formats answer 501
        # where it is not)
        try:
            import pyarrow  # noqa: F401
        except ImportError:
            pass
        self._httpd = _Httpd((self.host, int(port)), _handler_class(self))
        self._thread: "threading.Thread | None" = None
        self._closed = False

    # -- lifecycle --------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def closed(self) -> bool:
        return self._closed

    def start(self) -> "DataServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="geomesa-serve",
                daemon=True,
            )
            self._thread.start()
            self.ops.recorder.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting, close the listening socket, join the serve
        thread bounded, stop the ops telemetry sampler. The scheduler
        stays attached to the store (its lifecycle belongs to
        ``store.close()``). Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.ops.recorder.stop(timeout)

    def __enter__(self) -> "DataServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- identity ---------------------------------------------------------
    def _identity(self, headers):
        """Resolve (auths, tenant, error) for one request. ``auths`` is
        None when the request carries no auths header (no narrowing);
        the error triple is a ready 403 when the requested auths exceed
        the serving process's own."""
        raw = headers.get(AUTHS_HEADER)
        req_auths = None
        if raw is not None:
            req_auths = frozenset(
                a.strip() for a in str(raw).split(",") if a.strip()
            )
        store_auths = getattr(self.cold, "auths", None)
        if req_auths and store_auths is not None:
            extra = req_auths - frozenset(str(a) for a in store_auths)
            if extra:
                return None, None, self._client_error(
                    403, f"auths not held by this server: {sorted(extra)}"
                )
        tenant = TenantRegistry.tenant_of(
            req_auths, explicit=headers.get(TENANT_HEADER)
        )
        return req_auths, tenant, None

    def _client_error(self, status: int, message: str, retry_after=None,
                      headers: "dict | None" = None):
        self.metrics.counter("geomesa.serve.badrequest")
        extra = dict(headers or {})
        if retry_after is not None:
            extra["Retry-After"] = f"{max(float(retry_after), 0.0):.3f}"
        return status, "application/json", json.dumps(
            {"error": message}
        ), extra

    # -- GET --------------------------------------------------------------
    def handle_get(self, path: str, query: dict, headers):
        """Route one GET. Returns ``(status, content type, payload,
        extra headers)`` where payload is str/bytes or a generator of
        byte chunks (streamed with chunked transfer framing)."""
        self.metrics.counter("geomesa.serve.requests")
        if path in self.ops.PATHS:
            code, ctype, payload = self.ops.handle(path, query)
            return code, ctype, payload, {}
        if path == "/tenants":
            return 200, "application/json", json.dumps(
                self.tenants.report(), default=str
            ), {}
        if path.startswith("/query/"):
            return self._query(path[len("/query/"):], query, headers)
        if path.startswith("/tiles/"):
            return self._tile(path[len("/tiles/"):], query, headers)
        return self._client_error(404, f"unknown path {path!r}")

    def _tile(self, rest: str, query: dict, headers):
        """``/tiles/<type>/<kind>/<z>/<x>/<y>`` — one precomposed tile.

        ``fmt=png`` (default) renders the grid ;
        ``fmt=arrow`` returns the raw float64 count grid as one Arrow
        IPC stream (kind-independent — kinds only differ in rendering).
        ``mode=fresh`` bypasses the pyramid and re-aggregates from
        scratch: the serving-time bit-identity oracle.
        """
        import time as _time

        from geomesa_tpu_torch.security import VIS_FIELD_KEY
        from geomesa_tpu_torch.tiles import KINDS, render

        t0 = _time.perf_counter()
        parts = rest.split("/")
        if len(parts) != 5:
            return self._client_error(
                404, "tile path is /tiles/<type>/<kind>/<z>/<x>/<y>"
            )
        type_name, kind = parts[0], parts[1]
        req_auths, _tenant, err = self._identity(headers)
        if err is not None:
            return err
        if kind not in KINDS:
            return self._client_error(400, f"unknown tile kind {kind!r}")
        try:
            z, x, y = (int(p) for p in parts[2:])
        except ValueError:
            return self._client_error(400, "tile z/x/y must be integers")
        fmt = (_first(query, "fmt") or "png").lower()
        if fmt not in ("png", "arrow"):
            return self._client_error(400, f"unknown fmt {fmt!r}")
        mode = _first(query, "mode")
        try:
            sft = self._schema(type_name)
        except KeyError:
            return self._client_error(404, f"unknown type {type_name!r}")
        if req_auths is not None and sft.user_data.get(VIS_FIELD_KEY):
            # tiles are whole-store aggregates; an auth-narrowed viewer
            # of a visibility-labeled schema must not read densities it
            # could not read row-by-row
            return self._client_error(
                403, "tiles over a visibility-labeled schema are not "
                     "auth-maskable; query the rows instead"
            )
        max_age = self.tiles.conf.max_age_s
        cc = (
            f"public, max-age={int(max_age)}" if max_age > 0 else "no-cache"
        )
        inm = (headers.get("If-None-Match") or "").strip()
        if inm and mode != "fresh":
            # conditional GET: a still-valid cached tile whose
            # generation tick matches answers 304 with ZERO aggregation
            # or render work (peek is read-only — no counters, no drops)
            g = self.tiles.peek(type_name, z, x, y)
            if g is not None and inm == f'"t{g.tick}"':
                self.metrics.counter("geomesa.tiles.not_modified")
                self.metrics.observe(
                    "geomesa.tiles.fetch", _time.perf_counter() - t0
                )
                return 304, "image/png", b"", {
                    "ETag": inm, "Cache-Control": cc,
                }
        try:
            if mode == "fresh":
                g = self.tiles.fresh(type_name, z, x, y)
            else:
                g = self.tiles.fetch(type_name, z, x, y)
        except KeyError:
            return self._client_error(404, f"unknown type {type_name!r}")
        except ValueError as e:
            return self._client_error(400, str(e))
        extra = {"ETag": f'"t{g.tick}"', "Cache-Control": cc}
        if fmt == "arrow":
            try:
                body, ctype = _grid_arrow(g.grid), ARROW_CTYPE
            except RuntimeError as e:  # pyarrow not installed
                return self._client_error(501, str(e))
        else:
            body, ctype = render(kind, g.grid), "image/png"
        self.metrics.observe("geomesa.tiles.fetch", _time.perf_counter() - t0)
        self.metrics.counter("geomesa.tiles.served")
        return 200, ctype, body, extra

    def _query(self, type_name: str, query: dict, headers):
        from geomesa_tpu_torch.planning.errors import QueryGuardError, QueryTimeout
        from geomesa_tpu_torch.security import VIS_FIELD_KEY, VisibilityError
        from geomesa_tpu_torch.streaming.replica import StaleRead

        req_auths, tenant, err = self._identity(headers)
        if err is not None:
            return err
        try:
            sft = self._schema(type_name)
        except KeyError:
            return self._client_error(404, f"unknown type {type_name!r}")
        cql = _first(query, "cql") or "INCLUDE"
        fmt = (_first(query, "fmt") or "geojson").lower()
        if fmt not in ("geojson", "arrow"):
            return self._client_error(400, f"unknown fmt {fmt!r}")
        try:
            limit = _int(query, "limit")
            offset = _int(query, "offset")
            page_rows = _int(query, "page_rows") or self.page_rows
            sort_by = _first(query, "sort_by")
            staleness = headers.get(STALENESS_HEADER)
            staleness = float(staleness) if staleness is not None else None
        except ValueError as e:
            return self._client_error(400, f"bad parameter: {e}")
        hints = None
        if offset is not None or sort_by is not None:
            from geomesa_tpu_torch.planning.hints import QueryHints

            hints = QueryHints(sort_by=sort_by, offset=offset)
        try:
            fc = self._execute(
                type_name, cql, limit, hints, tenant, staleness
            )
        except StaleRead as e:
            return self._client_error(
                503, str(e), retry_after=self.retry_after_s
            )
        except ServingRejected as e:
            return self._client_error(
                429, str(e), retry_after=self.retry_after_s
            )
        except QueryTimeout as e:
            if "shed before dispatch" in str(e):
                return self._client_error(
                    429, str(e), retry_after=self.retry_after_s
                )
            return self._client_error(504, str(e))
        except (ValueError, KeyError, QueryGuardError, VisibilityError) as e:
            # plan-time rejections (ECQL parse, guards, visibility
            # expressions): the client's fault, counted, never a 500
            return self._client_error(400, f"{type(e).__name__}: {e}")
        if req_auths is not None:
            vis_field = sft.user_data.get(VIS_FIELD_KEY)
            if vis_field and vis_field in fc.columns:
                from geomesa_tpu_torch.security import visibility_mask

                m = visibility_mask(
                    np.asarray(fc.columns[vis_field]), req_auths
                )
                if not m.all():
                    fc = fc.mask(m)
        extra = {ROWS_HEADER: str(len(fc))}
        if fmt == "arrow":
            try:
                return 200, ARROW_CTYPE, _arrow_chunks(fc, page_rows), extra
            except RuntimeError as e:  # pyarrow not installed
                return self._client_error(501, str(e))
        return 200, GEOJSON_CTYPE, _geojson_chunks(fc, page_rows), extra

    def _schema(self, type_name: str):
        if self.lam is not None:
            if type_name != self.lam.type_name:
                raise KeyError(type_name)
            return self.cold.get_schema(type_name)
        return self.cold.get_schema(type_name)

    def _execute(self, type_name, cql, limit, hints, tenant, staleness):
        if self.replica is not None:
            fc = self.replica.query(
                cql, hints=hints, max_staleness_ms=staleness,
                tenant=tenant, block=False,
            )
        elif self.lam is not None:
            fc = self.lam.query(cql, hints=hints, tenant=tenant, block=False)
        else:
            fc = self.sched.submit(
                type_name, cql, limit=limit, hints=hints, block=False,
                tenant=tenant,
            ).result()
        if limit is not None and len(fc) > limit:
            fc = fc.take(np.arange(limit))
        return fc

    # -- POST -------------------------------------------------------------
    def handle_post(self, path: str, headers, rfile):
        """Route one POST (ingest). Returns the same quadruple as
        :meth:`handle_get`; reads at most Content-Length bytes."""
        self.metrics.counter("geomesa.serve.requests")
        if not path.startswith("/ingest/"):
            return self._client_error(404, f"unknown path {path!r}")
        type_name = path[len("/ingest/"):]
        if self.replica is not None and not self.replica.writable:
            extra = {}
            if self.leader_url:
                extra[LEADER_HEADER] = self.leader_url
            return self._client_error(
                403, "this replica is a follower — write to the leader",
                headers=extra,
            )
        _auths, _tenant, err = self._identity(headers)
        if err is not None:
            return err
        try:
            length = int(headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        if length <= 0:
            return self._client_error(411, "Content-Length required")
        if length > self.max_body_bytes:
            return self._client_error(
                413, f"body {length} over the "
                f"{self.max_body_bytes}-byte bound"
            )
        body = rfile.read(length)
        try:
            fc = self._parse_ingest(type_name, body, headers)
        except KeyError:
            return self._client_error(404, f"unknown type {type_name!r}")
        except Exception as e:
            # a hostile payload (torn JSON, bad Arrow framing, invalid
            # visibility expression, unsupported geometry) must answer a
            # counted 400, never traceback the worker thread
            return self._client_error(400, f"{type(e).__name__}: {e}")
        try:
            if self.lam is not None:
                rows = fc.to_rows()
                ids = [r.pop("__id__") for r in rows]
                n = self.lam.write(rows, ids=ids)
                durable = self.lam.wal is not None
            else:
                n = self.cold.write(type_name, fc)
                durable = False
        except ValueError as e:  # duplicate ids and kin: the batch's fault
            return self._client_error(400, f"{type(e).__name__}: {e}")
        self.metrics.counter("geomesa.serve.ingested", n)
        return 200, "application/json", json.dumps(
            {"acked": int(n), "durable": bool(durable), "type": type_name}
        ), {}

    def _parse_ingest(self, type_name: str, body: bytes, headers):
        from geomesa_tpu_torch import security

        sft = self._schema(type_name)
        ctype = (headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == ARROW_CTYPE:
            from geomesa_tpu_torch.io.arrow import read_arrow

            fc = read_arrow(body, sft=sft)
        else:
            from geomesa_tpu_torch.io.geojson import read_geojson

            fc = read_geojson(body, type_name=type_name, sft=sft)
        vis_field = sft.user_data.get(security.VIS_FIELD_KEY)
        if vis_field and vis_field in fc.columns:
            for label in {
                v for v in np.asarray(fc.columns[vis_field]).tolist()
                if v is not None
            }:
                security.validate(str(label))
        return fc


# -- streamed serializers (bit-identical to the one-shot exporters) -------

def _geojson_chunks(fc, page_rows: int):
    """Byte chunks whose concatenation equals the in-process GeoJSON
    export exactly: same per-feature serializer, same separators, same
    optional trailing crs member (io/exporters.py)."""
    from geomesa_tpu_torch.io.exporters import geojson_crs, geojson_features

    def gen():
        yield b'{"type": "FeatureCollection", "features": ['
        buf: list = []
        for i, feat in enumerate(geojson_features(fc)):
            buf.append(("" if i == 0 else ", ") + json.dumps(feat))
            if len(buf) >= max(int(page_rows), 1):
                yield "".join(buf).encode()
                buf = []
        tail = "".join(buf) + "]"
        crs = geojson_crs(fc)
        if crs is not None:
            tail += ', "crs": ' + json.dumps(crs)
        yield (tail + "}").encode()

    return gen()


class _ArrowSink:
    """A write-only file shim collecting the IPC writer's output so the
    generator can yield it batch-by-batch."""

    closed = False

    def __init__(self):
        self.chunks: list = []

    def write(self, b) -> int:
        self.chunks.append(bytes(b))
        return len(b)

    def flush(self) -> None:
        pass

    def drain(self) -> bytes:
        out, self.chunks = b"".join(self.chunks), []
        return out


def _arrow_chunks(fc, page_rows: int):
    """Byte chunks forming ONE Arrow IPC stream, one record batch per
    ``page_rows`` rows — concatenated, bit-identical to
    :func:`geomesa_tpu_torch.io.arrow.arrow_stream` with the same batch rows
    (same table construction, same writer)."""
    from geomesa_tpu_torch.io.arrow import _pa, to_arrow_table

    _pa()
    import pyarrow.ipc as ipc

    table = to_arrow_table(fc)

    def gen():
        sink = _ArrowSink()
        with ipc.new_stream(sink, table.schema) as writer:
            if table.num_rows:
                for batch in table.to_batches(
                    max_chunksize=max(int(page_rows), 1)
                ):
                    writer.write_batch(batch)
                    yield sink.drain()
        tail = sink.drain()
        if tail:
            yield tail

    return gen()


def _grid_arrow(grid) -> bytes:
    """One tile grid as one deterministic Arrow IPC stream: a single
    float64 ``count`` column in row-major order, grid shape in the
    schema metadata. Raises RuntimeError when pyarrow is missing (the
    route answers 501, same as the query path's arrow fmt)."""
    from geomesa_tpu_torch.io.arrow import _pa

    _pa()
    import pyarrow as pa
    import pyarrow.ipc as ipc

    h, w = grid.shape
    table = pa.table(
        {"count": pa.array(grid.reshape(-1), type=pa.float64())}
    ).replace_schema_metadata({"rows": str(h), "cols": str(w)})
    sink = pa.BufferOutputStream()
    with ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return sink.getvalue().to_pybytes()


# -- the HTTP plumbing ----------------------------------------------------

class _Httpd(ThreadingHTTPServer):
    # reuse-addr: close-then-reopen on one port inside a test run must
    # not trip over the old socket's TIME_WAIT (same fix as obs/ops.py)
    allow_reuse_address = True
    daemon_threads = True


def _handler_class(server: DataServer):
    """A BaseHTTPRequestHandler bound to one DataServer (closure, not a
    server attribute, so two mounted stores never share state)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked responses need 1.1

        def _respond(self, result) -> None:
            code, ctype, payload, extra = result
            try:
                if hasattr(payload, "__next__"):  # a chunk generator
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    for k, v in extra.items():
                        self.send_header(k, v)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for chunk in payload:
                        if chunk:
                            self.wfile.write(
                                b"%x\r\n%s\r\n" % (len(chunk), chunk)
                            )
                    self.wfile.write(b"0\r\n\r\n")
                    return
                body = payload.encode() if isinstance(payload, str) else payload
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                for k, v in extra.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away mid-response

        def _handle(self, fn) -> None:
            try:
                result = fn()
            except (BrokenPipeError, ConnectionResetError):
                return
            except Exception as e:  # defensive: a worker must not die
                result = server._client_error(
                    500, f"{type(e).__name__}: {e}"
                )
            self._respond(result)

        def do_GET(self):  # noqa: N802 (stdlib naming)
            url = urlparse(self.path)
            self._handle(lambda: server.handle_get(
                url.path, parse_qs(url.query), self.headers
            ))

        def do_POST(self):  # noqa: N802 (stdlib naming)
            url = urlparse(self.path)
            self._handle(lambda: server.handle_post(
                url.path, self.headers, self.rfile
            ))

        def log_message(self, *args) -> None:  # requests stay out of stderr
            pass

    return Handler


def _first(query: dict, key: str):
    vals = query.get(key)
    return vals[0] if vals else None


def _int(query: dict, key: str) -> "int | None":
    v = _first(query, key)
    return int(v) if v is not None else None


# -- the client helper (stdlib only) ---------------------------------------

class ServeError(RuntimeError):
    """A non-2xx data-plane response: carries the status, the decoded
    error body, and the Retry-After seconds when the server set one
    (429 shed / 503 staleness)."""

    def __init__(self, status: int, body: str,
                 retry_after: "float | None" = None,
                 headers: "dict | None" = None):
        super().__init__(f"HTTP {status}: {body}")
        self.status = int(status)
        self.body = body
        self.retry_after = retry_after
        self.headers = dict(headers or {})


class DataClient:
    """A tiny synchronous client for one :class:`DataServer` (stdlib
    ``http.client`` only — importable anywhere the tests run). Default
    is one connection per request (correctness over throughput);
    ``keep_alive=True`` holds one persistent HTTP/1.1 connection —
    faster, but then the instance is single-threaded (hold one client per
    thread). A dead kept-alive socket is reopened and
    the request retried once, for GETs only: a POST whose response was
    lost may have been applied, and silently resending it would
    double-ingest."""

    def __init__(self, url_or_host: str, port: "int | None" = None,
                 timeout: float = 30.0, auths=None,
                 tenant: "str | None" = None, keep_alive: bool = False):
        if port is None:
            parsed = urlparse(url_or_host)
            self.host, self.port = parsed.hostname, int(parsed.port)
        else:
            self.host, self.port = url_or_host, int(port)
        self.timeout = timeout
        self.auths = tuple(auths) if auths else None
        self.tenant = tenant
        self.keep_alive = bool(keep_alive)
        self._conn: "HTTPConnection | None" = None

    def close(self) -> None:
        """Drop the kept-alive connection (no-op otherwise)."""
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "DataClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _headers(self, auths=None, tenant=None, extra=None) -> dict:
        h = dict(extra or {})
        auths = auths if auths is not None else self.auths
        tenant = tenant if tenant is not None else self.tenant
        if auths:
            h[AUTHS_HEADER] = ",".join(str(a) for a in auths)
        if tenant:
            h[TENANT_HEADER] = tenant
        return h

    def request(self, method: str, path: str, body=None,
                headers: "dict | None" = None):
        """One round-trip: returns ``(status, headers dict, body
        bytes)``. Raises nothing on non-2xx — the typed helpers do."""
        if not self.keep_alive:
            conn = HTTPConnection(self.host, self.port, timeout=self.timeout)
            try:
                return self._roundtrip(conn, method, path, body, headers)
            finally:
                conn.close()
        for last in (False, True):
            if self._conn is None:
                self._conn = HTTPConnection(
                    self.host, self.port, timeout=self.timeout
                )
            try:
                return self._roundtrip(self._conn, method, path, body, headers)
            except (OSError, HTTPException):
                self.close()  # the server may have dropped the idle socket
                if last or method != "GET":
                    raise
        raise AssertionError("unreachable")

    @staticmethod
    def _roundtrip(conn, method, path, body, headers):
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), data

    def _checked(self, method, path, body=None, headers=None):
        status, hdrs, data = self.request(
            method, path, body=body, headers=headers
        )
        if status >= 400:
            try:
                msg = json.loads(data).get("error", data.decode())
            except Exception:
                msg = data.decode(errors="replace")
            ra = hdrs.get("Retry-After")
            raise ServeError(
                status, msg,
                retry_after=float(ra) if ra is not None else None,
                headers=hdrs,
            )
        return hdrs, data

    def query(self, type_name: str, cql: "str | None" = None,
              limit: "int | None" = None, fmt: str = "geojson",
              offset: "int | None" = None, sort_by: "str | None" = None,
              page_rows: "int | None" = None, auths=None,
              tenant: "str | None" = None,
              max_staleness_ms: "float | None" = None):
        """Run a query: GeoJSON format returns the parsed dict, Arrow
        format the raw IPC stream bytes. Raises :class:`ServeError` on
        any non-2xx (``.retry_after`` set on 429/503)."""
        params = []
        if cql is not None:
            params.append("cql=" + quote(cql))
        for k, v in (("limit", limit), ("offset", offset),
                     ("page_rows", page_rows)):
            if v is not None:
                params.append(f"{k}={int(v)}")
        if sort_by is not None:
            params.append("sort_by=" + quote(sort_by))
        params.append(f"fmt={fmt}")
        path = f"/query/{quote(type_name)}?" + "&".join(params)
        extra = {}
        if max_staleness_ms is not None:
            extra[STALENESS_HEADER] = f"{float(max_staleness_ms):g}"
        _, data = self._checked(
            "GET", path, headers=self._headers(auths, tenant, extra)
        )
        return data if fmt == "arrow" else json.loads(data)

    def ingest(self, type_name: str, payload, fmt: str = "geojson",
               auths=None, tenant: "str | None" = None) -> dict:
        """POST one batch: ``payload`` is a GeoJSON FeatureCollection
        dict/str, or Arrow IPC bytes with ``fmt='arrow'``. Returns the
        ack dict (``acked`` rows, ``durable`` flag)."""
        if fmt == "arrow":
            body, ctype = payload, ARROW_CTYPE
        else:
            body = (
                payload if isinstance(payload, (str, bytes))
                else json.dumps(payload)
            )
            ctype = GEOJSON_CTYPE
        if isinstance(body, str):
            body = body.encode()
        headers = self._headers(auths, tenant, {"Content-Type": ctype})
        _, data = self._checked(
            "POST", f"/ingest/{quote(type_name)}", body=body,
            headers=headers,
        )
        return json.loads(data)

    def tile(self, type_name: str, kind: str, z: int, x: int, y: int,
             fmt: str = "png", mode: "str | None" = None,
             etag: "str | None" = None, auths=None,
             tenant: "str | None" = None):
        """Fetch one slippy-map tile: returns ``(status, headers dict,
        body bytes)`` — 200 with PNG/Arrow bytes, or 304 with an empty
        body when ``etag`` (a previous response's ETag header) still
        matches. Raises :class:`ServeError` on any 4xx/5xx."""
        path = (
            f"/tiles/{quote(type_name)}/{quote(kind)}"
            f"/{int(z)}/{int(x)}/{int(y)}?fmt={fmt}"
        )
        if mode is not None:
            path += f"&mode={quote(mode)}"
        extra = {}
        if etag is not None:
            extra["If-None-Match"] = etag
        status, hdrs, data = self.request(
            "GET", path, headers=self._headers(auths, tenant, extra)
        )
        if status >= 400:
            try:
                msg = json.loads(data).get("error", data.decode())
            except Exception:
                msg = data.decode(errors="replace")
            raise ServeError(status, msg, headers=hdrs)
        return status, hdrs, data

    def tenants(self) -> dict:
        _, data = self._checked("GET", "/tenants")
        return json.loads(data)

    def health(self) -> dict:
        status, _, data = self.request("GET", "/health")
        out = json.loads(data)
        out["http_status"] = status
        return out

    def stats(self) -> dict:
        _, data = self._checked("GET", "/stats")
        return json.loads(data)

    def metrics_text(self) -> str:
        _, data = self._checked("GET", "/metrics")
        return data.decode()
