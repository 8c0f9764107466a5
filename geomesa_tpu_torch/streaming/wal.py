"""Write-ahead log under the streaming hot tier.

The port's copy of geomesa_tpu/streaming/wal.py; segment files are
byte-identical to the JAX package's for the same record sequence and
config, and each package replays the other's log. Every row acknowledged
by ``LambdaStore.write`` is appended to a segmented, checksummed log
BEFORE it is acknowledged; recovery replays the log over the last durable
checkpoint.

On-disk layout (default ``<store root>/_wal/``):

    wal-00000000000000000000.log     # segment named by its first seqno
    wal-00000000000000000412.log     # ... rotated at segment.bytes

Record framing (io/varint.py):

    uvarint(len(payload)) | payload | blake2b-8(payload)

The payload is one compact JSON object ``{"s": seqno, "k": kind, ...}``
with kind one of ``u`` (upsert batch: ids + rows), ``d`` (delete), ``x``
(expiry sweep), ``w`` (flush watermark: the ids one hot->cold publish
covered, so replay re-folds exactly what the live store folded), ``s``
(standing-query subscription registration or removal; checkpoints re-log
the live set above their cover), ``t`` (a leadership term bump, the
replication fence), ``c`` (checkpoint watermark: the cold store was
durably saved; the ONLY record that retires segments, and it carries the
current term). Geometry values serialize as WKB (bit-exact), everything
else as tagged JSON.

Sync policy (``geomesa.stream.wal.sync``):

- ``always``   — every append is fsync'd before it is acknowledged, with
  group commit: producers that land in the buffer while another
  producer's fsync is in flight are covered by that one fsync;
- ``interval`` — appends buffer in-process and fsync at most every
  ``geomesa.stream.wal.sync.interval.ms`` (a daemon thread syncs an idle
  producer's tail); a hard kill loses at most the unsynced window;
- ``off``      — never fsync (the OS decides).

Segments RETIRE only at a checkpoint watermark: a flush publishes into the
in-process cold tier, which is durable only once ``persist.save`` commits
(``LambdaStore.checkpoint``).

Recovery (``LambdaStore.recover`` / :meth:`WriteAheadLog.replay`): a torn
tail on the last segment (a frame cut mid-write) is truncated; a
checksum-mismatched record quarantines the rest of its segment into
``_quarantine/_wal/`` with a ``report.json`` record, and later segments
are quarantined whole as ``orphaned``: replay never rides over a hole.
Every step is a fault point: ``stream.wal.append`` / ``stream.wal.sync`` /
``stream.wal.rotate`` / ``stream.wal.truncate`` / ``stream.wal.replay``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from geomesa_tpu_torch import fault
from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.io.varint import append_uvarint, read_uvarint
from geomesa_tpu_torch.obs.trace import span as _ospan

_DIGEST_BYTES = 8
_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"
# sync=off/interval: flush the in-process buffer to the fd past this
# many bytes even without an fsync — a process kill only loses the
# APP buffer (written-not-synced bytes survive in the page cache)
_FLUSH_BYTES = 256 << 10


class WalError(RuntimeError):
    """The log is closed/crashed or an append cannot be encoded."""


@dataclass
class WalConfig:
    """WAL knobs; ``from_properties`` resolves each from the typed
    property tier (geomesa_tpu_torch.conf)."""

    sync: str = "always"            # always | interval | off
    sync_interval_ms: float = 50.0  # fsync cadence under sync=interval
    segment_bytes: int = 64 << 20   # rotate the active segment past this

    def __post_init__(self):
        if self.sync not in ("always", "interval", "off"):
            raise ValueError(
                f"geomesa.stream.wal.sync must be always|interval|off, "
                f"got {self.sync!r}"
            )

    @staticmethod
    def from_properties() -> "WalConfig":
        from geomesa_tpu_torch import conf

        return WalConfig(
            sync=str(conf.STREAM_WAL_SYNC.get()),
            sync_interval_ms=float(conf.STREAM_WAL_SYNC_INTERVAL_MS.get()),
            segment_bytes=int(conf.STREAM_WAL_SEGMENT_BYTES.get()),
        )


# -- value codec ------------------------------------------------------------
# Row dicts cross the WAL as tagged JSON. Geometries go through WKB —
# struct-packed f64, bit-exact — because replay must rebuild the hot
# tier EXACTLY (WKT's fixed 10-decimal formatting is lossy). A WKT
# *string* handed by the producer stays a string: replay re-parses it
# through the same hot-tier path the original write took.
#
# PERF: the encoder is a ``json.dumps(default=...)`` hook, NOT a
# pre-walk of every row value — plain str/int/float/None values (the
# overwhelming majority) stay on the C serializer path and only
# geometries/numpy scalars/bytes pay a Python call. The point fast path
# packs WKB with one precompiled Struct (to_wkb's generic dispatch was
# a measurable fraction of sustained write cost).

import struct as _struct

_POINT_WKB = _struct.Struct("<BIdd")  # little-endian header + (x, y)


def _enc_json(v):
    """``json.dumps`` default hook for non-native WAL values."""
    if isinstance(v, geo.Point):
        return {"~": "g",
                "v": _POINT_WKB.pack(1, geo.POINT, v.x, v.y).hex()}
    if isinstance(v, geo.Geometry):
        return {"~": "g", "v": geo.to_wkb(v).hex()}
    if isinstance(v, (np.bool_, np.integer, np.floating)):
        return v.item()
    if isinstance(v, (bytes, bytearray)):
        return {"~": "b", "v": bytes(v).hex()}
    if isinstance(v, np.datetime64):
        return {"~": "t", "v": str(np.datetime64(v, "ms"))}
    raise WalError(
        f"cannot WAL-encode a {type(v).__name__} value — supported: "
        "None/bool/int/float/str/bytes, numpy scalars, Geometry"
    )


def _dec_value(v):
    if isinstance(v, dict) and "~" in v:
        tag = v["~"]
        if tag == "g":
            return geo.from_wkb(bytes.fromhex(v["v"]))
        if tag == "b":
            return bytes.fromhex(v["v"])
        if tag == "t":
            return np.datetime64(v["v"], "ms")
        raise WalError(f"unknown WAL value tag {tag!r}")
    return v


def decode_rows(rows: Sequence) -> list:
    return [{k: _dec_value(v) for k, v in r.items()} for r in rows]


def pack_upsert(rows: Sequence) -> dict:
    """Batch-columnar upsert body for UNIFORM batches (every row shares
    one key set): point-geometry columns pack into ONE hex f64 blob and
    the other columns become plain json lists on the C serializer path —
    ~2x cheaper per acknowledged row than a json object per row, which
    is the difference between the WAL fitting the 15% overhead budget
    and not. Mixed-shape batches fall back to per-row dicts."""
    if not rows:
        return {"rows": []}
    first = rows[0]
    nk = len(first)
    try:
        if any(len(r) != nk for r in rows):
            raise KeyError("ragged batch")
        cols: dict = {}
        pts: dict = {}
        for k in first:
            vals = [r[k] for r in rows]  # KeyError on a missing key
            if isinstance(vals[0], geo.Point) and all(
                type(v) is geo.Point for v in vals
            ):
                a = np.empty((len(vals), 2), np.float64)
                a[:, 0] = [v.x for v in vals]
                a[:, 1] = [v.y for v in vals]
                pts[k] = a.tobytes().hex()
            else:
                cols[k] = vals
        return {"cols": cols, "pts": pts, "n": len(rows)}
    except KeyError:
        return {"rows": list(rows)}


def unpack_upsert(rec: dict) -> list:
    """Inverse of :func:`pack_upsert` (the replay side)."""
    return unpack_upsert_xy(rec, None)[0]


def unpack_upsert_xy(rec: dict, geom_field: "str | None") -> tuple:
    """``(rows, xy)``: :func:`unpack_upsert` plus the geometry column's
    raw decoded [n, 2] f64 coordinates when the batch packed it columnar
    — the replay bulk path (``StreamingFeatureCache.replay_upsert``)
    feeds them straight into the vectorized grid-index insert instead of
    re-reading a million Point attributes. ``xy`` is None for per-row
    (mixed-shape) records or when the geometry column was not packed."""
    if "rows" in rec:
        return decode_rows(rec["rows"]), None
    n = int(rec["n"])
    # tagged values are always dicts — a column with none (plain
    # strings/numbers, the common case) skips the per-value decode calls
    # and keeps the json-decoded list as-is
    cols = {
        k: (
            [_dec_value(v) for v in vs]
            if any(type(v) is dict for v in vs) else vs
        )
        for k, vs in rec["cols"].items()
    }
    xy = None
    for k, blob in rec.get("pts", {}).items():
        a = np.frombuffer(bytes.fromhex(blob), np.float64).reshape(-1, 2)
        if k == geom_field:
            xy = a
        # flat per-axis tolist() feeds the million Point constructors
        # native floats without allocating an [x, y] list per row
        xs = a[:, 0].tolist()
        ys = a[:, 1].tolist()
        cols[k] = [geo.Point(px, py) for px, py in zip(xs, ys)]
    return [{k: vs[i] for k, vs in cols.items()} for i in range(n)], xy


def _frame(payload: bytes) -> bytes:
    out = bytearray()
    append_uvarint(out, len(payload))
    out += payload
    out += hashlib.blake2b(payload, digest_size=_DIGEST_BYTES).digest()
    return bytes(out)


# frames past this length are treated as corruption, not a torn tail: a
# bit flip in the length varint can claim an absurd extent, and reading
# it as "torn" would silently truncate intact later records. (A flip
# that keeps the claimed frame INSIDE the file is always caught by the
# digest; only a flip overshooting EOF is ambiguous with a real torn
# tail — this cap removes the wildly-implausible half of that
# ambiguity.)
_MAX_RECORD_BYTES = 1 << 30


def _parse_frames(data: bytes):
    """(records, bad) where records is a list of decoded payload dicts
    and ``bad`` is None or ``(offset, reason, detail)`` — ``torn`` for a
    frame cut short (the crash artifact), ``checksum`` for a record
    whose digest (or JSON, or framing) does not verify."""
    records: list[dict] = []
    pos = 0
    n = len(data)
    while pos < n:
        start = pos
        try:
            length, pos = read_uvarint(data, pos)
        except IndexError:
            return records, (start, "torn", "frame length cut short")
        if length > _MAX_RECORD_BYTES:
            return records, (
                start, "checksum", f"implausible frame length {length}"
            )
        end = pos + length + _DIGEST_BYTES
        if end > n:
            return records, (start, "torn", "frame payload cut short")
        payload = data[pos : pos + length]
        digest = data[pos + length : end]
        if hashlib.blake2b(payload, digest_size=_DIGEST_BYTES).digest() != digest:
            return records, (
                start, "checksum",
                f"record digest mismatch at byte {start}",
            )
        try:
            rec = json.loads(payload)
        except ValueError as e:
            return records, (start, "checksum", f"undecodable record: {e}")
        records.append(rec)
        pos = end
    return records, None


class WriteAheadLog:
    """One durable, segmented log for one :class:`LambdaStore`'s hot
    tier. Thread-safe: producers append concurrently; ``sync=always``
    group-commits (one fsync covers every record buffered while it was
    in flight)."""

    def __init__(self, wal_dir: str, config: "WalConfig | None" = None,
                 metrics=None, quarantine_root: "str | None" = None):
        from geomesa_tpu_torch.metrics import resolve

        self.dir = str(wal_dir)
        self.config = config if config is not None else WalConfig.from_properties()
        self.metrics = resolve(metrics)
        # quarantine/damage-report root (storage.persist's convention): by
        # default the parent of the wal dir, i.e. the store root when
        # the wal lives at <root>/_wal
        self.quarantine_root = (
            quarantine_root
            if quarantine_root is not None
            else os.path.dirname(os.path.abspath(self.dir)) or "."
        )
        os.makedirs(self.dir, exist_ok=True)
        from geomesa_tpu_torch.lockwitness import witness

        # buffer / seqno / fd state
        self._lock = witness(threading.Lock(), "WriteAheadLog._lock")
        # commit (write+fsync) order
        self._sync_lock = witness(
            threading.Lock(), "WriteAheadLog._sync_lock"
        )
        self._buffer = bytearray()   # guarded-by: _lock
        self._pending = set()        # guarded-by: _lock
        self._closed = False         # guarded-by: _lock
        self._fd: "int | None" = None        # guarded-by: _lock
        self._active_path = ""       # guarded-by: _lock
        self._active_start = 0       # guarded-by: _lock
        self._active_bytes = 0       # guarded-by: _lock
        self._last_seq = -1          # guarded-by: _lock
        self._term = 0               # guarded-by: _lock
        self._synced_seq = -1        # guarded-by: _sync_lock
        self._last_sync_t = time.monotonic()  # guarded-by: _sync_lock
        # fsync'd byte length of the ACTIVE segment — the shipping
        # horizon: a follower only ever receives
        # bytes the leader has made durable, so a leader crash can never
        # leave a follower holding records the restarted leader lost
        self._durable_bytes = 0      # guarded-by: _sync_lock
        self.damage: list = []  # DamageRecords found while scanning
        #: records past the last checkpoint cover exist on disk — the
        #: store must be opened through recover() (replay), not the
        #: plain constructor, or the next checkpoint would cover and
        #: retire acknowledged records whose effects were never applied
        self.needs_recovery = False
        self._open_tail()
        self._stop = threading.Event()
        if self.config.sync == "interval":
            # time-based fsync must not depend on traffic: an idle
            # producer's buffered acknowledged records would otherwise
            # sit unsynced indefinitely, making the documented loss
            # window unbounded instead of ~sync_interval_ms
            threading.Thread(
                target=self._interval_loop, daemon=True,
                name="geomesa-wal-sync",
            ).start()

    def _interval_loop(self) -> None:
        period = max(float(self.config.sync_interval_ms), 1.0) / 1000.0
        while not self._stop.wait(period):
            try:
                if self.synced_seq < self.last_seq:
                    self.sync()
            except WalError:
                return  # closed under us
            except OSError:
                continue  # transient past retries; appends surface errors

    # -- segment bookkeeping ----------------------------------------------
    def _segments(self) -> list[str]:
        """Sorted on-disk segment file names (start-seqno order — the
        zero-padded name IS the sort key)."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(
            n for n in names
            if n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX)
        )

    @staticmethod
    def _seg_start(name: str) -> int:
        return int(name[len(_SEG_PREFIX) : -len(_SEG_SUFFIX)])

    def _seg_path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _open_tail(self) -> None:
        """Open-time positioning: scan the LAST segment for the highest
        intact seqno (truncating a torn tail — the expected crash
        artifact), then continue appending to it. Checksum damage in the
        tail quarantines like replay does."""
        segs = self._segments()
        next_seq = 0
        tail: "tuple[str, int] | None" = None  # (path, start) to reopen
        if segs:
            last = segs[-1]
            path = self._seg_path(last)
            data = self._read_segment(path)
            records, bad = _parse_frames(data)
            if records:
                next_seq = int(records[-1].get("s", -1)) + 1
            else:
                # an empty/unreadable last segment still floors the
                # seqno at its own START (names carry starts): a lone
                # active segment emptied by damage truncation must not
                # reset numbering to 0 — reused seqnos would hide new
                # records below an old checkpoint cover and make a
                # later rotation sort BEFORE this segment
                next_seq = self._seg_start(last)
            if bad is not None:
                offset, reason, detail = bad
                if reason == "torn":
                    self._truncate(path, offset)
                else:
                    self._quarantine_tail(last, data, offset, reason, detail)
            tail = (path, self._seg_start(last))
            # MUTATION records past the last checkpoint cover are
            # UNREPLAYED state: the plain constructor must not continue
            # over them. Flush watermarks ("w") past the cover are
            # benign — the checkpoint's own drain logs one above its
            # cover by design (possibly rotating mid-checkpoint, so a
            # clean store CAN leave a sealed segment behind), and
            # replaying a watermark over an empty hot tier is a no-op.
            # With sealed segments present, the same mutation-kind
            # check runs over ALL records (the rare multi-segment open
            # pays one full scan; damage anywhere is conservatively
            # "needs recovery").
            sealed: list[dict] = []
            clean = bad is None or bad[1] == "torn"
            for s in segs[:-1]:
                rs, b = _parse_frames(
                    self._read_segment(self._seg_path(s))
                )
                sealed.extend(rs)
                if b is not None:
                    clean = False
                    break
            scan = sealed + records  # append order across segments
            cover = -1
            term = 0
            for r in scan:
                if r.get("k") == "c":
                    cover = int(r.get("cover", r.get("s", -1)))
                if r.get("k") in ("t", "c") and "term" in r:
                    term = max(term, int(r["term"]))
            with self._lock:
                self._term = term
            self.needs_recovery = not clean or any(
                int(r.get("s", -1)) > cover
                and r.get("k") in ("u", "d", "x", "s")
                for r in scan
            )
        with self._sync_lock:
            with self._lock:
                self._last_seq = next_seq - 1
                if tail is None:
                    self._open_segment_locked(next_seq)
                else:
                    self._active_path, self._active_start = tail
                    self._active_bytes = os.path.getsize(self._active_path)
                    self._fd = os.open(
                        self._active_path, os.O_WRONLY | os.O_APPEND
                    )
                # open-time content is on disk by definition — it is the
                # durable prefix the shipper may stream
                self._durable_bytes = self._active_bytes
            self._synced_seq = next_seq - 1

    def _open_segment_locked(self, start_seq: int) -> None:
        name = f"{_SEG_PREFIX}{start_seq:020d}{_SEG_SUFFIX}"
        self._active_path = self._seg_path(name)
        self._active_start = start_seq
        self._active_bytes = 0
        self._fd = os.open(
            self._active_path,
            os.O_WRONLY | os.O_CREAT | os.O_APPEND,
            0o644,
        )

    @staticmethod
    def _read_segment(path: str) -> bytes:
        def attempt() -> bytes:
            with open(path, "rb") as fh:
                return fh.read()

        return fault.with_retries(attempt)

    def _truncate(self, path: str, offset: int) -> None:
        """Cut a torn tail off a segment (fault-injectable; fsync'd so
        the truncation itself survives the next crash)."""
        fault.fault_point("stream.wal.truncate", path)
        with open(path, "rb+") as fh:
            fh.truncate(offset)
            fh.flush()
            os.fsync(fh.fileno())
        self.metrics.counter("geomesa.stream.wal.truncated")

    def _quarantine_tail(self, seg_name: str, data: bytes, offset: int,
                         reason: str, detail: str) -> None:
        """Move the unverifiable remainder of a segment into storage.persist's
        ``_quarantine/`` convention (under ``_wal/``), record it in the
        machine-readable damage report, and truncate the segment to its
        last intact record. Best-effort on read-only mounts: the
        in-memory damage list is populated regardless."""
        from geomesa_tpu_torch.storage.persist import (
            QUARANTINE_DIR, DamageRecord, _append_damage_record,
        )

        root = self.quarantine_root
        fname = f"{seg_name}.tail@{offset}"
        dest: "str | None" = None
        try:
            qdir = os.path.join(root, QUARANTINE_DIR, "_wal")
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(qdir, fname)
            with open(dest, "wb") as fh:
                fh.write(data[offset:])
        except OSError:
            dest = None
        rec = DamageRecord(
            type_name="_wal", file=seg_name, reason=reason,
            detail=detail or f"{len(data) - offset} bytes quarantined",
            quarantined_to=(
                os.path.relpath(dest, root) if dest is not None else None
            ),
        )
        try:
            rec.fresh = _append_damage_record(root, rec)
        except OSError:
            pass
        self.damage.append(rec)
        self.metrics.counter("geomesa.stream.wal.quarantined")
        try:
            self._truncate(self._seg_path(seg_name), offset)
        except OSError:
            pass

    def _quarantine_orphan(self, seg_name: str) -> None:
        """A whole segment past a damaged one: its records are intact
        but no longer contiguous with the replayable prefix — move it
        aside whole rather than replay across a hole."""
        from geomesa_tpu_torch.storage.persist import (
            QUARANTINE_DIR, DamageRecord, _append_damage_record,
        )

        root = self.quarantine_root
        dest: "str | None" = None
        try:
            qdir = os.path.join(root, QUARANTINE_DIR, "_wal")
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(qdir, seg_name)
            os.replace(self._seg_path(seg_name), dest)
        except OSError:
            dest = None
        rec = DamageRecord(
            type_name="_wal", file=seg_name, reason="orphaned",
            detail="segment follows a damaged segment; not replayed",
            quarantined_to=(
                os.path.relpath(dest, root) if dest is not None else None
            ),
        )
        try:
            rec.fresh = _append_damage_record(root, rec)
        except OSError:
            pass
        self.damage.append(rec)
        self.metrics.counter("geomesa.stream.wal.quarantined")

    # -- append / commit ---------------------------------------------------
    def append(self, kind: str, body: dict, pending: bool = False) -> int:
        """Encode + buffer one record; fsync per the sync policy. The
        returned seqno is DURABLE (to the policy's guarantee) when this
        returns — the caller may acknowledge.

        ``pending=True`` registers the seqno as logged-but-not-applied
        (under the same lock hold that assigns it, so no checkpoint can
        observe the seqno without the registration): the caller MUST
        call :meth:`applied` once the record's effect is in the store.
        :meth:`applied_horizon` — the checkpoint cover — never advances
        past a pending record, closing the log→apply race where a
        concurrent checkpoint's snapshot misses an acknowledged record's
        effect yet its cover skips the record at replay."""
        fault.fault_point("stream.wal.append", self._active_path)
        with _ospan("wal.append", kind=kind):
            return self._append_locked_path(kind, body, pending)

    def _append_locked_path(self, kind: str, body: dict, pending: bool) -> int:
        # the append body proper (traced by the wal.append span above)
        now = time.monotonic()
        with self._lock:
            if self._closed:
                raise WalError("write-ahead log is closed")
            seq = self._last_seq + 1
            payload = json.dumps(
                {"s": seq, "k": kind, **body},
                separators=(",", ":"), default=_enc_json,
            ).encode("utf-8")
            self._buffer += _frame(payload)
            self._last_seq = seq
            if pending:
                self._pending.add(seq)
            need_rotate = (
                self._active_bytes + len(self._buffer)
                >= max(int(self.config.segment_bytes), 1 << 10)
            )
            big_buffer = len(self._buffer) >= _FLUSH_BYTES
        self.metrics.counter("geomesa.stream.wal.appends")
        try:
            if self.config.sync == "always":
                self.sync(upto=seq)
            elif self.config.sync == "interval":
                if (now - self._last_sync_t) * 1000.0 >= self.config.sync_interval_ms:
                    self.sync(upto=seq)
                elif big_buffer:
                    self._write_out()
            elif big_buffer:
                self._write_out()
            if need_rotate:
                self._rotate()
        except BaseException:
            # the append FAILED before the caller could learn its seqno:
            # un-register the pending mark, or applied_horizon() — and
            # with it every future checkpoint cover and segment
            # retirement — would stay pinned below this seq forever.
            # The record was never acknowledged, so a checkpoint
            # covering it (applied or not) loses nothing.
            if pending:
                with self._lock:
                    self._pending.discard(seq)
            raise
        return seq

    def _flush_buffer_locked(self) -> None:
        # holds-lock: _lock
        if self._buffer and self._fd is not None:
            os.write(self._fd, bytes(self._buffer))
            self._active_bytes += len(self._buffer)
            self._buffer.clear()
            self.metrics.gauge(
                "geomesa.stream.wal.bytes", self._active_bytes
            )

    def _write_out(self) -> None:
        """Drain the app buffer to the fd WITHOUT an fsync (the
        sync=interval/off steady state: a process kill keeps these
        bytes — only power loss can drop them)."""
        with self._sync_lock:
            with self._lock:
                self._flush_buffer_locked()

    def sync(self, upto: "int | None" = None, force: bool = False) -> None:
        """Make every buffered record durable (write + fsync), with
        group commit: if another producer's fsync already covered
        ``upto``, return without a second fsync. Transient IO faults at
        the ``stream.wal.sync`` point retry with bounded backoff.
        ``force=True`` fsyncs even under ``sync=off`` — the checkpoint
        path must make the log durable BEFORE it retires segments."""
        if upto is None:
            with self._lock:
                upto = self._last_seq

        fsync_s: list = []  # wall of the LAST actual fsync (if any)

        def attempt() -> None:
            with self._sync_lock:
                if not force and self._synced_seq >= upto:
                    return  # group-committed by a concurrent producer
                with self._lock:
                    if self._closed:
                        raise WalError("write-ahead log is closed")
                    self._flush_buffer_locked()
                    end = self._last_seq
                    fd, path = self._fd, self._active_path
                    abytes = self._active_bytes
                fault.fault_point("stream.wal.sync", path)
                if (force or self.config.sync != "off") and fd is not None:
                    t0 = time.perf_counter()
                    os.fsync(fd)
                    fsync_s.append(time.perf_counter() - t0)
                    self._durable_bytes = abytes
                self._synced_seq = end
                self._last_sync_t = time.monotonic()
                self.metrics.counter("geomesa.stream.wal.syncs")

        with _ospan("wal.sync"):
            fault.with_retries(attempt, metrics=self.metrics)
        if fsync_s:
            # the durability tail is a live histogram + SLO surface:
            # only REAL fsyncs record (group-committed fast returns
            # would flatter the p99); observed after the sync lock is
            # released, so the innermost-lock discipline holds
            self.metrics.observe("geomesa.stream.wal.fsync", fsync_s[-1])

    def _rotate(self) -> None:
        """Seal the active segment (flush + fsync + close) and open a
        fresh one named by the next seqno.

        The seal's fsync runs OUTSIDE the append lock (under the sync
        lock only — the blocking-under-lock discipline): producers keep appending (buffering) while the
        old segment fsyncs, instead of every acknowledged write
        stalling behind the rotation's disk flush. The fsync happens
        BEFORE the fd swap: on failure the exception propagates with
        the active segment unchanged, so the next ``sync()``/append
        retries the SAME fd — a failed seal can never be masked by a
        later fsync of the fresh segment. Safe because every fd write
        serializes on ``_sync_lock`` (held here throughout): records
        buffered during the fsync only reach a file at the NEXT
        sync/flush, which runs after the swap and targets the new
        segment, with seqnos above the sealed range."""
        with self._sync_lock:
            with self._lock:
                if self._closed:
                    return
                path = self._active_path
            # the fault point fires under the SYNC lock only (appends
            # keep flowing); _active_path is stable here — only _rotate
            # and _open_tail move it, both serialized by _sync_lock
            fault.fault_point("stream.wal.rotate", path)
            with self._lock:
                if self._closed:
                    return
                # drain everything appended so far to the OLD fd; the
                # seal fsync below then covers exactly seqnos <= end
                self._flush_buffer_locked()
                old_fd = self._fd
                end = self._last_seq
            if old_fd is not None:
                # outside _lock: appends buffer concurrently. A raise
                # here leaves _fd on the old segment — no masking.
                os.fsync(old_fd)
            with self._lock:
                if self._closed:
                    return
                self._open_segment_locked(self._last_seq + 1)
            if old_fd is not None:
                os.close(old_fd)
            # advanced only AFTER the seal fsync succeeded: a
            # producer's group-commit check must never treat a
            # page-cache-only record as durable (acked-row loss under
            # sync=always). Records buffered during the fsync have
            # seqnos > end and stay uncovered until their own sync.
            self._synced_seq = end
            self._durable_bytes = 0  # the fresh active segment
            self._last_sync_t = time.monotonic()
        self.metrics.counter("geomesa.stream.wal.rotations")

    def retire(self, upto_seq: int) -> int:
        """Delete SEALED segments whose every record is <= ``upto_seq``
        (called after a checkpoint watermark: those records' effects are
        durable in the saved cold store). The active segment never
        retires. Returns segments removed."""
        segs = self._segments()
        removed = 0
        for name, nxt in zip(segs, segs[1:]):
            if self._seg_path(name) == self._active_path:
                break
            # a sealed segment's records all precede the next segment's
            # start; retire when that whole range is checkpoint-covered
            if self._seg_start(nxt) - 1 <= upto_seq:
                try:
                    os.remove(self._seg_path(name))
                    removed += 1
                except OSError:
                    pass
            else:
                break
        if removed:
            self.metrics.counter("geomesa.stream.wal.retired", removed)
        return removed

    def checkpoint(self, cover: "int | None" = None) -> int:
        """Append a checkpoint watermark — the cold store was just
        durably saved — force a sync regardless of policy, and retire
        fully-covered sealed segments. Returns the watermark seqno.

        ``cover`` is the highest seqno the save is KNOWN to reflect —
        captured by the caller BEFORE the checkpoint's full drain, so a
        write racing the checkpoint (acknowledged after the flush
        snapshot, hence in neither the publish nor the save) keeps its
        record: replay skips only records <= cover and re-applies the
        rest idempotently. Default: everything appended so far (the
        single-threaded case)."""
        if cover is None:
            cover = self.last_seq
        seq = self.append("c", {"cover": int(cover), "term": self.term})
        # forced fsync even under sync=off: segments are deleted next —
        # retiring durable records while the watermark (and the active
        # tail) sits in the page cache would turn a power loss into a
        # hole the retired records can no longer fill
        self.sync(upto=seq, force=True)
        self.retire(cover)
        return seq

    # -- shipping ---------------------------------------------------------
    def ship_state(self) -> dict:
        """The leader-side shipping snapshot a segment shipper's pump reads (the replica
        tier, not ported yet): the current term,
        the applied horizon (the staleness reference a follower measures
        against), a wall-clock stamp, and per segment ``(name,
        shippable_bytes, sealed)``. The active segment's shippable
        length is its **durable** (fsync'd) prefix — a follower never
        receives bytes the leader could still lose (under ``sync=off``
        the horizon only advances on forced syncs, so followers lag to
        checkpoints)."""
        with self._sync_lock:
            with self._lock:
                active = os.path.basename(self._active_path)
                horizon = (
                    min(self._pending) - 1 if self._pending
                    else self._last_seq
                )
                term = self._term
                durable = int(self._durable_bytes)
        segments = []
        for name in self._segments():
            if name == active:
                segments.append((name, durable, False))
            else:
                try:
                    size = os.path.getsize(self._seg_path(name))
                except OSError:
                    continue
                segments.append((name, int(size), True))
        return {
            "term": term,
            "horizon": horizon,
            "wall_ms": int(time.time() * 1000),
            "segments": segments,
        }

    @property
    def term(self) -> int:
        """The highest leadership term durably recorded in this log
        (``t`` records, plus the term each checkpoint watermark
        carries). 0 until a promotion ever happened."""
        with self._lock:
            return self._term

    def log_term(self, term: int) -> int:
        """Durably record a leadership term bump (the promotion fence): appended and force-fsync'd BEFORE the
        promoted store accepts its first write, so a deposed leader's
        late shipments are refused by every future reopen of this log.
        Terms are monotonic; a lower value is a promotion-protocol bug."""
        with self._lock:
            if int(term) <= self._term:
                raise WalError(
                    f"term must be monotonic: have {self._term}, "
                    f"got {int(term)}"
                )
        seq = self.append("t", {"term": int(term)})
        self.sync(upto=seq, force=True)
        with self._lock:
            self._term = max(self._term, int(term))
        return seq

    # -- replay ------------------------------------------------------------
    def replay(self, on_progress=None) -> Iterator[dict]:
        """Yield the decoded records a recovery must apply, in order:
        everything AFTER the last checkpoint watermark (records at or
        before it are already in the durably saved cold store; replaying
        them would be idempotent but wasted). Damage handling per the
        module docstring: torn active tail truncated, checksum tails
        quarantined, later segments orphaned.

        ``on_progress(seqno, segment, bytes)`` — when given — is called
        once per scanned segment with the highest seqno parsed so far,
        the segment's file name, and the cumulative bytes read: long
        catch-ups report instead of going dark
        (``geomesa.replica.replay.progress``)."""
        # records the last checkpoint's save is known to reflect (its
        # COVER seqno, not its position: a record acknowledged between
        # the checkpoint's flush snapshot and its watermark is in
        # neither the save nor the publish, and must replay) are
        # dropped AS EACH 'c' RECORD IS SEEN — covers are monotonic, so
        # the working set stays proportional to the post-checkpoint
        # suffix, not the whole log
        kept: list[dict] = []
        segs = self._segments()
        damaged = False
        read_bytes = 0
        for i, name in enumerate(segs):
            path = self._seg_path(name)
            is_active = path == self._active_path
            if damaged:
                if is_active:
                    # the ACTIVE segment must never be moved aside: the
                    # open fd would keep appending (and acking!) into
                    # the quarantined inode, invisible to the next
                    # recovery. Quarantine a COPY of its content and
                    # truncate it in place — appends continue into the
                    # (now empty) live file.
                    self._quarantine_tail(
                        name, self._read_segment(path), 0, "orphaned",
                        "active segment follows a damaged segment; "
                        "content quarantined, log truncated in place",
                    )
                    with self._lock:
                        self._active_bytes = os.path.getsize(path)
                else:
                    self._quarantine_orphan(name)
                continue
            fault.fault_point("stream.wal.replay", path)
            data = self._read_segment(path)
            read_bytes += len(data)
            recs, bad = _parse_frames(data)
            for r in recs:
                k = r.get("k")
                if k in ("t", "c") and "term" in r:
                    with self._lock:
                        self._term = max(self._term, int(r["term"]))
                if k == "c":
                    cov = int(r.get("cover", r.get("s", -1)))
                    kept = [q for q in kept if int(q.get("s", -1)) > cov]
                elif k != "t":  # term records carry no store effect
                    kept.append(r)
            if recs and on_progress is not None:
                on_progress(int(recs[-1].get("s", -1)), name, read_bytes)
            if bad is not None:
                offset, reason, detail = bad
                if reason == "torn" and i == len(segs) - 1:
                    self._truncate(path, offset)
                else:
                    self._quarantine_tail(name, data, offset, reason, detail)
                    damaged = True
                if is_active:
                    with self._lock:
                        self._active_bytes = os.path.getsize(path)
        if kept:
            self.metrics.counter("geomesa.stream.wal.replayed", len(kept))
        return iter(kept)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Flush + fsync + close (idempotent). Like :meth:`_rotate`,
        the final fsync runs outside the append lock: ``_closed`` is
        set (and the buffer drained) under ``_lock``, after which no
        append can touch the fd, so the seal needs only the sync
        lock."""
        self._stop.set()
        with self._sync_lock:
            with self._lock:
                if self._closed:
                    return
                self._flush_buffer_locked()
                fd, self._fd = self._fd, None
                self._closed = True
                end = self._last_seq
                abytes = self._active_bytes
            if fd is not None:
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
                self._durable_bytes = abytes
            self._synced_seq = end

    def crash(self) -> None:
        """TEST SURFACE: simulate ``kill -9`` — the in-process buffer
        (records appended but not yet written through) is DROPPED and
        the fd closes without a flush. What recovery then sees is
        exactly what a real kill would leave on disk."""
        self._stop.set()
        with self._sync_lock:
            with self._lock:
                self._buffer.clear()
                if self._fd is not None:
                    os.close(self._fd)
                    self._fd = None
                self._closed = True

    def applied(self, seq: int) -> None:
        """The record's effect reached the store (see ``pending=``)."""
        with self._lock:
            self._pending.discard(seq)

    def applied_horizon(self) -> int:
        """The highest seqno S such that every record <= S has been
        APPLIED to the store — the only safe checkpoint cover: a save
        snapshotted now reflects everything at or below it."""
        with self._lock:
            if self._pending:
                return min(self._pending) - 1
            return self._last_seq

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._last_seq

    @property
    def synced_seq(self) -> int:
        with self._sync_lock:
            return self._synced_seq

    # -- record builders (the LambdaStore integration surface) -------------
    def log_upsert(self, ids: Sequence[str], rows: Sequence, next_id: int) -> int:
        """One acknowledged write batch: resolved ids + rows (columnar
        for uniform batches — :func:`pack_upsert`; tagged json per row
        otherwise) + the hot tier's auto-id counter AFTER assignment (so
        replay can restore it and future auto-ids never collide with
        replayed ones)."""
        body = pack_upsert(rows)
        body["ids"] = [str(i) for i in ids]
        body["nid"] = int(next_id)
        return self.append("u", body, pending=True)

    def log_delete(self, ids: Sequence[str]) -> int:
        # no pending mark: destructive records are logged AFTER their
        # application (under the hot lock), so they are applied by the
        # time their seqno exists
        return self.append("d", {"ids": [str(i) for i in ids]})

    def log_expire(self, ids: Sequence[str]) -> int:
        return self.append("x", {"ids": [str(i) for i in ids]})

    def log_watermark(self, ids: Sequence[str], incremental: bool) -> int:
        return self.append(
            "w", {"ids": [str(i) for i in ids], "inc": bool(incremental)}
        )

    def log_subscribe(self, rec: dict) -> int:
        """One standing-query subscription registration (the ``s``
        record): logged BEFORE the registration
        applies — pending like :meth:`log_upsert`, so a checkpoint
        cover never skips a logged-but-unapplied registration."""
        return self.append("s", {"sub": rec}, pending=True)

    def log_unsubscribe(self, sub_id: str) -> int:
        """A subscription removal (``s`` record with ``rm``): logged
        after the removal applies, like :meth:`log_delete` — a failed
        append leaves a removal that really happened; recovery can only
        resurrect an unacknowledged unsubscribe, never lose an
        acknowledged registration."""
        return self.append("s", {"rm": str(sub_id)})
