"""WAL shipping: read replicas, bounded staleness, leader failover.

The port's copy of geomesa_tpu/streaming/replica.py. The reference
GeoMesa delegates replication to its backends (Accumulo/HBase
region-server replication); this store owns its own log, and the WAL
(segmented, checksummed, checkpoint-anchored) is already a replication
stream with no second reader. This module adds the second reader:

- :class:`SegmentShipper` (leader side) streams sealed WAL segments,
  the active segment's DURABLE (fsync'd) prefix, and per-pump staleness
  marks (the leader's applied horizon + wall clock + current segment
  manifest) to followers over a length-prefixed checksummed transport.
  The transport is an SPI (:class:`PipeTransport` for deterministic
  in-process tests, :class:`SocketTransport` for loopback TCP).
- :class:`ReplicaStore` (follower side) is literally
  ``LambdaStore.recover`` that never stops: it bootstraps through the
  real recovery path (cold load onto the store's device + local-WAL
  replay + damage quarantine), then keeps applying shipped records through the same
  :class:`~geomesa_tpu_torch.streaming.store.RecordApplier` the recovery
  path uses — continuous replay into its own hot tier + cold store,
  serving scheduler-admitted reads with a MEASURED staleness watermark
  (``geomesa.replica.staleness.ms``, a default SLO objective, and a
  ``/health`` reason via HealthMonitor).
- Failover: :meth:`ReplicaStore.promote` finishes replay (optionally
  straight from the dead leader's on-disk WAL — under ``sync=always``
  that closes the shipping lag to ZERO acknowledged-row loss), fences
  via a monotonic term durably recorded in the WAL (``t`` records; a
  deposed leader's late shipments arrive with a lower term and are
  REFUSED), and opens for writes.

Wire format: every message is one frame — ``uvarint(len) | json |
blake2b-8`` — the WAL's own record framing, so a shipped chunk is
verified twice: once as a transport frame, once record-by-record when
the follower parses the appended segment bytes. Messages:

    {"m": "seg",   "term": T, "name": n, "off": o, "data": b64,
     "sealed": bool}                     # leader -> follower: bytes
    {"m": "state", "term": T, "horizon": H, "wall_ms": W,
     "segments": [names]}                # leader -> follower: mark
    {"m": "hello", "offsets": {n: o}}    # follower -> leader: resume
    {"m": "resync", "name": n}           # follower -> leader: re-ship

Threads: the shipper's pump (``geomesa-replica-ship``) and the
follower's apply loop (``geomesa-replica-apply``) start only on
``start()``; ``stop()`` / ``close()`` join them, and ``close()`` closes
the transport's socket.

Fault points: ``replica.ship.segment`` (the shipper's chunk read/send),
``replica.apply`` (the follower's segment append+apply), ``replica.
promote`` (the failover entry), ``replica.fence`` (a stale-term
message refused).
"""

from __future__ import annotations

import base64
import json
import os
import socket
import threading
import time
from collections import deque

from geomesa_tpu_torch import conf, fault
from geomesa_tpu_torch.filter.predicates import INCLUDE
from geomesa_tpu_torch.streaming.wal import (
    _frame, _parse_frames, WalConfig, WalError, WriteAheadLog,
)

_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"


def _seg_start(name: str) -> int:
    """The start seqno a segment name carries (the WAL naming scheme)."""
    return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])


class ReplicaError(RuntimeError):
    """Replication protocol failure (transport closed, gap the follower
    cannot heal, promotion over a newer term)."""


class StaleRead(ReplicaError):
    """A bounded-staleness read found the follower too far behind (or
    unmeasured) — the caller asked for freshness this replica cannot
    currently prove."""


# -- transport SPI ----------------------------------------------------------
#
# A transport endpoint is anything with:
#   send(msg: dict) -> None      raising OSError on a dead peer
#   recv(timeout: float) -> dict | None   (None = nothing available)
#   close() -> None
# Framing below reuses the WAL's uvarint|json|blake2b-8 record frame, so
# every message is length-prefixed and checksummed end to end.


def _encode_msg(msg: dict) -> bytes:
    return _frame(json.dumps(msg, separators=(",", ":")).encode("utf-8"))


class PipeTransport:
    """In-process transport pair (deterministic tests, single-process
    chaos topologies): two endpoints over two byte-frame deques. Even
    in memory the bytes go through the real frame encode/verify, so the
    wire format is exercised on every message."""

    def __init__(self, inbox: deque, outbox: deque, state: dict):
        self._inbox = inbox
        self._outbox = outbox
        self._state = state  # {"closed": bool} shared by both ends

    @classmethod
    def pair(cls) -> "tuple[PipeTransport, PipeTransport]":
        a: deque = deque()
        b: deque = deque()
        state = {"closed": False}
        return cls(a, b, state), cls(b, a, state)

    def send(self, msg: dict) -> None:
        if self._state["closed"]:
            raise OSError("pipe transport closed")
        self._outbox.append(_encode_msg(msg))

    def recv(self, timeout: float = 0.0) -> "dict | None":
        try:
            data = self._inbox.popleft()
        except IndexError:
            return None
        records, bad = _parse_frames(data)
        if bad is not None or len(records) != 1:
            raise ReplicaError(f"damaged transport frame: {bad!r}")
        return records[0]

    def close(self) -> None:
        self._state["closed"] = True


class SocketTransport:
    """Loopback-TCP transport endpoint (the first real deployment
    shape): frames stream over one connected socket.
    ``listen()`` gives the follower side an acceptor; the leader
    ``connect()``s one endpoint per follower."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = bytearray()
        self._closed = False

    @classmethod
    def connect(cls, host: str, port: int,
                timeout: float = 5.0) -> "SocketTransport":
        return cls(socket.create_connection((host, int(port)), timeout))

    @classmethod
    def listen(cls, host: str = "127.0.0.1",
               port: int = 0) -> "_SocketListener":
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, int(port)))
        srv.listen(8)
        return _SocketListener(srv)

    def send(self, msg: dict) -> None:
        if self._closed:
            raise OSError("socket transport closed")
        self._sock.sendall(_encode_msg(msg))

    def recv(self, timeout: float = 0.0) -> "dict | None":
        deadline = time.monotonic() + max(float(timeout), 0.0)
        while True:
            msg = self._pop_frame()
            if msg is not None:
                return msg
            remaining = deadline - time.monotonic()
            if self._closed:
                return None
            self._sock.settimeout(max(remaining, 1e-4))
            try:
                data = self._sock.recv(1 << 16)
            except socket.timeout:
                return None
            except OSError:
                self._closed = True
                return None
            if not data:
                self._closed = True  # peer closed; drain what we have
                continue
            self._buf += data

    def _pop_frame(self) -> "dict | None":
        """Decode + consume the FIRST complete frame in the buffer
        (None = a partial frame waits for more bytes). A checksum
        mismatch poisons the stream — frame boundaries past it are
        unrecoverable — so the endpoint closes."""
        import hashlib

        from geomesa_tpu_torch.io.varint import read_uvarint

        buf = self._buf
        if not buf:
            return None
        try:
            length, pos = read_uvarint(bytes(buf[:10]), 0)
        except IndexError:
            return None  # length varint itself is still arriving
        end = pos + int(length) + 8
        if len(buf) < end:
            return None
        payload = bytes(buf[pos : pos + length])
        digest = bytes(buf[pos + length : end])
        if hashlib.blake2b(payload, digest_size=8).digest() != digest:
            self._closed = True
            buf.clear()  # boundaries past damage are meaningless
            raise ReplicaError(
                f"damaged transport frame ({length} bytes): stream closed"
            )
        del buf[:end]
        return json.loads(payload)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class _SocketListener:
    """The follower-side acceptor :meth:`SocketTransport.listen`
    returns."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self.port = int(sock.getsockname()[1])

    def accept(self, timeout: "float | None" = None) -> SocketTransport:
        self._sock.settimeout(timeout)
        s, _ = self._sock.accept()
        return SocketTransport(s)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# -- leader side ------------------------------------------------------------
class _Follower:
    __slots__ = ("transport", "offsets", "name")

    def __init__(self, transport, name: str):
        self.transport = transport
        self.name = name
        self.offsets: dict = {}  # segment name -> bytes shipped


class SegmentShipper:
    """Leader-side pump: streams newly durable WAL bytes to every
    attached follower and broadcasts staleness marks. One pump tick
    per ``geomesa.replica.ship.interval.ms`` when started as a thread;
    deterministic tests call :meth:`pump` directly.

    Ships ONLY durable bytes (``WriteAheadLog.ship_state``): the active
    segment's fsync'd prefix, sealed segments whole. A follower can
    therefore never hold records a restarted leader lost — the shipping
    horizon IS the durability horizon.

    Transport failures retry under :func:`fault.with_retries` with the
    ``geomesa.replica.giveup.s`` elapsed budget; past it the follower
    is marked in :attr:`gave_up` (the ``replica.ship.giveup`` /health
    reason) and retried fresh next tick instead of spinning forever."""

    def __init__(self, store, chunk_bytes: "int | None" = None,
                 interval_ms: "float | None" = None,
                 giveup_s: "float | None" = None, metrics=None):
        from geomesa_tpu_torch.lockwitness import witness
        from geomesa_tpu_torch.metrics import resolve

        if store.wal is None:
            raise ReplicaError("SegmentShipper needs a WAL-backed store")
        self.store = store
        self.wal = store.wal
        self.metrics = resolve(
            metrics if metrics is not None
            else getattr(store.cold, "metrics", None)
        )
        self.chunk_bytes = max(int(
            chunk_bytes if chunk_bytes is not None
            else conf.REPLICA_SHIP_CHUNK_BYTES.get()
        ), 1)
        self.interval_ms = float(
            interval_ms if interval_ms is not None
            else conf.REPLICA_SHIP_INTERVAL_MS.get()
        )
        self.giveup_s = float(
            giveup_s if giveup_s is not None else conf.REPLICA_GIVEUP_S.get()
        )
        # narrow bookkeeping lock: guards the follower map and the
        # give-up report, NEVER held across transport/file/store calls
        self._lock = witness(threading.Lock(), "SegmentShipper._lock")
        self._followers: dict = {}   # guarded-by: _lock
        self._gave_up: dict = {}     # guarded-by: _lock
        self._seq = 0                # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        store.shipper = self  # the HealthMonitor backref

    # -- membership --------------------------------------------------------
    def attach(self, transport, name: "str | None" = None) -> str:
        """Register one follower endpoint (after its ReplicaStore is
        constructed — the follower's ``hello`` carries its resume
        offsets). Returns the follower id used in give-up reports."""
        with self._lock:
            self._seq += 1
            fid = name if name is not None else f"follower-{self._seq}"
            self._followers[fid] = _Follower(transport, fid)
        return fid

    def detach(self, fid: str) -> None:
        with self._lock:
            self._followers.pop(fid, None)
            self._gave_up.pop(fid, None)

    def gave_up_report(self) -> dict:
        """follower id -> give-up detail, for followers whose last pump
        exhausted the retry budget (the /health surface)."""
        with self._lock:
            return dict(self._gave_up)

    # -- the pump ----------------------------------------------------------
    def pump(self) -> int:
        """One shipping tick: drain follower control messages, ship
        every follower its missing durable bytes, broadcast a staleness
        mark. Returns payload bytes shipped."""
        with self._lock:
            followers = list(self._followers.items())
        state = self.wal.ship_state()
        total = 0
        for fid, fo in followers:
            try:
                self._drain_control(fo)
                total += self._ship_one(fo, state)
                with self._lock:
                    self._gave_up.pop(fid, None)
            except (OSError, ReplicaError) as e:
                with self._lock:
                    self._gave_up[fid] = f"{type(e).__name__}: {e}"
                self.metrics.counter("geomesa.replica.ship.giveup")
        return total

    def _drain_control(self, fo: _Follower) -> None:
        while True:
            msg = fo.transport.recv(timeout=0.0)
            if msg is None:
                return
            kind = msg.get("m")
            if kind == "hello":
                fo.offsets = {
                    str(k): int(v)
                    for k, v in (msg.get("offsets") or {}).items()
                }
            elif kind == "resync":
                # the follower quarantined (or lost) its local copy:
                # re-ship the whole segment
                fo.offsets[str(msg.get("name"))] = 0

    def _ship_one(self, fo: _Follower, state: dict) -> int:
        term = int(state["term"])
        live = {name for name, _, _ in state["segments"]}
        total = 0
        for name, shippable, sealed in state["segments"]:
            off = int(fo.offsets.get(name, 0))
            done_before = off >= shippable
            while off < shippable:
                data = self._read_chunk(name, off, min(
                    self.chunk_bytes, shippable - off
                ))
                if data is None or not data:
                    break  # retired mid-pump; the next state mark heals
                fo.transport.send({
                    "m": "seg", "term": term, "name": name, "off": off,
                    "data": base64.b64encode(data).decode("ascii"),
                    "sealed": bool(sealed),
                })
                off += len(data)
                total += len(data)
                self.metrics.counter(
                    "geomesa.replica.shipped.bytes", len(data)
                )
            fo.offsets[name] = max(int(fo.offsets.get(name, 0)), off)
            if sealed and off >= shippable and not done_before:
                self.metrics.counter("geomesa.replica.shipped.segments")
        # the staleness mark + manifest: the follower measures its
        # watermark against (horizon, wall_ms) and drops local copies
        # of segments the leader retired
        fo.transport.send({
            "m": "state", "term": term,
            "horizon": int(state["horizon"]),
            "wall_ms": int(state["wall_ms"]),
            "segments": sorted(live),
        })
        for name in [n for n in fo.offsets if n not in live]:
            fo.offsets.pop(name, None)
        return total

    def _read_chunk(self, name: str, off: int, n: int) -> "bytes | None":
        path = os.path.join(self.wal.dir, name)

        def attempt() -> bytes:
            fault.fault_point("replica.ship.segment", path)
            with open(path, "rb") as fh:
                fh.seek(off)
                return fh.read(n)

        try:
            return fault.with_retries(
                attempt, metrics=self.metrics,
                max_elapsed_s=self.giveup_s,
            )
        except FileNotFoundError:
            return None  # retired between ship_state and the read

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "SegmentShipper":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="geomesa-replica-ship", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        period = max(self.interval_ms, 1.0) / 1e3
        while not self._stop.wait(period):
            try:
                self.pump()
            except WalError:
                return  # the leader's WAL closed under us

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


# -- follower side ----------------------------------------------------------
class ReplicaStore:
    """A read replica: ``LambdaStore.recover`` that never stops.

    Bootstrap runs the REAL recovery path over the leader's last
    checkpoint root and the replica's own local WAL directory (shipped
    segment copies from a previous run replay; damage quarantines into
    the replica's own root) — then the recovered store's WAL handle is
    closed and continuous replay takes over: every shipped chunk
    appends to the local segment copy, parses incrementally, and
    applies through the same
    :class:`~geomesa_tpu_torch.streaming.store.RecordApplier` recovery uses.
    Reads serve from the follower's own hot+cold merge, scheduler-
    admitted when a serving tier is attached, with a measured staleness
    watermark (:meth:`staleness_ms`).

    Fencing: every shipped message carries the leader's term; a message
    with a LOWER term than the replica has witnessed is refused
    (``replica.fence`` — the deposed-leader case). :meth:`promote`
    bumps the term durably before the first write."""

    def __init__(self, root: str, wal_dir: str, transport,
                 type_name: "str | None" = None,
                 replica_root: "str | None" = None,
                 expiry_ms: "int | None" = None,
                 config=None, wal_config: "WalConfig | None" = None,
                 staleness_max_ms: "float | None" = None,
                 **load_kwargs):
        from geomesa_tpu_torch.lockwitness import witness
        from geomesa_tpu_torch.streaming.store import LambdaStore, RecordApplier

        self.root = str(root)
        self.wal_dir = str(wal_dir)
        self.replica_root = (
            str(replica_root) if replica_root is not None
            else (os.path.dirname(os.path.abspath(self.wal_dir)) or ".")
        )
        os.makedirs(self.wal_dir, exist_ok=True)
        self.transport = transport
        self._wal_config = wal_config
        self.staleness_max_ms = float(
            staleness_max_ms if staleness_max_ms is not None
            else conf.REPLICA_STALENESS_MAX_MS.get()
        )
        # bootstrap: the real recovery path (cold load + local replay +
        # quarantine), then detach the WAL handle — the follower APPLIES
        # shipped records, it does not log its own
        self.store = LambdaStore.recover(
            self.root, type_name=type_name, wal_dir=self.wal_dir,
            expiry_ms=expiry_ms, config=config, wal_config=wal_config,
            quarantine_root=self.replica_root, **load_kwargs
        )
        wal = self.store.wal
        replayed = wal.last_seq
        term = wal.term
        sizes = {}
        for name in wal._segments():
            try:
                sizes[name] = os.path.getsize(wal._seg_path(name))
            except OSError:
                continue
        wal.close()
        self.store.wal = None
        self.store.replica = self  # the HealthMonitor backref
        from geomesa_tpu_torch.metrics import resolve

        self.metrics = resolve(getattr(self.store.cold, "metrics", None))
        self.applier = RecordApplier(self.store)
        # narrow bookkeeping lock: replayed seqno / term / staleness
        # marks / local sizes — NEVER held across store or file calls
        self._apply_lock = witness(
            threading.Lock(), "ReplicaStore._apply_lock"
        )
        self._replayed = replayed        # guarded-by: _apply_lock
        self._term = term                # guarded-by: _apply_lock
        self._marks: deque = deque()     # guarded-by: _apply_lock
        self._sizes = sizes              # local segment byte lengths
        self._tails: dict = {}           # segment -> unparsed byte tail
        self._hole_retries: dict = {}    # (segment, seq) -> resyncs tried
        self.writable = False
        self.server = None  # the data plane (serve(port=...))
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        # resume handshake: tell the shipper where our local copies end
        # (a restarted follower re-receives only what it is missing)
        self.transport.send({"m": "hello", "offsets": dict(sizes)})

    # -- observable state --------------------------------------------------
    @property
    def replayed(self) -> int:
        """Highest seqno applied to this replica's store."""
        with self._apply_lock:
            return self._replayed

    @property
    def term(self) -> int:
        """Highest leadership term witnessed (shipped records/marks, or
        our own promotion)."""
        with self._apply_lock:
            return self._term

    def staleness_ms(self, now_ms: "float | None" = None) -> "float | None":
        """The measured staleness watermark: wall-clock ms since the
        newest leader mark whose applied horizon this replica has fully
        replayed — i.e. how far in the past a read here answers from.
        ``None`` until the first mark arrives (unmeasured is NOT fresh:
        the /health check degrades on it)."""
        with self._apply_lock:
            marks = list(self._marks)
            replayed = self._replayed
        if not marks:
            return None
        now = time.time() * 1e3 if now_ms is None else float(now_ms)
        caught: "float | None" = None
        for horizon, wall_ms in marks:
            if horizon <= replayed:
                caught = wall_ms
            else:
                break
        if caught is None:
            # behind even the oldest retained mark: at LEAST that stale
            caught = float(marks[0][1])
        return max(now - caught, 0.0)

    # -- continuous replay -------------------------------------------------
    def poll(self, timeout: float = 0.0) -> bool:
        """Receive and apply at most one shipped message. Returns True
        if one was processed."""
        msg = self.transport.recv(timeout=timeout)
        if msg is None:
            return False
        self._handle(msg)
        return True

    def drain(self) -> int:
        """Apply every message currently buffered on the transport
        (the deterministic-test pump). Returns messages applied."""
        n = 0
        while self.poll(timeout=0.0):
            n += 1
        return n

    def start(self) -> "ReplicaStore":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="geomesa-replica-apply", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                if not self.poll(timeout=0.05):
                    continue
            except ReplicaError:
                continue  # refused/damaged message; keep consuming

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _fence(self, what: str, term: int) -> None:
        fault.fault_point("replica.fence", what)
        self.metrics.counter("geomesa.replica.fenced")

    def _handle(self, msg: dict) -> None:
        kind = msg.get("m")
        if kind not in ("seg", "state"):
            return  # a control message echoed back, or future kinds
        term = int(msg.get("term", 0))
        with self._apply_lock:
            ours = self._term
        if term < ours:
            # a deposed leader's late shipment: REFUSE — applying it
            # could resurrect records the promoted line retired
            self._fence(f"{kind}:{msg.get('name', '-')}", term)
            return
        if term > ours:
            with self._apply_lock:
                self._term = max(self._term, term)
        if kind == "seg":
            self._handle_seg(msg)
        else:
            self._handle_state(msg)

    def _handle_seg(self, msg: dict) -> None:
        name = str(msg["name"])
        off = int(msg["off"])
        data = base64.b64decode(msg["data"])
        path = os.path.join(self.wal_dir, name)
        cur = self._sizes.get(name)
        if cur is None:
            try:
                cur = os.path.getsize(path)
            except OSError:
                cur = 0
        if off > cur:
            # a gap (lost message / quarantined local copy): ask for the
            # whole segment again rather than apply across a hole
            self._resync(name)
            return
        if off < cur:
            return  # duplicate of bytes we already hold
        fault.fault_point("replica.apply", path)

        def attempt() -> None:
            with open(path, "ab") as fh:
                fh.write(data)

        fault.with_retries(attempt, metrics=self.metrics)
        self._sizes[name] = cur + len(data)
        records = self._parse_tail(name, data)
        if records is None:
            # checksum damage in a shipped chunk: quarantine our local
            # copy and re-fetch from the (intact) leader
            return
        for rec in records:
            if not self._apply_record(rec, segment=name):
                break  # hole detected: the rest re-arrives via resync
        self.applier.drain()

    def _parse_tail(self, name: str, data: bytes) -> "list | None":
        """Incremental frame parse: append ``data`` to the segment's
        unparsed tail, return the complete records, retain the torn
        remainder (a frame split across chunks) for the next append.
        Returns None after quarantining a checksum-damaged tail."""
        tail = self._tails.setdefault(name, bytearray())
        tail += data
        records, bad = _parse_frames(bytes(tail))
        if bad is not None and bad[1] != "torn":
            self._quarantine_local(name, bad)
            return None
        consumed = bad[0] if bad is not None else len(tail)
        del tail[:consumed]
        return records

    def _apply_record(self, rec: dict, segment: "str | None" = None) -> bool:
        """Apply one shipped record. Returns False when a seqno hole was
        detected and a resync was requested instead of applying — the
        caller must stop applying this chunk's remaining records.

        WAL seqnos are dense within the live stream, so a record that
        jumps past ``replayed + 1`` means earlier records were lost in
        transit (e.g. the final chunk of the previous segment was
        dropped, so no offset mismatch ever reveals the gap). Applying
        across the hole would advance the watermark and make the lost
        records look like duplicates when they are re-shipped — silent
        acked-row loss. Instead we resync the segment that owns the
        missing range (and the arriving one) and apply nothing."""
        seq = int(rec.get("s", -1))
        kind = rec.get("k")
        if kind in ("t", "c") and "term" in rec:
            with self._apply_lock:
                self._term = max(self._term, int(rec["term"]))
        with self._apply_lock:
            replayed = self._replayed
        if seq <= replayed:
            return True  # bootstrap overlap / duplicate: already applied
        if segment is not None and replayed >= 0 and seq > replayed + 1:
            owner = self._hole_owner(replayed + 1)
            if owner is not None:
                key = (owner, replayed + 1)
                tries = self._hole_retries.get(key, 0)
                if tries < 3:
                    self._hole_retries[key] = tries + 1
                    self.metrics.counter("geomesa.replica.hole")
                    self._resync(owner)
                    if segment != owner:
                        self._resync(segment)
                    return False
                # three re-ships did not fill the range: the leader
                # retired it under us and cannot ship it again. Apply
                # anyway — bounded staleness beats an unbounded stall —
                # and leave the retry count capped so we never loop.
        if kind not in ("t", "c"):
            # 'c' carries no store effect for a LIVE replica (we applied
            # everything it covers as it arrived); 't' is pure fencing
            self.applier.apply(rec)
            self.metrics.counter("geomesa.replica.applied.records")
        with self._apply_lock:
            self._replayed = max(self._replayed, seq)
        return True

    def _hole_owner(self, missing: int) -> "str | None":
        """The locally-known segment whose seqno range covers
        ``missing`` — None when the range predates everything we hold
        (a retired prefix we bootstrapped over, not a transit loss)."""
        cands = [n for n in self._sizes if _seg_start(n) <= missing]
        if not cands:
            return None
        return max(cands, key=_seg_start)

    def _handle_state(self, msg: dict) -> None:
        horizon = int(msg.get("horizon", -1))
        wall_ms = float(msg.get("wall_ms", 0))
        with self._apply_lock:
            self._marks.append((horizon, wall_ms))
            replayed = self._replayed
            # retain one caught-up mark (the staleness reference) plus
            # every pending one — bounded by the ship cadence
            while (
                len(self._marks) > 1 and self._marks[1][0] <= replayed
            ) or len(self._marks) > 4096:
                self._marks.popleft()
        live = set(msg.get("segments") or [])
        # only honour manifest drops once everything below the live
        # window is applied: retiring a local segment we have NOT fully
        # replayed would discard the only shippable copy of its records
        if live and replayed + 1 >= min(_seg_start(n) for n in live):
            for name in [n for n in self._sizes if n not in live]:
                self._drop_local(name)
            for name in [n for n in self._tails if n not in live]:
                self._tails.pop(name, None)
        st = self.staleness_ms()
        if st is not None:
            # histograms observe seconds repo-wide; the SLO ladder and
            # /metrics rendering scale back to ms
            self.metrics.observe("geomesa.replica.staleness.ms", st / 1e3)

    def _drop_local(self, name: str) -> None:
        """The leader retired a segment (checkpoint manifest): drop our
        local copy — its records are durable in the checkpoint root we
        would bootstrap from next time."""
        self._sizes.pop(name, None)
        try:
            os.remove(os.path.join(self.wal_dir, name))
        except OSError:
            pass

    def _resync(self, name: str) -> None:
        """Restart a segment from byte 0: truncate the local copy and
        ask the shipper to re-ship it whole."""
        path = os.path.join(self.wal_dir, name)
        try:
            with open(path, "wb"):
                pass
        except OSError:
            pass
        self._sizes[name] = 0
        self._tails.pop(name, None)
        self.metrics.counter("geomesa.replica.resync")
        try:
            self.transport.send({"m": "resync", "name": name})
        except OSError:
            pass  # the shipper re-learns offsets from our next hello

    def _quarantine_local(self, name: str, bad: tuple) -> None:
        """Checksum damage in a shipped segment copy: quarantine it into
        the replica's own ``_quarantine/_wal/`` (the persistence tier's
        convention),
        then resync from the intact leader."""
        from geomesa_tpu_torch.storage.persist import (
            QUARANTINE_DIR, DamageRecord, _append_damage_record,
        )

        offset, reason, detail = bad
        src = os.path.join(self.wal_dir, name)
        dest: "str | None" = None
        try:
            qdir = os.path.join(self.replica_root, QUARANTINE_DIR, "_wal")
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(qdir, f"{name}.replica")
            os.replace(src, dest)
        except OSError:
            dest = None
        rec = DamageRecord(
            type_name="_wal", file=name, reason=reason,
            detail=f"shipped chunk failed verification: {detail}",
            quarantined_to=(
                os.path.relpath(dest, self.replica_root)
                if dest is not None else None
            ),
        )
        try:
            rec.fresh = _append_damage_record(self.replica_root, rec)
        except OSError:
            pass
        self.store.cold.health.damage.append(rec)
        self.metrics.counter("geomesa.stream.wal.quarantined")
        self._resync(name)

    # -- failover ----------------------------------------------------------
    def promote(self, leader_wal_dir: "str | None" = None) -> int:
        """Become the leader: finish replay, fence, open for writes.

        1. Drain every shipped message still buffered on the transport.
        2. With ``leader_wal_dir`` (the shared-fs topology): read the
           dead leader's DURABLE on-disk WAL tail directly — the bytes
           the shipper never got to send — append them to our local
           copies and apply them. Under ``sync=always`` this closes the
           lag to exactly the acknowledged set: ZERO acked-row loss.
        3. Reopen the local segment copies as this store's own
           WriteAheadLog (everything in it is already applied) and
           durably record ``term + 1`` (the fence) BEFORE the first
           write is accepted — a deposed leader's late shipments now
           carry a stale term and are refused everywhere.

        Returns the new term."""
        fault.fault_point("replica.promote", self.wal_dir)
        self.stop()
        try:
            self.drain()
        except ReplicaError:
            pass  # a torn in-flight message cannot hold records we ack
        self.applier.drain()
        if leader_wal_dir is not None:
            self._catch_up_from_disk(str(leader_wal_dir))
        try:
            self.transport.close()
        except OSError:
            pass
        wal = WriteAheadLog(
            self.wal_dir, config=self._wal_config,
            metrics=self.metrics, quarantine_root=self.replica_root,
        )
        # every durable record below was applied by continuous replay
        # (or the disk catch-up above) — recovery debt is zero by
        # construction, so the plain-constructor guard does not apply
        wal.needs_recovery = False
        if wal.damage:
            self.store.cold.health.damage.extend(wal.damage)
        self.store.wal = wal
        with self._apply_lock:
            new_term = max(self._term, wal.term) + 1
        wal.log_term(new_term)
        with self._apply_lock:
            # re-read under the lock: a concurrently witnessed higher
            # term (late shipment racing the promote) must not regress
            self._term = max(self._term, new_term)
            self._replayed = max(self._replayed, wal.last_seq)
        self.writable = True
        self.metrics.counter("geomesa.replica.promotions")
        return new_term

    def _catch_up_from_disk(self, leader_wal_dir: str) -> None:
        """Finish replay straight from the dead leader's WAL directory:
        copy each segment's unshipped suffix into our local copy and
        apply its records. Torn tails (the kill artifact) stop the
        parse; the WAL reopen in :meth:`promote` truncates them."""
        try:
            names = sorted(
                n for n in os.listdir(leader_wal_dir)
                if n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX)
            )
        except OSError:
            return
        for name in names:
            src = os.path.join(leader_wal_dir, name)
            try:
                size = os.path.getsize(src)
            except OSError:
                continue
            cur = int(self._sizes.get(name, 0))
            if size <= cur:
                continue
            with open(src, "rb") as fh:
                fh.seek(cur)
                data = fh.read(size - cur)
            local = os.path.join(self.wal_dir, name)
            with open(local, "ab") as fh:
                fh.write(data)
            self._sizes[name] = cur + len(data)
            records = self._parse_tail(name, data)
            for rec in records or ():
                self._apply_record(rec)
        self.applier.drain()

    def tail_disk(self, leader_wal_dir: str, mark: bool = True) -> int:
        """Catch up from the leader's on-disk WAL directory directly —
        the shared-filesystem topology (the reference CLI's
        ``--replica-of`` flag): copy each segment's unseen suffix into the local copies
        and apply it, WITHOUT promoting (the replica stays a follower;
        call this periodically to tail the leader). With ``mark``, a
        staleness mark is stamped at the caught-up horizon so
        bounded-staleness reads can be answered with no live shipper
        attached. Returns the records applied."""
        before = self.replayed
        self._catch_up_from_disk(str(leader_wal_dir))
        if mark:
            with self._apply_lock:
                self._marks.append((self._replayed, time.time() * 1e3))
                while (
                    len(self._marks) > 1
                    and self._marks[1][0] <= self._replayed
                ) or len(self._marks) > 4096:
                    self._marks.popleft()
        return self.replayed - before

    # -- reads / writes ----------------------------------------------------
    def query(self, f=INCLUDE, hints=None,
              max_staleness_ms: "float | None" = None,
              tenant=None, block: bool = True):
        """The follower's exact hot+cold merge (scheduler-admitted when
        a serving tier is attached — ``serve()``). With
        ``max_staleness_ms``, the read is BOUNDED-STALENESS: it raises
        :class:`StaleRead` unless the measured watermark proves the
        answer is at most that far behind the leader. ``tenant`` and
        ``block`` route the admitted cold half exactly as on
        :meth:`LambdaStore.query
        <geomesa_tpu_torch.streaming.store.LambdaStore.query>` (the served
        data plane submits non-blocking, per-tenant)."""
        if max_staleness_ms is not None:
            st = self.staleness_ms()
            if st is None or st > float(max_staleness_ms):
                raise StaleRead(
                    f"replica staleness "
                    f"{'unmeasured' if st is None else f'{st:.0f}ms'} "
                    f"exceeds the {float(max_staleness_ms):g}ms bound"
                )
        return self.store.query(f, hints=hints, tenant=tenant, block=block)

    def count(self, f=INCLUDE) -> int:
        return len(self.query(f))

    def write(self, rows, ids=None) -> int:
        """Accepted only after :meth:`promote` — a follower is
        read-only by construction."""
        if not self.writable:
            raise ReplicaError(
                "this replica is a follower — promote() before writing"
            )
        return self.store.write(rows, ids)

    def serve(self, config=None, port: "int | None" = None,
              host: "str | None" = None, **server_kwargs):
        """The follower's serving tier (the cold store's scheduler); with
        ``port``, mounts the read-only data plane over this replica
        (writes answer 403 with the leader's address; reads honor the
        staleness-bound header)."""
        if port is not None:
            from geomesa_tpu_torch.serving.http import DataServer

            srv = self.server
            if srv is not None and not srv.closed:
                return srv
            self.server = DataServer(
                self, host=host, port=port, config=config, **server_kwargs
            ).start()
            return self.server
        return self.store.serve(config)

    def serve_ops(self, port: int = 0, host: "str | None" = None):
        return self.store.serve_ops(port=port, host=host)

    def close(self) -> None:
        """Stop the apply loop (joined), close the transport (its socket)
        and the follower's store. The replica loaded its cold store
        itself, so the cold store's services (scheduler, ops plane) close
        here too, and the data plane if one is mounted. Idempotent."""
        srv = self.server
        if srv is not None:
            srv.close()
        self.stop()
        try:
            self.transport.close()
        except OSError:
            pass
        self.store.close()
        self.store.cold.close()
