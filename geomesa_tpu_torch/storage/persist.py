"""Store persistence: save and load a DataStore's schemas and data.

The port's copy of geomesa_tpu/storage/persist.py (reference geomesa-fs:
a partition-scheme directory of metadata and columnar files). Each
feature type persists as .npz column files, one per coarse time
partition (partition = dtg // PARTITION_MS, 28 days; atemporal types
collapse to partition 0). Saves are INCREMENTAL: a partition whose
content signature matches the manifest is not rewritten.

Format v3 is crash-safe:

- every file lands through temp file + fsync + ``os.replace``, so no
  reader sees a torn file;
- partition files are content-addressed (``p<NNNN>-<sig16>.npz``): a
  changed partition gets a new name, and the committed file it replaces
  stays until the manifest commits, so the old manifest describes a
  whole old store at every instant;
- ``metadata.json``, written LAST and atomically, carries a blake2b
  checksum and byte length per partition; its rename is the commit
  point, so a crash leaves either the old or the new store;
- unreferenced files are collected only AFTER the commit;
- ``load()`` verifies every partition against the manifest, moves
  damaged files to ``<root>/_quarantine/`` with a machine-readable
  report, builds the indexes from the survivors, and marks the store's
  :class:`StoreHealth` degraded, so queries carry a warning.

Every IO step is a named ``fault_point`` (geomesa_tpu_torch.fault), and
the transient-failure steps retry with bounded backoff. The on-disk
format is the JAX package's: a store saved by either package loads in
the other.

Index tables are built again on load from the features (on the store's
device: ``load(root, device="cuda")`` builds every table on the card);
indexes are derived state.

Layout:  <root>/metadata.json               (manifest; the commit point)
         <root>/<type>/p<NNNN>-<sig>.npz    (content-addressed partitions)
         <root>/_quarantine/                (damaged files + report.json)
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import time
from dataclasses import dataclass, field

import numpy as np

from geomesa_tpu_torch import geometry as geo
from geomesa_tpu_torch.fault import atomic_write, fault_point, with_retries
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import PointColumn
from geomesa_tpu_torch.sft import FeatureType

FORMAT_VERSION = 3
PARTITION_MS = 28 * 86_400_000  # ~monthly time partitions (DateTimeScheme)
QUARANTINE_DIR = "_quarantine"

_SAFE_NAME = re.compile(r"^[A-Za-z0-9_.-]+$")


class StoreCorruptionError(ValueError):
    """The store's manifest (or, with ``on_damage="raise"``, a data file)
    is damaged beyond what degraded-mode loading can contain."""


@dataclass
class DamageRecord:
    """One damaged/missing partition file found during load — the
    machine-readable unit of ``_quarantine/report.json``."""

    type_name: str
    file: str                 # manifest-relative file name
    reason: str               # "missing"|"truncated"|"checksum"|"unreadable"|"manifest"
    detail: str = ""
    rows_lost: int = 0        # manifest row count of the damaged partition
    quarantined_to: str | None = None
    # first sighting: False when report.json already records this file —
    # re-loading a degraded store must not re-count old damage in metrics
    fresh: bool = True

    def to_json(self) -> dict:
        return {
            "type": self.type_name,
            "file": self.file,
            "reason": self.reason,
            "detail": self.detail,
            "rows_lost": self.rows_lost,
            "quarantined_to": self.quarantined_to,
        }


@dataclass
class StoreHealth:
    """Damage accounting surfaced as ``DataStore.store_health``. A store
    that loaded with quarantined partitions answers queries in DEGRADED
    mode: results are exact over the surviving rows, and every plan over
    a damaged type carries a warning (planner + metrics counter)."""

    damage: list[DamageRecord] = field(default_factory=list)

    @property
    def status(self) -> str:
        return "degraded" if self.damage else "ok"

    @property
    def ok(self) -> bool:
        return not self.damage

    def degraded_types(self) -> set:
        return {d.type_name for d in self.damage}

    def damage_for(self, type_name: str) -> list[DamageRecord]:
        return [d for d in self.damage if d.type_name == type_name]

    def warning_for(self, type_name: str) -> str | None:
        """The per-query degraded-mode warning, or None when healthy."""
        recs = self.damage_for(type_name)
        if not recs:
            return None
        rows = sum(r.rows_lost for r in recs)
        return (
            f"results for {type_name!r} exclude {len(recs)} quarantined "
            f"partition(s) (~{rows} rows): "
            + ", ".join(f"{r.file} [{r.reason}]" for r in recs)
        )


def _id_token(v) -> bytes:
    """Unambiguous per-id encoding: length-prefixed + type-tagged, so
    ``"1"``/``1``/``b"1"`` hash apart and an id containing the old
    ``\\n`` separator cannot alias a neighboring pair."""
    if isinstance(v, bytes):
        tag, payload = b"b", v
    elif isinstance(v, str):
        tag, payload = b"s", v.encode("utf-8")
    elif isinstance(v, (bool, np.bool_)):
        tag, payload = b"B", b"1" if v else b"0"
    elif isinstance(v, (int, np.integer)):
        tag, payload = b"i", str(int(v)).encode()
    elif isinstance(v, (float, np.floating)):
        tag, payload = b"f", repr(float(v)).encode()
    else:
        tag, payload = b"o", str(v).encode("utf-8")
    return len(payload).to_bytes(8, "little") + tag + payload


def _hash_packed(h, packed: dict) -> None:
    """Fold a partition's packed columns into a digest. String arrays
    hash through a width-independent length-prefixed encoding — numpy
    unicode itemsize grows with the longest value ANYWHERE in the type,
    and padding bytes must not change untouched partitions' signatures."""
    for key in sorted(packed):
        a = np.asarray(packed[key])
        h.update(b"\x00k" + key.encode())
        if a.dtype.kind in ("U", "S"):
            h.update(b"\x00s")
            for v in a.tolist():
                payload = v.encode("utf-8") if isinstance(v, str) else v
                h.update(len(payload).to_bytes(8, "little") + payload)
        else:
            h.update(b"\x00n" + str(a.dtype).encode() + str(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())


def _signature(ids: np.ndarray, packed: dict) -> str:
    """Content signature of a partition: row count + ids + the packed
    column BYTES. Ids alone detect membership changes, but updates
    (upsert / modify_features / the streaming flush) replace VALUES under
    unchanged ids — the value bytes must be covered or the incremental
    skip silently persists stale data. Ids additionally hash in a
    type-tagged, length-prefixed encoding so an object-dtype mix of
    str/bytes/int ids cannot collide through a common ``str()`` form.
    blake2b streams at memory bandwidth; the cost of hashing unchanged
    partitions is far below rewriting (compressing) them."""
    h = hashlib.blake2b(digest_size=16)
    ids = np.asarray(ids)
    h.update(str(len(ids)).encode())
    if ids.dtype.kind in ("U", "S", "O"):
        for v in ids:
            h.update(_id_token(v))
    else:
        h.update(np.ascontiguousarray(ids).tobytes())
    _hash_packed(h, packed)
    return h.hexdigest()


def _partition_ids(fc: FeatureCollection, dtg_field: str | None) -> np.ndarray:
    if dtg_field is None or len(fc) == 0:
        return np.zeros(len(fc), dtype=np.int64)
    return np.asarray(fc.columns[dtg_field], dtype=np.int64) // PARTITION_MS


# -- durable file primitives ------------------------------------------------

def _write_partition(final_path: str, packed: dict) -> dict:
    """Durably write one partition file: serialize in memory, digest the
    exact bytes, land them atomically (fault.atomic_write), retried on
    transient IO errors. Returns the manifest entry fragment
    {"checksum", "bytes"}."""

    def attempt() -> dict:
        buf = io.BytesIO()
        np.savez_compressed(buf, **packed)
        data = buf.getvalue()
        checksum = hashlib.blake2b(data, digest_size=16).hexdigest()
        atomic_write(final_path, data, point="persist.partition")
        # post-commit point: bit_flip/partial_write here damage the
        # DURABLE bytes after their checksum was recorded — the silent
        # media-corruption scenario load() must catch
        fault_point("persist.partition.commit", final_path)
        return {"checksum": checksum, "bytes": len(data)}

    return with_retries(attempt)


def _commit_manifest(root: str, meta: dict) -> None:
    """The commit point: metadata.json lands atomically, LAST."""
    meta_path = os.path.join(root, "metadata.json")

    def attempt() -> None:
        atomic_write(
            meta_path, json.dumps(meta, indent=2).encode(),
            point="persist.manifest",
        )
        fault_point("persist.manifest.commit", meta_path)

    with_retries(attempt)


def _read_manifest(root: str) -> dict | None:
    """Best-effort read of the existing manifest (for incremental reuse);
    None when absent or unreadable — save() then rewrites everything."""
    meta_path = os.path.join(root, "metadata.json")
    if not os.path.exists(meta_path):
        return None
    try:
        with open(meta_path) as fh:
            return json.load(fh)
    except (ValueError, OSError):
        return None


# -- save -------------------------------------------------------------------

def save(store, root: str) -> None:
    """Persist every schema + feature batch under ``root``. Incremental:
    partitions whose content signature matches the committed manifest are
    not rewritten. Crash-safe: a failure at ANY point (fault-injectable;
    see geomesa_tpu_torch.fault) leaves either the previous committed store or
    the new one — never a torn mix."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    old = _read_manifest(root)
    old_parts: dict = {}
    if old is not None and old.get("version") == FORMAT_VERSION:
        for t, info in old.get("types", {}).items():
            old_parts[t] = info.get("partitions", {})
    meta: dict = {"version": FORMAT_VERSION, "types": {}}
    referenced: dict[str, set] = {}
    for name in store.type_names():
        if not _SAFE_NAME.match(name) or name == QUARANTINE_DIR:
            raise ValueError(
                f"feature type name {name!r} is not filesystem-safe "
                f"([A-Za-z0-9_.-] only, not {QUARANTINE_DIR!r}) — "
                "cannot persist"
            )
        sft = store.get_schema(name)
        info = {
            "spec": sft.to_spec(),
            "user_data": {str(k): str(v) for k, v in sft.user_data.items()},
        }
        fc = store.features(name)
        parts = _partition_ids(fc, sft.dtg_field)
        tdir = os.path.join(root, name)
        os.makedirs(tdir, exist_ok=True)
        manifest: dict = {}
        prev = old_parts.get(name, {})
        for p in np.unique(parts) if len(fc) else []:
            idx = np.flatnonzero(parts == p)
            sub = fc.take(idx)
            packed = _pack_columns(sft, sub)
            sig = _signature(np.asarray(sub.ids), packed)
            pkey = f"p{int(p)}"
            pe = prev.get(pkey)
            if (
                isinstance(pe, dict)
                and pe.get("sig") == sig
                and os.path.exists(os.path.join(tdir, str(pe.get("file"))))
            ):
                manifest[pkey] = pe  # unchanged: reuse the committed file
                continue
            fname = f"{pkey}-{sig[:16]}.npz"
            entry = _write_partition(os.path.join(tdir, fname), packed)
            manifest[pkey] = {
                "file": fname, "sig": sig, "rows": int(len(idx)), **entry,
            }
        info["partitions"] = manifest
        meta["types"][name] = info
        referenced[name] = {e["file"] for e in manifest.values()}
    _commit_manifest(root, meta)
    _collect_garbage(root, referenced)


def _collect_garbage(root: str, referenced: dict) -> None:
    """Drop files the committed manifest no longer references: replaced
    partition versions, stale tmps, pre-v3 layouts, and whole directories
    of types the store no longer has (delete_schema'd data must not
    linger on disk). Runs strictly AFTER the manifest commit; a crash
    here only leaves orphans, which load() ignores and the next save()
    sweeps."""
    fault_point("persist.gc", root)

    def _rm(path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass

    for entry in os.listdir(root):
        path = os.path.join(root, entry)
        if os.path.isdir(path):
            if entry == QUARANTINE_DIR:
                continue
            keep = referenced.get(entry, set())  # dropped type: keep nothing
            for f in os.listdir(path):
                if f not in keep and (f.endswith(".npz") or f.endswith(".tmp")):
                    _rm(os.path.join(path, f))
            if entry not in referenced:
                try:
                    os.rmdir(path)  # only succeeds when fully swept
                except OSError:
                    pass
        elif entry.endswith(".npz"):
            # root-level npz files are pre-v3 layouts (current types'
            # legacy copies, or dropped types') — all superseded
            _rm(path)


# -- load -------------------------------------------------------------------

def _manifest_int(v, default: int = 0) -> int:
    """Tolerant int for manifest fields: garbage in a torn entry must
    read as a verification mismatch, not abort the load."""
    try:
        return int(v)
    except (TypeError, ValueError):
        return default


def _read_bytes(path: str) -> bytes:
    """One full read of a partition file, retried on transient IO
    errors — both the checksum and np.load consume this single buffer,
    so the load path reads every file exactly once."""

    def attempt() -> bytes:
        fault_point("load.partition.read", path)
        with open(path, "rb") as fh:
            return fh.read()

    return with_retries(attempt)


def _quarantine(root: str, type_name: str, path: str, fname: str,
                reason: str, detail: str, rows: int) -> DamageRecord:
    """Move a damaged file under ``<root>/_quarantine/<type>/`` and
    append a machine-readable record to ``_quarantine/report.json``.
    All filesystem work here is best-effort: a store on a read-only
    mount must still LOAD degraded (in-memory health intact) even when
    nothing can be moved or logged."""
    qdir = os.path.join(root, QUARANTINE_DIR, type_name)
    dest: str | None = None
    if os.path.exists(path):
        try:
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(qdir, fname)
            os.replace(path, dest)
        except OSError:
            dest = None
    rec = DamageRecord(
        type_name=type_name, file=fname, reason=reason, detail=detail,
        rows_lost=rows,
        quarantined_to=(
            os.path.relpath(dest, root) if dest is not None else None
        ),
    )
    try:
        rec.fresh = _append_damage_record(root, rec)
    except OSError:
        pass
    return rec


def _append_damage_record(root: str, rec: DamageRecord) -> bool:
    """One report.json record per damaged FILE: re-loading an
    already-degraded store re-detects the same hole every time (the
    quarantined file now reads as "missing") and must not inflate the
    report with a duplicate record per load. Returns whether the record
    was new."""
    report = os.path.join(root, QUARANTINE_DIR, "report.json")
    os.makedirs(os.path.dirname(report), exist_ok=True)
    records: list = []
    if os.path.exists(report):
        try:
            with open(report) as fh:
                records = json.load(fh).get("damage", [])
        except (ValueError, OSError):
            records = []
    if any(
        r.get("type") == rec.type_name and r.get("file") == rec.file
        for r in records
    ):
        return False
    records.append({**rec.to_json(), "time": time.time()})
    atomic_write(report, json.dumps({"damage": records}, indent=2).encode())
    return True


def _load_npz(path: str, sft: FeatureType) -> FeatureCollection:
    def attempt() -> FeatureCollection:
        fault_point("load.partition.read", path)
        with np.load(path, allow_pickle=False) as z:
            return _unpack_columns(sft, z)

    return with_retries(attempt)


def load(root: str, on_damage: str = "quarantine", **store_kwargs):
    """Rebuild a DataStore (indexes re-derived) from a saved directory.
    Reads the v3 checksummed layout plus the legacy v1/v2 layouts.

    v3 loads are VERIFIED: every partition file is checked against the
    manifest's byte length + blake2b checksum and must unpack cleanly.
    Damage handling (``on_damage``):

    - ``"quarantine"`` (default): damaged files move to
      ``<root>/_quarantine/`` with a machine-readable ``report.json``
      record; the store loads the surviving partitions and its
      ``store_health`` turns DEGRADED (queries warn, metrics count);
    - ``"raise"``: raise :class:`StoreCorruptionError` on first damage.
    """
    from geomesa_tpu_torch.datastore import DataStore

    root = str(root)
    if on_damage not in ("quarantine", "raise"):
        raise ValueError(f"on_damage must be 'quarantine' or 'raise', got {on_damage!r}")
    meta_path = os.path.join(root, "metadata.json")
    try:
        with open(meta_path) as fh:
            meta = json.load(fh)
    except ValueError as e:
        raise StoreCorruptionError(
            f"store manifest {meta_path} is not valid JSON: {e}"
        ) from e
    if meta.get("version") not in (1, 2, FORMAT_VERSION):
        raise ValueError(f"unsupported store format {meta.get('version')!r}")
    store = DataStore(**store_kwargs)
    health = StoreHealth()
    for name, info in meta["types"].items():
        if not _SAFE_NAME.match(name) or name == QUARANTINE_DIR:
            raise StoreCorruptionError(
                f"unsafe feature type name in metadata: {name!r}"
            )
        sft = FeatureType.from_spec(name, info["spec"])
        sft.user_data.update(info.get("user_data", {}))
        store.create_schema(sft)
        if meta.get("version") == FORMAT_VERSION:
            pieces = _load_v3_type(root, name, sft, info, health, on_damage)
        else:
            pieces = _load_legacy_type(root, name, sft, info)
        pieces = [p for p in pieces if len(p)]
        if pieces:
            # one batch through the staged ingest pipeline: key encoding
            # and the (bin, z) sorts of the indexes run on worker threads,
            # and the merged sort feeds the table build directly (a single
            # chunk keeps the stats fold that of one write)
            from geomesa_tpu_torch.ingest import BulkLoader

            fc = pieces[0] if len(pieces) == 1 else FeatureCollection.concat(pieces)
            loader = BulkLoader(store, name, check_ids=False)
            loader.put(fc)
            loader.close()
    store.health = health
    cache = getattr(store, "cache", None)
    if cache is not None:
        # a reload is a mutation over every loaded type, one that loads
        # zero rows included: the on-disk state may be older than what
        # warm entries saw (unsaved writes roll back across a crash)
        for name in meta["types"]:
            cache.on_mutation(name)
    if cache is not None and health.damage:
        # a warm cache passed through ``load(root, cache=...)`` keeps no
        # entry over a quarantined partition's key range: bump and drop
        for d in health.damage:
            cache.on_quarantine(d.type_name, _partition_interval(d.file))
    fresh = sum(1 for d in health.damage if d.fresh)
    if fresh:
        from geomesa_tpu_torch.metrics import resolve

        resolve(getattr(store, "metrics", None)).counter(
            "geomesa.store.quarantined", fresh
        )
    return store


_PART_FILE = re.compile(r"^p(-?\d+)")


def _partition_interval(fname) -> "tuple[int, int] | None":
    """The [lo_ms, hi_ms) time interval a partition file covers, parsed
    from its ``p<NNNN>[-sig]`` name (partition = dtg // PARTITION_MS, so
    the cache tier's generation buckets align 1:1). None when the name
    does not parse: the quarantine bump then covers the whole time
    axis."""
    m = _PART_FILE.match(str(fname))
    if m is None:
        return None
    p = int(m.group(1))
    return (p * PARTITION_MS, (p + 1) * PARTITION_MS)


def _load_v3_type(root: str, name: str, sft: FeatureType, info: dict,
                  health: StoreHealth, on_damage: str) -> list:
    pieces: list = []
    for pkey in sorted(info.get("partitions", {})):
        entry = info["partitions"][pkey]
        if not isinstance(entry, dict):
            entry = {}
        fname = str(entry.get("file", ""))
        if not _SAFE_NAME.match(fname):
            # a torn/hostile manifest entry is ITS OWN damage, contained
            # per-entry like any other: the intact types and partitions
            # must still load (never join paths with an unsafe name)
            if on_damage == "raise":
                raise StoreCorruptionError(
                    f"manifest entry {name}/{pkey} has an unsafe or "
                    f"missing file name: {fname!r}"
                )
            health.damage.append(_quarantine(
                root, name, "", fname or pkey, "manifest",
                f"unsafe or missing file name: {fname!r}",
                _manifest_int(entry.get("rows")),
            ))
            continue
        path = os.path.join(root, name, fname)
        rows = _manifest_int(entry.get("rows"))
        reason, detail = None, ""
        if not os.path.exists(path):
            reason = "missing"
        else:
            # one read serves verification AND unpacking; an OSError here
            # (past retries) is a transient media failure, not damage —
            # propagate rather than quarantining possibly-healthy data
            data = _read_bytes(path)
            if len(data) != _manifest_int(entry.get("bytes"), default=-1):
                reason = "truncated"
            elif (
                hashlib.blake2b(data, digest_size=16).hexdigest()
                != entry.get("checksum")
            ):
                reason = "checksum"
            else:
                try:
                    with np.load(io.BytesIO(data), allow_pickle=False) as z:
                        pieces.append(_unpack_columns(sft, z))
                    continue
                except Exception as e:  # zip/np damage past the checksum
                    reason, detail = "unreadable", f"{type(e).__name__}: {e}"
        if on_damage == "raise":
            raise StoreCorruptionError(
                f"partition {name}/{fname} failed verification ({reason}"
                + (f": {detail}" if detail else "") + ")"
            )
        health.damage.append(
            _quarantine(root, name, path, fname, reason, detail, rows)
        )
    return pieces


def _load_legacy_type(root: str, name: str, sft: FeatureType, info: dict) -> list:
    """The pre-v3 unverified layouts: v2 per-partition files under a
    manifest of content signatures, v1 one npz per type."""
    pieces: list = []
    if "partitions" in info:
        for fname in sorted(info["partitions"]):
            if not _SAFE_NAME.match(fname):
                raise ValueError(f"unsafe partition file name: {fname!r}")
            pieces.append(_load_npz(os.path.join(root, name, fname), sft))
    else:
        pieces.append(_load_npz(os.path.join(root, f"{name}.npz"), sft))
    return pieces


def damage_report(root: str) -> list[dict]:
    """The quarantine log for a store directory (machine-readable; every
    record carries type/file/reason/rows_lost/quarantined_to/time)."""
    report = os.path.join(str(root), QUARANTINE_DIR, "report.json")
    if not os.path.exists(report):
        return []
    with open(report) as fh:
        return json.load(fh).get("damage", [])


# -- column packing ---------------------------------------------------------

def _plain_array(col) -> np.ndarray:
    """npz-safe array: object columns (python strings, possibly None)
    become fixed-width unicode — loading is allow_pickle=False, so an
    object array would fail the round-trip."""
    a = np.asarray(col)
    if a.dtype.kind == "O":
        a = np.array(["" if v is None else str(v) for v in a])
    return a


def _pack_columns(sft: FeatureType, fc: FeatureCollection) -> dict:
    types = {a.name: a.type for a in sft.attributes}
    out: dict = {"__ids__": _plain_array(fc.ids)}
    for name, col in fc.columns.items():
        if isinstance(col, PointColumn):
            out[f"pt:{name}:x"] = col.x
            out[f"pt:{name}:y"] = col.y
        elif isinstance(col, geo.PackedGeometryColumn):
            out[f"pg:{name}:coords"] = col.coords
            out[f"pg:{name}:ring_offsets"] = col.ring_offsets
            out[f"pg:{name}:part_ring_offsets"] = col.part_ring_offsets
            out[f"pg:{name}:geom_part_offsets"] = col.geom_part_offsets
            out[f"pg:{name}:types"] = col.types
            out[f"pg:{name}:bboxes"] = col.bboxes
        elif types.get(name) == "Bytes":
            # variable-length binary: one concatenated buffer + offsets +
            # null mask (str()-ing bytes would corrupt them; a mask keeps
            # None distinct from a genuinely empty payload)
            arr = np.asarray(col)
            vals = [b"" if v is None else bytes(v) for v in arr]
            out[f"by:{name}:data"] = np.frombuffer(
                b"".join(vals), dtype=np.uint8
            )
            out[f"by:{name}:offsets"] = np.cumsum(
                [0] + [len(v) for v in vals]
            ).astype(np.int64)
            out[f"by:{name}:null"] = np.array(
                [v is None for v in arr], dtype=bool
            )
        else:
            out[f"col:{name}"] = _plain_array(col)
    return out


def _unpack_columns(sft: FeatureType, z) -> FeatureCollection:
    cols: dict = {}
    names = set(z.files)
    for attr in sft.attributes:
        n = attr.name
        if f"pt:{n}:x" in names:
            cols[n] = PointColumn(z[f"pt:{n}:x"], z[f"pt:{n}:y"])
        elif f"pg:{n}:coords" in names:
            cols[n] = geo.PackedGeometryColumn(
                coords=z[f"pg:{n}:coords"],
                ring_offsets=z[f"pg:{n}:ring_offsets"],
                part_ring_offsets=z[f"pg:{n}:part_ring_offsets"],
                geom_part_offsets=z[f"pg:{n}:geom_part_offsets"],
                types=z[f"pg:{n}:types"],
                bboxes=z[f"pg:{n}:bboxes"],
            )
        elif f"by:{n}:data" in names:
            data = z[f"by:{n}:data"].tobytes()
            offs = z[f"by:{n}:offsets"]
            null = z[f"by:{n}:null"] if f"by:{n}:null" in names else None
            vals = np.empty(len(offs) - 1, dtype=object)
            vals[:] = [
                None if null is not None and null[i]
                else data[offs[i] : offs[i + 1]]
                for i in range(len(offs) - 1)
            ]
            cols[n] = vals
        elif f"col:{n}" in names:
            cols[n] = z[f"col:{n}"]
        else:
            raise KeyError(f"column {n!r} missing from saved store")
    return FeatureCollection(sft, z["__ids__"], cols)
