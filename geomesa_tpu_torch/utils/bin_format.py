"""BIN format: compact 16/24-byte track-point records.

The port's copy of geomesa_tpu/utils/bin_format.py. Reference:
BinaryOutputEncoder (geomesa-utils-parent/
geomesa-utils/src/main/scala/org/locationtech/geomesa/utils/bin/
BinaryOutputEncoder.scala + BinaryOutputCallback.scala:28-42). Wire layout
(little-endian, byte-compatible with the reference):

    [trackId i32][dtg seconds i32][lat f32][lon f32]           (16 bytes)
    [trackId i32][dtg seconds i32][lat f32][lon f32][label u64] (24 bytes)

The reference encodes one feature at a time through a callback; here whole
columns encode in one vectorized structured-array write, and decode returns
columns. Track ids are 32-bit string hashes of the track attribute
(reference uses String.hashCode of the track value; we use FNV-1a folded to
i32 — ids are opaque correlation keys, not interchange values).
"""

from __future__ import annotations

import numpy as np

RECORD = np.dtype(
    [("track", "<i4"), ("dtg", "<i4"), ("lat", "<f4"), ("lon", "<f4")]
)
RECORD_LABEL = np.dtype(
    [("track", "<i4"), ("dtg", "<i4"), ("lat", "<f4"), ("lon", "<f4"), ("label", "<u8")]
)


def track_ids(col: np.ndarray) -> np.ndarray:
    """i32 correlation ids from an arbitrary column (vectorized FNV-1a over
    the full fixed-width value, so long values sharing a prefix still get
    distinct ids)."""
    col = np.asarray(col)
    if col.dtype.kind in "iu":
        return col.astype(np.int64).astype(np.int32)
    if len(col) == 0:
        return np.zeros(0, dtype=np.int32)
    from geomesa_tpu_torch.utils.hashing import fnv_fold

    h = fnv_fold(col)
    return (h & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)


def label_u64(col: np.ndarray) -> np.ndarray:
    """u64 labels: first 8 bytes of the UTF-8 value, zero-padded (reference
    Convert2ViewerFunction label semantics)."""
    col = np.asarray(col)
    if col.dtype.kind in "iu":
        return col.astype(np.uint64)
    if len(col) == 0:
        return np.zeros(0, dtype=np.uint64)
    raw = np.char.encode(col.astype("U8"), "utf-8").astype("S8")
    return np.frombuffer(raw.tobytes(), dtype="<u8").astype(np.uint64)


def encode(
    lon: np.ndarray,
    lat: np.ndarray,
    dtg_millis: np.ndarray,
    track: np.ndarray,
    label: np.ndarray | None = None,
    sort: bool = False,
) -> bytes:
    """Encode columns into concatenated BIN records."""
    n = len(lon)
    rec = np.empty(n, dtype=RECORD_LABEL if label is not None else RECORD)
    rec["track"] = track_ids(track) if track is not None else np.zeros(n, np.int32)
    rec["dtg"] = (np.asarray(dtg_millis, dtype=np.int64) // 1000).astype(np.int32)
    rec["lat"] = np.asarray(lat, dtype=np.float32)
    rec["lon"] = np.asarray(lon, dtype=np.float32)
    if label is not None:
        rec["label"] = label_u64(label)
    if sort:  # reference sorts by the 4 date bytes (BinaryOutputEncoder.DateOrdering)
        rec = rec[np.argsort(rec["dtg"], kind="stable")]
    return rec.tobytes()


def decode(data: bytes, label: bool = False) -> dict:
    """Decode concatenated BIN records back into columns."""
    rec = np.frombuffer(data, dtype=RECORD_LABEL if label else RECORD)
    out = {
        "track": rec["track"].copy(),
        "dtg_s": rec["dtg"].copy(),
        "lat": rec["lat"].copy(),
        "lon": rec["lon"].copy(),
    }
    if label:
        out["label"] = rec["label"].copy()
    return out
