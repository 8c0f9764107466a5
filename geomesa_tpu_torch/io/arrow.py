"""Arrow columnar output: IPC record-batch streams built from the store's
own columns — no per-row re-encode.

Reference: the server-side Arrow push-down (ArrowScan, 
geomesa-index-api/src/main/scala/org/locationtech/geomesa/index/iterators/
ArrowScan.scala:31-240) builds dictionary-encoded Arrow vectors inside
region servers and streams record batches; DeltaWriter (geomesa-arrow/
geomesa-arrow-gt/src/main/scala/org/locationtech/geomesa/arrow/io/
DeltaWriter.scala) merges per-batch dictionary deltas client-side. The
columnar store inverts the problem: scan hits arrive as *column slices*
(FeatureCollection.take is a numpy fancy-index of whole columns), so the
Arrow table is a zero/near-zero-copy view — string attributes dictionary-
encode via one np.unique pass (one unified dictionary instead of the
reference's delta protocol, which exists only because region servers
cannot see each other's batches), points become FixedSizeList<2 x f64>
vectors (the geomesa-arrow-jts point vector layout), and Dates become
timestamp[ms]. Python row objects are never materialized.
"""

from __future__ import annotations

from typing import IO

import numpy as np

from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.filter.predicates import PointColumn

BATCH_ROWS = 65536


def _pa():
    try:
        import pyarrow as pa
    except ImportError as e:  # pragma: no cover - depends on image contents
        raise RuntimeError("arrow export requires pyarrow, which is not installed") from e
    return pa


def _string_array(pa, col: np.ndarray):
    """A string column as a pyarrow array, preserving nulls (object arrays
    may hold None; numpy str arrays cannot)."""
    if col.dtype.kind == "O":
        return pa.array(col, pa.string(), from_pandas=True)
    return pa.array(col.astype(str))


def _dictionary_array(pa, col: np.ndarray):
    """Dictionary-encode a string column: values array [n_unique] + i32
    codes [n] (reference ArrowScan dictionary vectors); nulls stay null."""
    return _string_array(pa, col).dictionary_encode()


def _geometry_array(pa, fc: FeatureCollection):
    """Point columns -> FixedSizeList<2 x float64> (geomesa-arrow-jts point
    vectors); extent geometries -> WKB binary (per-row by nature)."""
    col = fc.geom_column
    if isinstance(col, PointColumn):
        xy = np.empty(2 * len(fc), dtype=np.float64)
        xy[0::2] = col.x
        xy[1::2] = col.y
        return pa.FixedSizeListArray.from_arrays(pa.array(xy), 2)
    from geomesa_tpu_torch import geometry as geo

    return pa.array([geo.to_wkb(col.geometry(i)) for i in range(len(fc))], pa.binary())


def _id_array(pa, fc: FeatureCollection):
    ids = np.asarray(fc.ids)
    return (
        pa.array(ids.astype(str)) if ids.dtype.kind in ("U", "O", "S")
        else pa.array(ids)
    )


def _attr_array(pa, fc: FeatureCollection, a, dictionary: bool):
    """One attribute as a pyarrow array (shared by the one-shot table
    build and the delta writer, which substitutes its own accumulated
    dictionaries for string columns)."""
    if a.name == fc.sft.geom_field:
        return _geometry_array(pa, fc)
    col = np.asarray(fc.columns[a.name])
    if a.type == "Date":
        return pa.array(col.astype("datetime64[ms]"))
    if a.type in ("String", "UUID"):
        return _dictionary_array(pa, col) if dictionary else _string_array(pa, col)
    if a.type == "Bytes":
        return pa.array(list(col), pa.binary())
    return pa.array(col)


_SFT_KEY = b"geomesa.sft.spec"
_NAME_KEY = b"geomesa.sft.name"


def to_arrow_table(fc: FeatureCollection, dictionary: bool = True):
    """The collection as a pyarrow Table (store columns, no Python rows).
    The SFT spec rides in the schema metadata so IPC payloads are
    self-describing (read_arrow)."""
    pa = _pa()
    names = ["id"]
    arrays = [_id_array(pa, fc)]
    for a in fc.sft.attributes:
        names.append(a.name)
        arrays.append(_attr_array(pa, fc, a, dictionary))
    table = pa.table(dict(zip(names, arrays)))
    return table.replace_schema_metadata(
        {_SFT_KEY: fc.sft.to_spec().encode(), _NAME_KEY: fc.sft.name.encode()}
    )


def read_arrow(source, sft=None) -> FeatureCollection:
    """Decode an Arrow IPC stream written by :func:`arrow_stream` (or the
    delta writer) back into a FeatureCollection — the ingest direction of
    the Arrow interop path. ``source`` is bytes, a path, or a file-like;
    the SFT comes from the stream's schema metadata unless given."""
    import io as _io

    from geomesa_tpu_torch.sft import FeatureType

    pa = _pa()
    import pyarrow.ipc as ipc

    opened = None
    if isinstance(source, (bytes, bytearray)):
        source = _io.BytesIO(source)
    elif isinstance(source, str):
        source = opened = open(source, "rb")
    try:
        with ipc.open_stream(source) as reader:
            table = reader.read_all()
    finally:
        if opened is not None:
            opened.close()
    meta = table.schema.metadata or {}
    if sft is None:
        spec = meta.get(_SFT_KEY)
        if spec is None:
            raise ValueError(
                "stream has no geomesa.sft.spec metadata; pass sft explicitly"
            )
        sft = FeatureType.from_spec(
            meta.get(_NAME_KEY, b"features").decode(), spec.decode()
        )
    return table_to_collection(table, sft)


def arrow_stream(
    fc: FeatureCollection,
    fh: IO | None = None,
    dictionary: bool = True,
    batch_rows: int = BATCH_ROWS,
) -> bytes:
    """Arrow IPC stream of ``fc`` in record batches of ``batch_rows``.

    One unified dictionary per string column (computed over all hits) is
    written once; batches reference it — the client never merges deltas.
    """
    pa = _pa()
    import pyarrow.ipc as ipc

    table = to_arrow_table(fc, dictionary=dictionary)
    sink = pa.BufferOutputStream()
    with ipc.new_stream(sink, table.schema) as w:
        for batch in table.to_batches(max_chunksize=batch_rows):
            w.write_batch(batch)
    payload = sink.getvalue().to_pybytes()
    if fh is not None:
        fh.write(payload)
    return payload


def read_arrow_table(data: bytes):
    """Parse an IPC stream back into a pyarrow Table (the low-level
    sibling of :func:`read_arrow`, which decodes to a FeatureCollection)."""
    pa = _pa()
    import pyarrow.ipc as ipc

    with ipc.open_stream(pa.py_buffer(data)) as r:
        return r.read_all()


class ArrowDeltaWriter:
    """Incremental Arrow IPC stream with dictionary DELTAS — the streaming
    counterpart of :func:`arrow_stream` for results that arrive in batches
    (reference DeltaWriter protocol, geomesa-arrow/.../io/DeltaWriter.scala:
    each batch ships only the dictionary values not seen in earlier
    batches; the reader accumulates).

    Per string column, a value->code map grows across ``write()`` calls;
    batches encode against the accumulated dictionary and pyarrow's
    ``emit_dictionary_deltas`` writes just the new tail. ``finish()``
    closes the stream and returns the full payload.
    """

    def __init__(self, sft, batch_rows: int = BATCH_ROWS):
        self.sft = sft
        self.batch_rows = batch_rows
        self._pa = _pa()
        self._sink = self._pa.BufferOutputStream()
        self._writer = None
        # per string column: accumulated values list + value -> code,
        # plus the cached pyarrow dictionary array (appended, not rebuilt)
        self._dicts: dict[str, tuple[list, dict]] = {}
        self._dict_arrays: dict = {}
        self._string_cols = [
            a.name for a in sft.attributes
            if a.type in ("String", "UUID") and not a.is_geometry
        ]

    def _encode_batch(self, fc: FeatureCollection):
        pa = self._pa
        names = ["id"]
        arrays = [_id_array(pa, fc)]
        for a in fc.sft.attributes:
            names.append(a.name)
            if a.name in self._string_cols:
                arrays.append(self._delta_dictionary(a.name, fc))
            else:
                arrays.append(_attr_array(pa, fc, a, dictionary=False))
        return pa.table(dict(zip(names, arrays)))

    def _delta_dictionary(self, name: str, fc: FeatureCollection):
        """Encode one string column against the accumulated dictionary.
        Nulls (None/NaN in object arrays) stay null slots, never
        dictionary values — matching _string_array's null handling. The
        pyarrow dictionary array is cached and only the new tail is
        appended per batch (rebuilding it from the python list made total
        work quadratic over a long stream)."""
        pa = self._pa
        values, codes_of = self._dicts.setdefault(name, ([], {}))
        raw = np.asarray(fc.columns[name])
        null = (
            np.array(
                [
                    v is None or (isinstance(v, float) and np.isnan(v))
                    for v in raw
                ],
                dtype=bool,
            )
            if raw.dtype.kind == "O" else np.zeros(len(raw), dtype=bool)
        )
        codes = np.zeros(len(raw), dtype=np.int32)
        present = raw[~null]
        n_before = len(values)
        if len(present):
            u, inv = np.unique(present.astype(str), return_inverse=True)
            code_of_u = np.empty(len(u), dtype=np.int32)
            for j, v in enumerate(u.tolist()):  # uniques only
                c = codes_of.get(v)
                if c is None:
                    c = codes_of[v] = len(values)
                    values.append(v)
                code_of_u[j] = c
            codes[~null] = code_of_u[inv]
        cached = self._dict_arrays.get(name)
        if cached is None or len(values) != len(cached):
            tail = pa.array(values[n_before:], pa.string())
            cached = tail if cached is None else pa.concat_arrays([cached, tail])
            self._dict_arrays[name] = cached
        return pa.DictionaryArray.from_arrays(pa.array(codes, mask=null), cached)

    def write(self, fc: FeatureCollection) -> None:
        pa = self._pa
        table = self._encode_batch(fc)
        if self._writer is None:
            # same self-describing metadata as to_arrow_table, so delta
            # streams round-trip through read_arrow without an sft
            schema = table.schema.with_metadata(
                {_SFT_KEY: self.sft.to_spec().encode(),
                 _NAME_KEY: self.sft.name.encode()}
            )
            self._writer = pa.ipc.new_stream(
                self._sink, schema,
                options=pa.ipc.IpcWriteOptions(emit_dictionary_deltas=True),
            )
        for batch in table.to_batches(max_chunksize=self.batch_rows):
            self._writer.write_batch(batch)

    def finish(self) -> bytes:
        if self._writer is not None:
            self._writer.close()
        return self._sink.getvalue().to_pybytes()


def flat_point_table(fc: FeatureCollection, dictionary: bool = True):
    """Arrow table with point geometries flattened to ``<geom>_x`` /
    ``<geom>_y`` double columns — the shared layout of the Parquet and
    ORC writers (flat columns carry per-group/stripe statistics; nested
    FixedSizeList columns do not)."""
    import numpy as np

    from geomesa_tpu_torch.filter.predicates import PointColumn

    pa = _pa()
    table = to_arrow_table(fc, dictionary=dictionary)
    geom = fc.sft.geom_field
    if geom is not None and isinstance(fc.geom_column, PointColumn):
        i = table.schema.get_field_index(geom)
        table = table.remove_column(i)
        col = fc.geom_column
        table = table.append_column(f"{geom}_x", pa.array(np.asarray(col.x)))
        table = table.append_column(f"{geom}_y", pa.array(np.asarray(col.y)))
    return table


def table_to_collection(table, sft) -> FeatureCollection:
    """Decode an arrow Table in the flat_point_table layout back into a
    FeatureCollection — the single reader shared by the Parquet and ORC
    formats (point x/y or WKB geometry, Date millis, dictionary or plain
    strings, Bytes blobs)."""
    import numpy as np

    from geomesa_tpu_torch import geometry as geo

    geom = sft.geom_field
    cols: dict = {}
    for a in sft.attributes:
        if a.name == geom:
            if f"{geom}_x" in table.column_names:  # flat parquet/orc layout
                cols[geom] = (
                    np.asarray(table[f"{geom}_x"], dtype=np.float64),
                    np.asarray(table[f"{geom}_y"], dtype=np.float64),
                )
                continue
            arr = table[geom].combine_chunks()
            import pyarrow as pa

            if pa.types.is_fixed_size_list(arr.type):  # IPC point vectors
                xy = np.asarray(arr.flatten(), dtype=np.float64)
                cols[geom] = (xy[0::2], xy[1::2])
            else:  # WKB binary
                cols[geom] = geo.PackedGeometryColumn.from_geometries(
                    [geo.from_wkb(b) for b in arr.to_pylist()]
                )
            continue
        arr = table[a.name]
        if a.type == "Date":
            cols[a.name] = np.asarray(arr).astype("datetime64[ms]").astype(np.int64)
        elif a.type in ("String", "UUID", "Bytes"):
            a2 = arr.combine_chunks()
            try:  # dictionary-encoded on write (parquet)
                a2 = a2.dictionary_decode()
            except AttributeError:
                pass
            cols[a.name] = np.asarray(a2.to_pylist(), dtype=object)
        else:
            cols[a.name] = np.asarray(arr)
    return FeatureCollection.from_columns(sft, np.asarray(table["id"]), cols)
