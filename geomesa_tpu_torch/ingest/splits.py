"""Input splits + the picklable converter config (the mapper-side half
of the distributed ingest).

Reference: ConverterInputFormat (geomesa-jobs/src/main/
scala/org/locationtech/geomesa/jobs/mapreduce/) splits inputs at byte
ranges and mappers rebuild the converter from the job config. This module
absorbs the split logic that used to live in ``io/ingest.py`` (that module
re-exports for compatibility): large delimited files split at line
boundaries into byte-range tasks so one big CSV parallelizes like many
small files; JSON/XML/Avro documents stay whole.

Workers run :func:`run_split_guarded`: the split read is a named fault
point (``ingest.split.read``) under bounded retry, and any worker failure
— including a :class:`~geomesa_tpu_torch.fault.InjectedCrash`, which a
``multiprocessing`` pool would otherwise turn into a hung worker — comes
back as a *value* carrying the formatted traceback, so the caller can
re-raise deterministically (ordered by split) instead of losing the
worker-side stack.
"""

from __future__ import annotations

import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional, Sequence

from geomesa_tpu_torch.fault import fault_point, with_retries
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.io.converters import Converter, FieldSpec
from geomesa_tpu_torch.sft import FeatureType

# a split per ~32 MB keeps task granularity reasonable for big files
SPLIT_BYTES = 32 << 20


@dataclass
class ConverterConfig:
    """Picklable converter description (the mapper-side job config)."""

    spec: str
    type_name: str
    fields: Sequence[tuple]  # (name, transform)
    id_field: Optional[str]
    fmt: str
    delimiter: str
    skip_lines: int
    drop_errors: bool
    xml_feature_tag: Optional[str]
    user_data: dict = field(default_factory=dict)
    # validator NAMES (io.validators.parse_validators spec) — the
    # picklable form. Custom Validator OBJECTS cannot cross the pool:
    # they ride ``live_validators`` instead, which works for the
    # in-process (workers <= 1) ingest paths and raises the clear error
    # at PICKLE time if a pool ever tries to ship them (__getstate__).
    validators: Optional[str] = None
    live_validators: "object | None" = None

    @staticmethod
    def of(conv: Converter) -> "ConverterConfig":
        from geomesa_tpu_torch.io.validators import validator_spec

        try:
            vspec, live = validator_spec(conv.validators), None
        except ValueError:
            vspec, live = None, conv.validators
        return ConverterConfig(
            spec=conv.sft.to_spec(),
            type_name=conv.sft.name,
            fields=[(f.name, f.transform) for f in conv.fields],
            id_field=conv.id_field,
            fmt=conv.fmt,
            delimiter=conv.delimiter,
            skip_lines=conv.skip_lines,
            drop_errors=conv.drop_errors,
            xml_feature_tag=conv.xml_feature_tag,
            user_data=dict(conv.sft.user_data),
            validators=vspec,
            live_validators=live,
        )

    def __getstate__(self):
        if self.live_validators is not None:
            raise ValueError(
                "custom Validator objects are not picklable for "
                "multi-process ingest; pass validator NAMES or run with "
                "workers<=1"
            )
        return self.__dict__

    def build(self) -> Converter:
        sft = FeatureType.from_spec(self.type_name, self.spec)
        sft.user_data.update(self.user_data)
        return Converter(
            sft=sft,
            fields=[FieldSpec(n, t) for n, t in self.fields],
            id_field=self.id_field,
            fmt=self.fmt,
            delimiter=self.delimiter,
            skip_lines=self.skip_lines,
            drop_errors=self.drop_errors,
            xml_feature_tag=self.xml_feature_tag,
            validators=(
                self.validators if self.live_validators is None
                else self.live_validators
            ),
        )


@dataclass(frozen=True)
class Split:
    """One mapper task: a byte range of one input file (the
    ConverterInputFormat split analogue). ``skip_header`` drops the
    configured header lines (first split of a delimited file only)."""

    path: str
    start: int
    end: int  # exclusive
    skip_header: bool


def plan_splits(
    paths: Sequence[str], fmt: str, split_bytes: int | None = None
) -> list[Split]:
    """Input files -> mapper splits. Only delimited files split mid-file
    (line-oriented); JSON/XML/Avro documents stay whole."""
    if split_bytes is None:
        split_bytes = SPLIT_BYTES  # read at call time so tests/config can tune
    out: list[Split] = []
    for path in paths:
        size = os.path.getsize(path)
        if fmt != "delimited" or size <= split_bytes:
            out.append(Split(path, 0, size, True))
            continue
        with open(path, "rb") as fh:
            start = 0
            while start < size:
                end = min(start + split_bytes, size)
                if end < size:  # advance to the next line boundary
                    fh.seek(end)
                    fh.readline()
                    end = fh.tell()
                out.append(Split(path, start, end, start == 0))
                start = end
    return out


def _read_split(split: Split) -> bytes:
    """One split's bytes, retried on transient IO errors (fault point
    ``ingest.split.read``)."""

    def attempt() -> bytes:
        fault_point("ingest.split.read", split.path)
        with open(split.path, "rb") as fh:
            fh.seek(split.start)
            return fh.read(split.end - split.start)

    return with_retries(attempt)


def run_split(cfg: ConverterConfig, split: Split):
    """Mapper: parse one split ->
    (FeatureCollection, n_errors, {reason: count})."""
    conv = cfg.build()
    if not split.skip_header:
        conv.skip_lines = 0
    data = _read_split(split)
    fc = conv.convert(data)
    fault_point("ingest.parse", split.path)
    return fc, conv.errors, dict(conv.error_reasons)


@dataclass
class SplitFailure:
    """A worker-side failure, shipped back as a value: the original
    exception type name plus the full formatted traceback (a forked
    worker's stack is otherwise lost — and a BaseException like
    InjectedCrash would wedge the pool instead of surfacing)."""

    split_index: int
    exc_type: str
    tb: str


def feed_in_split_order(pool, tasks, consume) -> None:
    """``consume`` each split's guarded result in split order
    (``pool.imap`` over :func:`run_split_guarded`). After the first
    failure, of a split or of ``consume``, the remaining results are
    drained unconsumed and the failure is raised once every worker is
    idle: the ``with`` block owning the pool then terminates it, and
    CPython's ``Pool.terminate`` can wait forever on the result queue's
    lock when it kills a worker in the middle of writing a result. The
    raised error and what was consumed are those of stopping at the
    failure."""
    failed = None
    for res in pool.imap(run_split_guarded, tasks):
        if failed is not None:
            continue
        try:
            consume(res)
        except BaseException as e:  # noqa: BLE001 (raised below, once the pool is idle)
            failed = e
    if failed is not None:
        raise failed


def run_split_guarded(args):
    """Pool entry point: ``(cfg, split, index)`` ->
    ``(index, fc | None, n_errors, {reason: count}, parse_seconds,
    SplitFailure | None)``."""
    cfg, split, index = args
    t0 = time.perf_counter()
    try:
        fc, errors, reasons = run_split(cfg, split)
        return index, fc, errors, reasons, time.perf_counter() - t0, None
    except BaseException as e:  # includes InjectedCrash: see SplitFailure
        return index, None, 0, {}, time.perf_counter() - t0, SplitFailure(
            split_index=index,
            exc_type=type(e).__name__,
            tb=traceback.format_exc(),
        )
