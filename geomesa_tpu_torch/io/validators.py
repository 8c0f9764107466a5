"""Converter-side feature validation: the CqlValidatorFactory analogue.

Reference: geomesa-convert's SimpleFeatureValidator / CqlValidatorFactory
(geomesa-convert/geomesa-convert-common/.../convert2/
validators/) — named validators configured per converter ("index",
"has-geo", "has-dtg", or a CQL expression), each rejecting a converted
feature with a REASON instead of a bare boolean. The port's copy of
geomesa_tpu/io/validators.py has the same hook: validators run
on every converted row, failures count per reason
(``Converter.error_reasons`` -> ``IngestResult.error_reasons``), and
``drop_errors`` keeps deciding skip-vs-raise for both parse and
validation failures.

Built-ins (``parse_validators`` spec names):

- ``has-geo``  — the geometry attribute is present (non-None);
- ``z-bounds`` — geometry coordinates are finite and inside the Z2/Z3
  normalization domain (lon [-180, 180], lat [-90, 90]): out-of-bounds
  coordinates would silently clamp into edge index cells;
- ``has-dtg``  — the default date attribute is present (required to key
  a z3/xz3 index);
- ``index``    — the composite the reference defaults to: has-geo +
  z-bounds, plus has-dtg when the schema has a date field;
- ``none``     — no validation.

Custom validators are any object with ``name`` and
``validate(row) -> str | None`` (None = pass, else the failure reason).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from geomesa_tpu_torch import geometry as geo


@dataclass
class Validator:
    """One named validation rule over a converted row dict."""

    name: str
    fn: Callable  # row -> str | None (failure reason)

    def validate(self, row: dict) -> Optional[str]:
        return self.fn(row)


def _bounds_of(g: geo.Geometry) -> tuple[float, float, float, float]:
    return g.bounds()


def has_geo(sft) -> Validator:
    field = sft.geom_field

    def check(row):
        if field is None or row.get(field) is None:
            return "missing geometry"
        return None

    return Validator("has-geo", check)


def z_bounds(sft) -> Validator:
    """Geometry coordinates finite and inside the curve normalization
    domain — the reference's z-index validator: out-of-bounds values
    would clamp into edge cells and index under the wrong key."""
    import math

    field = sft.geom_field

    def check(row):
        g = row.get(field) if field else None
        if g is None:
            return None  # has-geo owns presence
        x0, y0, x1, y1 = _bounds_of(g)
        if not all(map(math.isfinite, (x0, y0, x1, y1))):
            return "non-finite coordinates"
        if x0 < -180.0 or x1 > 180.0:
            return "longitude outside [-180, 180]"
        if y0 < -90.0 or y1 > 90.0:
            return "latitude outside [-90, 90]"
        return None

    return Validator("z-bounds", check)


def has_dtg(sft) -> Validator:
    field = sft.dtg_field

    def check(row):
        if field is not None and row.get(field) is None:
            return "missing date"
        return None

    return Validator("has-dtg", check)


def attribute_required(name: str) -> Validator:
    """A custom per-attribute presence rule (the CQL ``x IS NOT NULL``
    shape the reference expresses through CqlValidatorFactory)."""

    def check(row):
        if row.get(name) is None:
            return f"missing attribute {name!r}"
        return None

    return Validator(f"required-{name}", check)


def parse_validators(spec, sft) -> list[Validator]:
    """Validator list from a converter config value: a comma-separated
    name string ("index", "has-geo,z-bounds", "none"), a sequence of
    names and/or Validator objects, or None (no validation)."""
    if spec is None:
        return []
    if isinstance(spec, str):
        names = [s.strip() for s in spec.split(",") if s.strip()]
    else:
        names = list(spec)
    out: list[Validator] = []
    for n in names:
        if isinstance(n, Validator) or (
            hasattr(n, "validate") and hasattr(n, "name")
        ):
            out.append(n)
        elif n == "none":
            continue
        elif n == "has-geo":
            out.append(has_geo(sft))
        elif n == "z-bounds":
            out.append(z_bounds(sft))
        elif n == "has-dtg":
            out.append(has_dtg(sft))
        elif n == "index":
            out.append(has_geo(sft))
            out.append(z_bounds(sft))
            if sft.dtg_field is not None:
                out.append(has_dtg(sft))
        elif n.startswith("required:"):
            out.append(attribute_required(n.split(":", 1)[1]))
        else:
            raise ValueError(f"unknown validator {n!r}")
    return out


def validator_spec(validators) -> "str | None":
    """The picklable spec form of a converter's ``validators`` value
    (the mapper-side job config ships names, not closures). Validator
    OBJECTS cannot cross the process boundary — converters using them
    must run in-process (workers <= 1), like the reference's
    non-serializable custom validators."""
    if validators is None:
        return None
    if isinstance(validators, str):
        return validators
    names: list[str] = []
    for v in validators:
        if isinstance(v, str):
            names.append(v)
        else:
            raise ValueError(
                "custom Validator objects are not picklable for "
                "multi-process ingest; pass validator NAMES or run with "
                "workers<=1"
            )
    return ",".join(names)
