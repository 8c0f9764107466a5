"""Feature type schema: the SimpleFeatureType analogue.

The port's copy of geomesa_tpu/sft.py (reference geomesa-utils
SimpleFeatureTypes.scala spec DSL): a named, ordered list of typed
attributes, one default geometry (the ``*``-prefixed attribute), an
optional default date attribute, and user data controlling indexing.

    "dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval=week"
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

GEOMETRY_TYPES = {
    "Point",
    "LineString",
    "Polygon",
    "MultiPoint",
    "MultiLineString",
    "MultiPolygon",
    "Geometry",
    "GeometryCollection",
}

SCALAR_TYPES = {
    "String",
    "Integer",
    "Int",
    "Long",
    "Float",
    "Double",
    "Boolean",
    "Date",
    "Bytes",
    "UUID",
}

# numpy dtype of the columnar storage for each attribute type; None = varlen
# (string/bytes -> offsets + pooled payload, geometry -> geometry pool)
COLUMN_DTYPES = {
    "Integer": np.int32,
    "Int": np.int32,
    "Long": np.int64,
    "Float": np.float32,
    "Double": np.float64,
    "Boolean": np.bool_,
    "Date": np.int64,  # epoch millis
}


@dataclass
class AttributeDescriptor:
    name: str
    type: str  # one of GEOMETRY_TYPES | SCALAR_TYPES
    default: bool = False  # the '*' default-geometry marker
    options: dict = field(default_factory=dict)  # index=true, srid=..., etc

    @property
    def is_geometry(self) -> bool:
        return self.type in GEOMETRY_TYPES

    @property
    def indexed(self) -> bool:
        v = self.options.get("index", "false")
        return str(v).lower() in ("true", "full", "join")

    def __post_init__(self):
        if self.type not in GEOMETRY_TYPES and self.type not in SCALAR_TYPES:
            raise ValueError(f"unknown attribute type {self.type!r} for {self.name!r}")


@dataclass
class FeatureType:
    """A named schema. Attribute order defines column order in storage."""

    name: str
    attributes: list[AttributeDescriptor]
    user_data: dict = field(default_factory=dict)

    def __post_init__(self):
        names = [a.name for a in self.attributes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate attribute names in {self.name}: {names}")
        self._by_name = {a.name: a for a in self.attributes}

    # -- lookups ---------------------------------------------------------
    def attr(self, name: str) -> AttributeDescriptor:
        return self._by_name[name]

    def has(self, name: str) -> bool:
        return name in self._by_name

    @property
    def geom_field(self) -> str | None:
        """Default geometry attribute (the '*' one, else the first geometry)."""
        for a in self.attributes:
            if a.default and a.is_geometry:
                return a.name
        for a in self.attributes:
            if a.is_geometry:
                return a.name
        return None

    @property
    def geom_type(self) -> str | None:
        g = self.geom_field
        return self._by_name[g].type if g else None

    @property
    def dtg_field(self) -> str | None:
        """Default date attribute: user-data override, else first Date."""
        override = self.user_data.get("geomesa.index.dtg")
        if override and self.has(override):
            return override
        for a in self.attributes:
            if a.type == "Date":
                return a.name
        return None

    @property
    def is_points(self) -> bool:
        return self.geom_type == "Point"

    # -- index configuration (reference: RichSimpleFeatureType) ----------
    @property
    def z3_interval(self) -> str:
        return str(self.user_data.get("geomesa.z3.interval", "week"))

    @property
    def xz_precision(self) -> int:
        return int(self.user_data.get("geomesa.xz.precision", 12))

    @property
    def z_shards(self) -> int:
        return int(self.user_data.get("geomesa.z.splits", 4))

    @property
    def attr_shards(self) -> int:
        return int(self.user_data.get("geomesa.attr.splits", 4))

    # -- spec DSL --------------------------------------------------------
    def indexed_attributes(self) -> list[str]:
        return [a.name for a in self.attributes if a.indexed and not a.is_geometry]

    @staticmethod
    def from_spec(name: str, spec: str) -> "FeatureType":
        """Parse the SFT spec DSL (reference SimpleFeatureTypes.createType)."""
        user_data: dict = {}
        if ";" in spec:
            spec, ud = spec.split(";", 1)
            for kv in ud.split(","):
                if kv.strip():
                    k, _, v = kv.partition("=")
                    user_data[k.strip()] = v.strip()
        attrs = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            default = part.startswith("*")
            if default:
                part = part[1:]
            pieces = part.split(":")
            if len(pieces) < 2:
                raise ValueError(f"bad attribute spec: {part!r}")
            attr_name, attr_type = pieces[0], pieces[1]
            options = {}
            for opt in pieces[2:]:
                k, _, v = opt.partition("=")
                options[k.strip()] = v.strip()
            attrs.append(AttributeDescriptor(attr_name, attr_type, default, options))
        return FeatureType(name, attrs, user_data)

    def to_spec(self) -> str:
        """The spec DSL string ``from_spec`` parses back to this type
        (attributes with their options, then the user data)."""
        parts = []
        for a in self.attributes:
            s = f"{'*' if a.default else ''}{a.name}:{a.type}"
            for k, v in a.options.items():
                s += f":{k}={v}"
            parts.append(s)
        spec = ",".join(parts)
        if self.user_data:
            spec += ";" + ",".join(f"{k}={v}" for k, v in self.user_data.items())
        return spec
