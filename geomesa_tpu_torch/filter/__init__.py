"""Filters: the predicate AST, the ECQL parser and value extraction."""

from geomesa_tpu_torch.filter.predicates import (
    EXCLUDE, INCLUDE, And, BBox, Between, Cmp, Contains, During, DWithin,
    Exclude, Filter, IdFilter, In, Include, Intersects, IsNull, Like, Not, Or,
    PointColumn, Within,
)
from geomesa_tpu_torch.filter import ecql
from geomesa_tpu_torch.filter.ecql import parse, parse_dt_millis
from geomesa_tpu_torch.filter.extract import (
    Bounds, FilterValues, Interval, extract_attribute_bounds,
    extract_geometries, extract_ids, extract_intervals, geometry_bounds,
)

__all__ = [
    "ecql", "Filter", "Include", "Exclude", "INCLUDE", "EXCLUDE",
    "BBox", "Intersects", "Contains", "Within", "DWithin",
    "During", "Cmp", "Between", "In", "Like", "IsNull", "IdFilter",
    "And", "Or", "Not", "PointColumn",
    "parse", "parse_dt_millis",
    "FilterValues", "Interval", "Bounds",
    "extract_geometries", "extract_intervals", "extract_ids",
    "extract_attribute_bounds", "geometry_bounds",
]
