"""State carry-across: a JAX table's host state -> the port's table.

This system's counterpart of converting a model's weights: the sorted key
structure and the device columns of an index table, taken as numpy
arrays, rebuild the same table in the port, so both packages can be run
over byte-identical tables.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.storage.table import STATE_KEYS, IndexTable


def load_table_state(state: dict, keyspace, device) -> IndexTable:
    """Build the port's IndexTable from ``state``: ``perm``, ``bins``,
    ``zs``, ``ubins``, ``bin_starts`` and ``block`` (rows per scan block)
    of a sorted table, plus ``cols3`` (column name -> numpy
    [n_blocks, SUB, 128]): x and y (and tbin/toff or tw) of a point
    table, or the four extent columns gxmin, gymin, gxmax, gymax (and
    tbin/toff on XZ3) of an extent table, which the table then scans
    with the extent leg. ``keyspace`` is the port's index the table
    serves (its packed-time setting shapes the window parameters)."""
    missing = [k for k in (*STATE_KEYS, "cols3") if k not in state]
    if missing:
        raise KeyError(f"table state lacks {missing}")
    cols = {k: np.asarray(v) for k, v in state["cols3"].items()}
    shapes = {v.shape for v in cols.values()}
    block = int(state["block"])
    if len(shapes) != 1 or next(iter(shapes))[1] * 128 != block:
        raise ValueError(f"cols3 shapes {sorted(shapes)} do not match block {block}")
    return IndexTable.from_state(keyspace, {**state, "cols3": cols}, device)
