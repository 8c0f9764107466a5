"""Morton (Z-order) bit interleaving, vectorized over numpy uint64.

The port's copy of geomesa_tpu/curve/zorder.py (reference geomesa-z3
Z2.scala, Z3.scala:54-91, ZN.scala:309-361): 2-D interleave at 31
bits/dim, 3-D at 21 bits/dim, and the Tropf/Herzog LITMAX/BIGMIN split
(`zdiv`) that tightens range decomposition.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_U = np.uint64


def _u(x) -> np.uint64:
    return np.asarray(x, dtype=np.uint64)


def _lift(x):
    """(word type, x): plain Python ints stay Python ints — the planner's
    scalar calls (range decomposition, zdiv) then skip numpy's per-call
    overhead; every mask below is < 2**64, so ``&`` drops the same high
    bits uint64 arithmetic would, and the results are identical."""
    if isinstance(x, int):
        return int, x
    return _U, _u(x)


class _ZN:
    """Shared shape of an N-dimensional Morton curve (reference ZN.scala)."""

    dims: int
    bits_per_dim: int

    @property
    def total_bits(self) -> int:
        return self.dims * self.bits_per_dim

    @property
    def max_mask(self) -> int:
        return (1 << self.bits_per_dim) - 1

    # -- to be provided by subclasses ------------------------------------
    def split(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    def combine(self, z):  # pragma: no cover - interface
        raise NotImplementedError

class _Z2(_ZN):
    """2-D Morton: 31 bits per dimension, 62-bit keys (reference Z2.scala)."""

    dims = 2
    bits_per_dim = 31

    def split(self, value):
        """Insert a 0 bit between each of the low 31 bits of ``value``."""
        U, x = _lift(value)
        x = x & U(0x7FFFFFFF)
        x = (x ^ (x << U(32))) & U(0x00000000FFFFFFFF)
        x = (x ^ (x << U(16))) & U(0x0000FFFF0000FFFF)
        x = (x ^ (x << U(8))) & U(0x00FF00FF00FF00FF)
        x = (x ^ (x << U(4))) & U(0x0F0F0F0F0F0F0F0F)
        x = (x ^ (x << U(2))) & U(0x3333333333333333)
        x = (x ^ (x << U(1))) & U(0x5555555555555555)
        return x

    def combine(self, z):
        """Inverse of split: extract every second bit."""
        U, x = _lift(z)
        x = x & U(0x5555555555555555)
        x = (x ^ (x >> U(1))) & U(0x3333333333333333)
        x = (x ^ (x >> U(2))) & U(0x0F0F0F0F0F0F0F0F)
        x = (x ^ (x >> U(4))) & U(0x00FF00FF00FF00FF)
        x = (x ^ (x >> U(8))) & U(0x0000FFFF0000FFFF)
        x = (x ^ (x >> U(16))) & U(0x00000000FFFFFFFF)
        return x

    def index(self, x, y):
        """Interleave: z = split(x) | split(y) << 1."""
        U, _ = _lift(x)
        return self.split(x) | (self.split(y) << U(1))

    def decode(self, z):
        U, z = _lift(z)
        return self.combine(z), self.combine(z >> U(1))


class _Z3(_ZN):
    """3-D Morton: 21 bits per dimension, 63-bit keys (reference Z3.scala)."""

    dims = 3
    bits_per_dim = 21

    def split(self, value):
        """Spread the low 21 bits of ``value`` to every third bit."""
        U, x = _lift(value)
        x = x & U(0x1FFFFF)
        x = (x | (x << U(32))) & U(0x1F00000000FFFF)
        x = (x | (x << U(16))) & U(0x1F0000FF0000FF)
        x = (x | (x << U(8))) & U(0x100F00F00F00F00F)
        x = (x | (x << U(4))) & U(0x10C30C30C30C30C3)
        x = (x | (x << U(2))) & U(0x1249249249249249)
        return x

    def combine(self, z):
        """Inverse of split: extract every third bit."""
        U, x = _lift(z)
        x = x & U(0x1249249249249249)
        x = (x ^ (x >> U(2))) & U(0x10C30C30C30C30C3)
        x = (x ^ (x >> U(4))) & U(0x100F00F00F00F00F)
        x = (x ^ (x >> U(8))) & U(0x1F0000FF0000FF)
        x = (x ^ (x >> U(16))) & U(0x1F00000000FFFF)
        x = (x ^ (x >> U(32))) & U(0x1FFFFF)
        return x

    def index(self, x, y, t):
        """Interleave: z = split(x) | split(y) << 1 | split(t) << 2."""
        U, _ = _lift(x)
        return self.split(x) | (self.split(y) << U(1)) | (self.split(t) << U(2))

    def decode(self, z):
        U, z = _lift(z)
        return self.combine(z), self.combine(z >> U(1)), self.combine(z >> U(2))


Z2 = _Z2()
Z3 = _Z3()


@dataclass(frozen=True)
class ZPrefix:
    """Longest common binary prefix of two z-values (reference ZN.scala:250-265)."""

    prefix: int
    offset: int  # number of (low) bits NOT in the prefix


def longest_common_prefix(curve: _ZN, *values: int) -> ZPrefix:
    """Longest common prefix, in increments of ``dims`` bits.

    Reference: ZN.longestCommonPrefix (ZN.scala:250-265). Quad/oct tree
    levels consume `dims` bits at a time, so the prefix is aligned to the
    dimension count. Scans from the top for the smallest aligned offset at
    which all values share the same high bits.
    """
    step = curve.dims
    first = values[0]
    offset = curve.total_bits
    while offset > 0:
        nxt = offset - step
        bits = first >> nxt
        if all((v >> nxt) == bits for v in values):
            offset = nxt
        else:
            break
    return ZPrefix(prefix=(first >> offset) << offset, offset=offset)


def zdiv(curve: _ZN, zmin: int, zmax: int, zval: int) -> tuple[int, int]:
    """Tropf/Herzog LITMAX/BIGMIN computation.

    Given a z-range [zmin, zmax] (whose decoded corners span a query box)
    and a value ``zval`` inside [zmin, zmax] but *outside* the box, return
    (litmax, bigmin): litmax = the largest z <= zval inside the box,
    bigmin = the smallest z >= zval inside the box. Used to split a search
    range at a miss, skipping the gap.

    Reference: ZN.zdiv (ZN.scala:309-361). This implementation walks bits
    from the top, maintaining per-call load/bits semantics equivalent to the
    published algorithm (Tropf & Herzog 1981), generalized to N dims.
    """
    dims = curve.dims
    total = curve.total_bits
    litmax = zmin
    bigmin = zmax

    zmin_, zmax_ = zmin, zmax

    def load(target: int, p: int, bits: int, dim: int) -> int:
        """Set the bits of dimension `dim` in `target` at/below position
        `bits` (dimension-local bit count) to the pattern `p`.

        The dimension-strided mask/pattern are the curve's own split()
        spread shifted to the dimension lane — no per-bit loops.
        """
        mask = curve.split((1 << bits) - 1) << dim
        pattern = curve.split(p & ((1 << bits) - 1)) << dim
        return (target & ~mask) | pattern

    for i in range(total - 1, -1, -1):
        bit = 1 << i
        dim = i % dims
        bits_local = i // dims + 1  # dim-local index of this bit, 1-based
        v_bit = 1 if (zval & bit) else 0
        min_bit = 1 if (zmin_ & bit) else 0
        max_bit = 1 if (zmax_ & bit) else 0
        if v_bit == 0 and min_bit == 0 and max_bit == 0:
            continue
        if v_bit == 0 and min_bit == 0 and max_bit == 1:
            bigmin = load(zmin_, 1 << (bits_local - 1), bits_local, dim)
            zmax_ = load(zmax_, (1 << (bits_local - 1)) - 1, bits_local, dim)
        elif v_bit == 0 and min_bit == 1 and max_bit == 1:
            bigmin = zmin_
            return litmax, bigmin
        elif v_bit == 1 and min_bit == 0 and max_bit == 0:
            litmax = zmax_
            return litmax, bigmin
        elif v_bit == 1 and min_bit == 0 and max_bit == 1:
            litmax = load(zmax_, (1 << (bits_local - 1)) - 1, bits_local, dim)
            zmin_ = load(zmin_, 1 << (bits_local - 1), bits_local, dim)
        elif v_bit == 1 and min_bit == 1 and max_bit == 1:
            continue
        else:  # (0,1,0) and (1,1,0) are impossible for zmin <= zmax on this path
            raise ValueError(f"inconsistent bits at {i}: {v_bit} {min_bit} {max_bit}")
    return litmax, bigmin
