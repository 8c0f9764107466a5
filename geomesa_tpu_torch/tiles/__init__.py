"""geomesa_tpu_torch.tiles: the live map-tile tier (docs/tiles.md).

A slippy-map density pyramid behind the HTTP data plane: leaf tiles
aggregate rows once on an exact global leaf lattice, parents fold child
partials, and GenerationTracker's scoped invalidation keeps the whole
structure incrementally maintained under sustained ingest — the
GeoBlocks serving story (arXiv:1908.07753) this repo reproduces.

- :class:`TileLattice` — the exact tiling geometry / binning;
- :class:`TilePyramid` — precomposed grids + the from-scratch oracle;
- :func:`render` / :func:`encode_png` — deterministic stdlib PNG.

The port's copy of geomesa_tpu/tiles/__init__.py,
held to it by the CPU parity tests.
"""

from geomesa_tpu_torch.tiles.png import KINDS, encode_png, render
from geomesa_tpu_torch.tiles.pyramid import TileGrid, TilePyramid, TilesConfig
from geomesa_tpu_torch.tiles.tiling import TileLattice

__all__ = [
    "TileLattice", "TilePyramid", "TilesConfig", "TileGrid",
    "KINDS", "encode_png", "render",
]
