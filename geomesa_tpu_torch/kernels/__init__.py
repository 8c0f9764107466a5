"""The port's hand-written CUDA kernels: build, binding and launch counts."""

from geomesa_tpu_torch.kernels.build import (
    BLOCK_POPS, BLOCK_SCAN, BLOCK_SCAN_MULTI, BOUNDS, DENSITY, KERNELS, PROBE_BOUNDS,
    PROBE_DENSITY, PROBE_KERNELS, PROBE_SCAN, build_all,
)

__all__ = [
    "BLOCK_POPS", "BLOCK_SCAN", "BLOCK_SCAN_MULTI", "BOUNDS", "DENSITY", "KERNELS",
    "PROBE_BOUNDS", "PROBE_DENSITY", "PROBE_KERNELS", "PROBE_SCAN", "build_all",
]
