"""Space-filling-curve math: numpy copies of geomesa_tpu.curve.

Morton interleaving in 2-D and 3-D, dimension normalization, epoch-binned
time, the S2 Hilbert curve on the cube and range decomposition. Host-side work at plan and ingest time; the
device scan never touches 64-bit z values.
"""

from geomesa_tpu_torch.curve.binnedtime import BinnedTime, TimePeriod
from geomesa_tpu_torch.curve.normalize import (
    NormalizedDimension, NormalizedLat, NormalizedLon, NormalizedTime,
)
from geomesa_tpu_torch.curve.s2 import S2SFC
from geomesa_tpu_torch.curve.z2sfc import Z2SFC
from geomesa_tpu_torch.curve.z3sfc import Z3SFC
from geomesa_tpu_torch.curve.zorder import Z2, Z3

__all__ = [
    "Z2", "Z3", "NormalizedDimension", "NormalizedLat", "NormalizedLon",
    "NormalizedTime", "BinnedTime", "TimePeriod", "S2SFC", "Z2SFC", "Z3SFC",
]
