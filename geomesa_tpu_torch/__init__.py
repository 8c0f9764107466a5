"""geomesa_tpu_torch: the PyTorch/CUDA port of geomesa_tpu.

A second package beside the JAX one, which stays the reference the port is
held against. It imports torch and numpy, never jax and nothing of
geomesa_tpu: where it needs a module of the JAX package it keeps its own
copy under the same path. Entry points run on the card
(``DataStore(device="cuda")``, the default) unless the caller asks for
the CPU, where every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

from geomesa_tpu_torch.datastore import DataStore
from geomesa_tpu_torch.features import FeatureCollection
from geomesa_tpu_torch.sft import FeatureType

__all__ = ["DataStore", "FeatureCollection", "FeatureType", "__version__"]
