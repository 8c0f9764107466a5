"""geomesa_tpu_torch: the PyTorch/CUDA port of geomesa_tpu.

A second package beside the JAX one, which stays the reference the port is
held against. It imports torch and numpy, never jax and nothing of
geomesa_tpu: where it needs a module of the JAX package it keeps its own
copy under the same path. Entry points run on the card
(``DataStore(device="cuda")``, the default) unless the caller asks for
the CPU, where every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

__all__ = ["DataStore", "FeatureCollection", "FeatureType", "__version__"]

#: the top-level names load on first use, so a stdlib-only subpackage
#: (``analysis``, the ``check`` script) imports without torch
_LAZY = {
    "DataStore": "geomesa_tpu_torch.datastore",
    "FeatureCollection": "geomesa_tpu_torch.features",
    "FeatureType": "geomesa_tpu_torch.sft",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
