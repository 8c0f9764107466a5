"""geomesa_tpu_torch.tuning: the self-tuning controller tier.

The loop that turns the store's telemetry (estimate-accuracy windows,
live histograms and counters, SLO burn rates, link constants) into
bounded online decisions. ``DataStore.attach_tuning()`` is the entry
point; ``geomesa.tuning.enabled`` arms it; a disarmed tier behaves
exactly as a store without it. The measured-cost primitives
(:mod:`~geomesa_tpu_torch.tuning.primitives`) are shared with the gates
that learn a cost."""

from geomesa_tpu_torch.tuning.burnshed import BurnShed
from geomesa_tpu_torch.tuning.controllers import (
    CONTROLLER_SPECS,
    ControllerSpec,
    KnobController,
)
from geomesa_tpu_torch.tuning.manager import TuningManager
from geomesa_tpu_torch.tuning.primitives import (
    DEFAULT_ALPHA,
    CostEwma,
    ProbeGate,
    doubling_ladder,
    ewma_step,
)
from geomesa_tpu_torch.tuning.reweight import IndexReweighter

__all__ = [
    "BurnShed",
    "CONTROLLER_SPECS",
    "ControllerSpec",
    "CostEwma",
    "DEFAULT_ALPHA",
    "IndexReweighter",
    "KnobController",
    "ProbeGate",
    "TuningManager",
    "doubling_ladder",
    "ewma_step",
]
