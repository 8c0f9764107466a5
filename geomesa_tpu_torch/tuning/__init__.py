"""geomesa_tpu_torch.tuning: the measured-cost primitives
(:mod:`~geomesa_tpu_torch.tuning.primitives`). The controllers, the
manager and the burn-rate shedder are not ported yet (ROADMAP A15)."""
