"""geomesa_tpu_torch.process: the great-circle distance the standing
matcher reads (:mod:`~geomesa_tpu_torch.process.knn`). The analytic
processes themselves are not ported yet (ROADMAP A12)."""
