"""Concurrent query serving: the micro-batch scheduler in front of the
device (``DataStore.serve()``) and its multi-tenant fairness state.

- :class:`QueryScheduler`: bounded admission queues, the adaptive
  micro-batch window, cache-aware and deadline-aware admission,
  coalescing, and the dispatcher thread; callers get futures;
- :class:`ServingConfig`: the knobs (conf.py property tier defaults);
- :class:`ServingRejected`: a full queue or quota shed a non-blocking
  submit;
- :class:`TenantRegistry`: per-tenant quotas, DRR weights, SLO windows
  and accounting (serving/tenancy.py).
"""

from geomesa_tpu_torch.serving.scheduler import (
    QueryScheduler,
    ServingConfig,
    ServingRejected,
)
from geomesa_tpu_torch.serving.tenancy import TenantRegistry

__all__ = ["QueryScheduler", "ServingConfig", "ServingRejected", "TenantRegistry"]
