"""Concurrent query serving: the micro-batch scheduler in front of the
device (``DataStore.serve()``), its multi-tenant fairness state, and the
network data plane (``DataStore.serve(port=...)``).

- :class:`QueryScheduler`: bounded admission queues, the adaptive
  micro-batch window, cache-aware and deadline-aware admission,
  coalescing, and the dispatcher thread; callers get futures;
- :class:`ServingConfig`: the knobs (conf.py property tier defaults);
- :class:`ServingRejected`: a full queue or quota shed a non-blocking
  submit;
- :class:`TenantRegistry`: per-tenant quotas, DRR weights, SLO windows
  and accounting (serving/tenancy.py);
- :class:`DataServer`, :class:`DataClient`, :class:`ServeError`: the
  HTTP query, ingest, tile and ops endpoints and their stdlib client
  (serving/http.py).
"""

from geomesa_tpu_torch.serving.http import DataClient, DataServer, ServeError
from geomesa_tpu_torch.serving.scheduler import (
    QueryScheduler,
    ServingConfig,
    ServingRejected,
)
from geomesa_tpu_torch.serving.tenancy import TenantRegistry

__all__ = [
    "DataClient", "DataServer", "QueryScheduler", "ServeError",
    "ServingConfig", "ServingRejected", "TenantRegistry",
]
