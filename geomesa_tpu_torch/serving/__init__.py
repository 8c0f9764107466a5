"""Concurrent query serving: the micro-batch scheduler in front of the
device (``DataStore.serve()``)."""

from geomesa_tpu_torch.serving.scheduler import (
    QueryScheduler,
    ServingConfig,
    ServingRejected,
)

__all__ = ["QueryScheduler", "ServingConfig", "ServingRejected"]
