"""Device scan path: the candidate-block scan and the aggregation kernels,
each a hand-written CUDA kernel with its plain PyTorch version beside it."""

from geomesa_tpu_torch.scan import aggregations, block_kernels

__all__ = ["aggregations", "block_kernels"]
