"""The chip-side design probes, ported: P1 (``probe_pallas``, the
smallest candidate-block scan) and P2 (``probe_agg``, the bounds and
one-hot density candidates), each a hand-written CUDA kernel beside its
plain PyTorch version (scan/probe_kernels.py). Run on a CUDA card:

    python -m geomesa_tpu_torch.scripts.probe_pallas
    python -m geomesa_tpu_torch.scripts.probe_agg

Each module's ``run(device=...)`` takes the sizes as arguments (the JAX
probes' sizes by default) and returns its records; ``device="cpu"`` runs
the plain versions and times nothing.
"""
