"""The port's scripts: the chip-side design probes, the measurement
drivers, the A/B drivers and the static analysis runner.

- The probes P1 (``probe_pallas``, the smallest candidate-block scan)
  and P2 (``probe_agg``, the bounds and one-hot density candidates), each
  a hand-written CUDA kernel beside its plain PyTorch version
  (scan/probe_kernels.py).
- The measurement drivers, the ports of the reference's ``scripts/``
  under the same names: ``validate_1b``, ``run_pod_scale``,
  ``probe_link``, ``probe_floor``, ``probe_async_pull``,
  ``probe_density_many``, ``probe_xz2_50m``, ``probe_xz2_pipeline``,
  ``probe_xz2_stage``, ``profile_join`` (``hostmem`` holds their RSS
  helpers).

Run on a CUDA card, e.g.:

    python -m geomesa_tpu_torch.scripts.probe_pallas
    python -m geomesa_tpu_torch.scripts.probe_agg
    python -m geomesa_tpu_torch.scripts.validate_1b --rows 100000000

Each module's ``run(...)`` takes the sizes as arguments (the reference's
sizes by default) and returns its record; ``device="cpu"`` runs the
plain versions and times no device.
"""
