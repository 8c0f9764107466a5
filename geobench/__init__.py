"""The benchmark of geomesa_tpu_torch: served GDELT cells on one H100.

``python3 geobench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the checkout's
root lists the cells, their configurations and traffic mixes (data files
under ``configs/`` and ``traffic/``) and the metrics (readers under
``metrics/``). Nothing here imports jax or the JAX package.
"""
