"""The benchmark of ``gpyreg_tpu_torch`` on one NVIDIA H100, or four.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see
``portbench/README.md``.  Nothing here imports JAX or ``gpyreg_tpu``.
"""
