"""The benchmark of ``vision_basedsensor_tpu_torch`` on one NVIDIA GPU.

``python3 -m vbs_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``README.md``).
"""
