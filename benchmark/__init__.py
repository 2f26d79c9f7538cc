"""The benchmark of ``citylearn_tpu_torch`` on NVIDIA H100 cards: one
command runs one cell of ``BENCHMARK.json`` once
(``python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``) and prints one JSON line. Configurations, traffic mixes
and per-layer metrics are files found by their names: ``configs/``,
``traffic/`` and ``metrics/``."""
