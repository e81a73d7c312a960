"""ngsbench: the benchmark of the PyTorch and CUDA port
(``neuralgaussiansplatting_torch``) on one NVIDIA H100.

``python -m ngsbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration
under ``configs/``, its traffic mix under ``traffic/``, the loop the mix
names under ``loops/``, each per-layer metric's reader under
``metrics/``, the limits of its check under ``limits/``.
"""
