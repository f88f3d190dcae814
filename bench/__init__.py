"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and prints
its result as the last line of standard output.  Everything a cell needs
is found by name: its configuration under ``configs/``, its traffic mix
under ``traffic/``, the operation the mix names under ``ops/`` and each
metric's reader under ``metrics/``.
"""
