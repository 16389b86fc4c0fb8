"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one NVIDIA H100.

``python3 onchip_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Every piece a cell uses is found by its name (``spec``): a configuration
in ``configs/<name>.json``, its float32 reference in ``reference/<name>.py``, the
port's reading of it in ``port/<name>.py``, its work counts in ``work/<name>.py``;
a traffic mix in ``traffic/<name>.json``; a cell's limits of correctness in
``limits/<cell>.json``; a per-layer metric's reader in ``metrics/<metric>.py``.
"""
