"""The benchmark of ``repro_torch``: one command runs one cell once.

``python tofec_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout; see ``tofec_bench/README.md``.
"""
