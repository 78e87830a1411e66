"""The benchmark of ``fabric_tpu_torch``: one command runs one cell once
(``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``).  See ``README.md``."""
