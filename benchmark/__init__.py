"""The port's benchmark: `python benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>` (see run.py)."""
