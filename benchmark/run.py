"""The port's benchmark: one run of one cell.

  python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

makes the cell's weights and inputs from the seed, builds the port's
entry (centerpoly_tpu_torch), warms up the cell's own shapes, runs its
traffic for `--seconds`, then (with --trace 1) a short profiled
sub-window, checks the outputs against the plain reference
(benchmark/reference/) and prints one JSON line: {"correct", "attempted",
"failed", "metrics", "device"[, "breakdown"], "checks"}.  With --trace 0
the metrics are the cell's end-to-end ones, with --trace 1 its per-layer
ones.  It needs as many CUDA devices as the cell asks for."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the build and kernel caches of this checkout, at fixed paths inside it
CACHE = os.path.join(ROOT, ".benchcache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "centerpoly_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: centerpoly_tpu_torch is not centerpoly_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import cells
    try:
        cell = cells.load(args.workload)
    except KeyError as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 2
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell {args.workload} needs {chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": nothing measured", file=sys.stderr)
        return 3
    from benchmark.harness import runner
    try:
        result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    except ImportError as e:
        print(f"run.py: cannot import the port ({e}): run from the root of "
              f"a checkout that holds centerpoly_tpu_torch", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {', '.join(bad)}: the benchmark "
              f"measures the PyTorch port alone", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
