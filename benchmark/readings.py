"""The readings that the limits of `correct` are set from (not run by
run.py): for a cell, the program's numbers on each of `--seeds` and the
control's on each of `--control-seeds`, all in one process, one JSON
line each, from the `readings` of the cell's driver
(benchmark/drivers/<kind>.py).  Serving runs a window of `--seconds` at
the cell's own load for each seed, with the fp8 reference in the
program's place as the control; training reads the first three steps,
with the program's TF32 path switched on as the control, and the fault
"half of each batch left out" beside it.

  python benchmark/readings.py --workload dla34.serve-batch4 \\
      --seeds 1,2,3 --control-seeds 4,5,6 --seconds 3"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from benchmark.harness import cells
    cell = cells.load(args.workload)
    read = cells.module("drivers", cell["traffic"]["kind"]).readings
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for kind, seed in ([("program", s) for s in seeds]
                       + [("control", s) for s in controls]):
        t0 = time.perf_counter()
        line = {"workload": args.workload, "kind": kind, "seed": seed}
        line.update(read(cell, seed, kind == "control", args.seconds,
                         args.device))
        line["s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(line), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
