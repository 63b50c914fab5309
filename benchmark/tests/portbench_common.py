"""Helpers of the benchmark's tests."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small_cell(name: str) -> dict:
    """A cell of BENCHMARK.json at a size the CPU runs in seconds:
    a 64x128 input (128x256 for the hourglass, whose five levels halve
    it), frames of twice that, batches of 2."""
    from benchmark.harness import cells
    cell = cells.load(name)
    h = 128 if "hourglass" in cell["config"]["arch"] else 64
    cell["config"].update(frame_h=2 * h, frame_w=4 * h, input_h=h,
                          input_w=2 * h)
    t = cell["traffic"]
    if t["kind"] == "serve_batch":
        t.update(pool=4, batch=2, check_calls=2, warmup_calls=1,
                 trace_calls=2)
    else:
        t.update(batch=2, pool_batches=3, trace_steps=1)
    return cell
