"""idle_unattributed_pct.*: the share of the device's idle time in the
traced sub-window during which no stage span of the port's path is open
(`cp.serve.*` stages when serving, `cp.train.*` when training): idle time
that no stage of the program accounts for."""
from benchmark.harness import spans

PREFIX = {"serve": "cp.serve.", "train": "cp.train."}


def read(ctx):
    prefix = PREFIX[ctx.mode]
    if not ctx.trace.kernels or not spans.present(ctx.trace, prefix):
        return None
    by = spans.idle_by_stage(ctx.trace)
    total = sum(by.values())
    stages = sum(v for k, v in by.items()
                 if k is not None and k.startswith(prefix))
    return 100.0 * (total - stages) / total if total > 0 else 0.0
