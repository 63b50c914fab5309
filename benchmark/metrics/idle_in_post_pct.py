"""idle_in_post_pct.infer: the share of the device's idle time in the
traced sub-window during which the innermost open span of the port is
`cp.serve.post` or `cp.serve.merge` (the host's numpy post-process)."""
from benchmark.harness import spans


def read(ctx):
    if not ctx.trace.kernels or not spans.present(ctx.trace, "cp.serve."):
        return None
    by = spans.idle_by_stage(ctx.trace)
    total = sum(by.values())
    post = by["cp.serve.post"] + by["cp.serve.merge"]
    return 100.0 * post / total if total > 0 else 0.0
