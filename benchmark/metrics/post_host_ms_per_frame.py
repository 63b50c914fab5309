"""post_host_ms_per_frame.infer: the host's self ms a frame in
`run_batch`'s numpy post-process and merge (`cp.serve.post`,
`cp.serve.merge`), over the traced sub-window."""
from benchmark.harness import spans


def read(ctx):
    if not spans.present(ctx.trace, "cp.serve."):
        return None
    own = spans.self_s(ctx.trace)
    return 1e3 * (own["cp.serve.post"] + own["cp.serve.merge"]) / ctx.units
