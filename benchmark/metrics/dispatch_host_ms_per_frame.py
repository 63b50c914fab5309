"""dispatch_host_ms_per_frame.infer: the host's self ms a frame in the
port's launch stages of `run_batch` (`cp.serve.upload`, `.pre`, `.net`,
`.decode`, `.fetch`), over the traced sub-window: the eager launch cost."""
from benchmark.harness import spans

STAGES = ("cp.serve.upload", "cp.serve.pre", "cp.serve.net",
          "cp.serve.decode", "cp.serve.fetch")


def read(ctx):
    if not spans.present(ctx.trace, "cp.serve."):
        return None
    own = spans.self_s(ctx.trace)
    return 1e3 * sum(own[n] for n in STAGES) / ctx.units
