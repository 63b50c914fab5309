"""wait_host_ms_per_frame.infer: ms a frame of `cp.serve.wait`, the host
blocked on the card's results inside `run_batch`, over the traced
sub-window."""
from benchmark.harness import spans


def read(ctx):
    if not spans.present(ctx.trace, "cp.serve."):
        return None
    return 1e3 * spans.self_s(ctx.trace)["cp.serve.wait"] / ctx.units
