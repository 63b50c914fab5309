"""dispatch_host_ms_per_step.train: the host's self ms a step in the
stages of the port's train step (`cp.train.*` inside `cp.train.step`:
zero_grad, forward, loss, backward, allreduce, adam), over the traced
sub-window: the host's time to launch a step, against the device's."""
from benchmark.harness import spans


def read(ctx):
    if not spans.present(ctx.trace, "cp.train."):
        return None
    own = spans.self_s(ctx.trace)
    return 1e3 * sum(v for k, v in own.items()
                     if k.startswith("cp.train.")
                     and k != "cp.train.step") / ctx.units
