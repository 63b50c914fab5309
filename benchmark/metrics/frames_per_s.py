"""frames_per_s.infer: 2048x1024 frames whose results came back over the
whole unprofiled window, per second of it (host clock).  The rate a
closed-loop caller of `run_batch` sees; read with no bound, as the
host's speed moves it by up to a sixth between runs (PERF.md)."""


def read(ctx):
    return ctx.e2e["infer_frames_per_s"]
