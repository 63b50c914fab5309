"""dcn_launches.*: DCN kernel launches (the port's kernels/dcn.py
counter, every mode) a call of the window: a `run_batch` call (one
forward) when serving, a step (forward and backward) when training."""


def read(ctx):
    return float(ctx.launches)
