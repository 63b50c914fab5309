"""infer_device_ms_per_frame (end to end): the device's busy time (the
union of its kernels', copies' and sets' intervals) over the whole
measured window, under a trace of the device alone, per frame whose
results came back in it: the card time a served frame costs, which
bounds frames/s once the host keeps up."""


def read(ctx):
    if not ctx.trace.kernels or not ctx.units:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.units
