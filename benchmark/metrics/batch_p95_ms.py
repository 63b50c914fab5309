"""batch_p95_ms.infer: the 95th percentile, over every call of the
unprofiled window, of the time from handing the uint8 frames to
`run_batch` until its per-class results return (numpy's linear
quantile).  Read beside frames/s, with no bound: on one card machine its
runs spread by 7-24 % (PERF.md)."""


def read(ctx):
    return ctx.e2e["infer_batch_p95_ms"]
