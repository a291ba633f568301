"""infer_p95_ms: the 95th percentile of every ``predict`` call's latency in
the window (host clock; uint8 images in, depth on the host out)."""
from portbench.harness import p95


def read(ctx):
    return p95(ctx.latencies_ms)
