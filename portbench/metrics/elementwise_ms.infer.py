"""elementwise_ms.infer: device ms a traced call of the kernels that
``tracing.classify`` leaves in "other elementwise" (the SwiGLU gate,
LayerScale's products, the residual adds and the other pointwise ATen
kernels), copies and sets excluded."""
from portbench import tracing


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ns = sum(e - s for n, s, e in t.ops if not n.startswith(("Memcpy", "Memset"))
             and tracing.classify(n) == "other elementwise")
    return 1e-6 * ns / t.units if ns else None
