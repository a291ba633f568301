"""k1_roofline.infer: kernel 1's least time (``portbench/flops``) for the
traced calls' attention (one launch a block, at the call's batch) over its
device time in the trace, in %."""
from portbench import flops


def read(ctx):
    t = ctx.trace
    seconds = t and t.class_seconds("attention kernel")
    if not seconds:
        return None
    m, tr = ctx.model(), ctx.traffic
    ops, nbytes = flops.attention(tr["batch_size"], flops.tokens(tr["processing_res"]),
                                  m["num_heads"], backward=False)
    return 100.0 * flops.bound_s(ops, nbytes)[0] * m["depth"] * t.units / seconds
