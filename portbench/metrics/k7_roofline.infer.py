"""k7_roofline.infer: kernel 7's least time (``portbench/window_flops``: the
banded attention forward of every block, one launch a block at the call's
batch and grid) for the traced calls over its device time in the trace
("banded attention kernel"), in %."""
from portbench import flops, window_flops


def read(ctx):
    t = ctx.trace
    seconds = t and t.class_seconds("banded attention kernel")
    if not seconds:
        return None
    m, tr = ctx.model(), ctx.traffic
    g = tr["processing_res"] // flops.PATCH
    ops, nbytes = window_flops.banded_attention(tr["batch_size"], g, g, m["num_heads"],
                                                m["window_size"])
    return 100.0 * flops.bound_s(ops, nbytes)[0] * m["depth"] * t.units / seconds
