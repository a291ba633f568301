"""k2_roofline.infer: kernel 2's least time (the DPT tail at the call's
batch and resolution) for the traced calls over its device time, in %."""
from portbench import flops


def read(ctx):
    t = ctx.trace
    seconds = t and t.class_seconds("tail kernel")
    if not seconds:
        return None
    tr = ctx.traffic
    ops, nbytes = flops.dpt_tail(tr["batch_size"], tr["processing_res"], ctx.model()["features"])
    return 100.0 * flops.bound_s(ops, nbytes)[0] * t.units / seconds
