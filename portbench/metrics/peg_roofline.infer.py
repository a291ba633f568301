"""peg_roofline.infer: the PEG conv's least time (``portbench/window_flops``:
the 37 x 37 depthwise conv over the call's batch and grid, once a forward)
for the traced calls over the device time of the kernels in "depthwise conv
(PEG, ATen)", in %."""
from portbench import flops, window_flops


def read(ctx):
    t = ctx.trace
    seconds = t and t.class_seconds("depthwise conv (PEG, ATen)")
    if not seconds:
        return None
    m, tr = ctx.model(), ctx.traffic
    g = tr["processing_res"] // flops.PATCH
    ops, nbytes = window_flops.pos_conv(tr["batch_size"], m["embed_dim"], g, g)
    return 100.0 * flops.bound_s(ops, nbytes)[0] * t.units / seconds
