"""k8_roofline.train: kernel 8's least time (``portbench/window_train_flops``:
the banded attention backward of every student block, one launch a block at
the step's batch and grid) for the traced steps over its device time, in %.
Its device time is the class "banded attention backward kernel" (the dK/dV
and dQ passes) and its delta pass, which ``tracing.CLASSES`` files under the
packed backward's class with every delta. No other kernel launches a delta
in a step of this configuration, for kernel 3 does not run: where the trace
holds a kernel of kernel 3's, the deltas are not kernel 8's alone and this
reads None."""
from portbench import flops, tracing, window_train_flops

PACKED = "attention backward kernel (packed; all deltas)"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    packed = [(n, e - s) for n, s, e in t.ops if tracing.classify(n) == PACKED]
    if any("delta_kernel" not in n for n, _ in packed):
        return None  # kernel 3 ran: its deltas cannot be told from kernel 8's
    seconds = (t.class_seconds("banded attention backward kernel")
               + sum(d for _, d in packed) / 1e9)
    if not seconds:
        return None
    s, run = ctx.model("student"), ctx.cell.config["train"]
    g = run["image_size"] // flops.PATCH
    ops, nbytes = window_train_flops.banded_attention_backward(run["batch_size"], g, g,
                                                               s["num_heads"], s["window_size"])
    return 100.0 * s["depth"] * flops.bound_s(ops, nbytes)[0] * t.units / seconds
