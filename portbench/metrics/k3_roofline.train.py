"""k3_roofline.train: kernel 3's least time for a step's attention
backwards (the student's blocks at the whole batch) over its device time, in %."""
from portbench import flops


def read(ctx):
    t = ctx.trace
    seconds = t and t.class_seconds("attention backward kernel (packed; all deltas)")
    if not seconds:
        return None
    run, s = ctx.cell.config["train"], ctx.model("student")
    ops, nbytes = flops.attention(run["batch_size"], flops.tokens(run["image_size"]),
                                  s["num_heads"], backward=True)
    return 100.0 * s["depth"] * flops.bound_s(ops, nbytes)[0] * t.units / seconds
