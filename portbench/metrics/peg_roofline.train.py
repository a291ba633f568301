"""peg_roofline.train: the PEG conv's least time in a step
(``portbench/window_train_flops``: the 37 x 37 depthwise conv's forward and
its backward's d(x) and d(weight) over the step's batch and grid) for the
traced steps over the device time of the kernels in "depthwise conv (PEG,
ATen)": the forward kernel and ATen's depthwise backward kernels, whose
names all carry ``conv_depthwise2d``, in %."""
from portbench import flops, window_train_flops


def read(ctx):
    t = ctx.trace
    seconds = t and t.class_seconds("depthwise conv (PEG, ATen)")
    if not seconds:
        return None
    run = ctx.cell.config["train"]
    g = run["image_size"] // flops.PATCH
    ops, nbytes = window_train_flops.pos_conv_step(run["batch_size"],
                                                   ctx.model("student")["embed_dim"], g, g)
    return 100.0 * flops.bound_s(ops, nbytes)[0] * t.units / seconds
