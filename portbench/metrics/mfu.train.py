"""mfu.train: a step's needed FLOPs an image (the teacher's forward and
three times the student's: forward, and the backward's two products; no
recompute) times the window's images/s, over the H100's dense bf16 peak, in %."""
from portbench import flops


def read(ctx):
    res = ctx.cell.config["train"]["image_size"]
    per_image = (flops.model_flops(ctx.model("teacher"), res)
                 + 3 * flops.model_flops(ctx.model("student"), res))
    return 100.0 * per_image * ctx.images / ctx.window_s / flops.BF16_OPS
