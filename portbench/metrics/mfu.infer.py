"""mfu.infer: the forward's matmul and convolution FLOPs an image
(``portbench/flops.model_flops``) times the window's images/s, over the
H100's dense bf16 peak, in %."""
from portbench import flops


def read(ctx):
    per_image = flops.model_flops(ctx.model(), ctx.traffic["processing_res"])
    return 100.0 * per_image * ctx.images / ctx.window_s / flops.BF16_OPS
