"""window_mfu.infer: the windowed forward's matmul and convolution FLOPs an
image (``portbench/window_flops.model_flops``: live pairs alone, the PEG
conv) times the window's images/s, over the H100's dense bf16 peak, in %."""
from portbench import flops, window_flops


def read(ctx):
    per_image = window_flops.model_flops(ctx.model(), ctx.traffic["processing_res"])
    return 100.0 * per_image * ctx.images / ctx.window_s / flops.BF16_OPS
