"""window_mfu.train: a step's needed FLOPs an image with a windowed student
(``portbench/window_train_flops.step_flops``: the teacher's forward and three
times the windowed student's, live pairs alone and the PEG conv; no
recompute) times the window's images/s, over the H100's dense bf16 peak, in
%."""
from portbench import flops, window_train_flops


def read(ctx):
    per_image = window_train_flops.step_flops(ctx.cell.config)
    return 100.0 * per_image * ctx.images / ctx.window_s / flops.BF16_OPS
