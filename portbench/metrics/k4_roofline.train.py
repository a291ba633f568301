"""k4_roofline.train: kernel 4's least time for a step's order statistics
(HDN's median alignment of the student's and the teacher's depth over the
contexts: two selects over [contexts x batch, pixels]) over its device
time, in %."""
from portbench import flops


def read(ctx):
    t = ctx.trace
    seconds = t and t.class_seconds("select kernel")
    if not seconds:
        return None
    run = ctx.cell.config["train"]
    level = run["loss"]["hdn_level"]
    rows = sum(2 ** i for i in range(level)) * run["batch_size"]  # 7 contexts at level 3
    bound = flops.bound_s(*flops.kth_select(rows, run["image_size"] ** 2))[0]
    return 100.0 * 2 * bound * t.units / seconds
