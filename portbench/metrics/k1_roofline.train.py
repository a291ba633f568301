"""k1_roofline.train: kernel 1's least time for a step's attention
forwards (the teacher's blocks in chunks of ``teacher_chunk`` images, the
student's blocks at the whole batch) over its device time, in %."""
from portbench import flops


def read(ctx):
    t = ctx.trace
    seconds = t and t.class_seconds("attention kernel")
    if not seconds:
        return None
    run = ctx.cell.config["train"]
    n, bs, chunk = flops.tokens(run["image_size"]), run["batch_size"], run["teacher_chunk"] or 1
    teacher, student = ctx.model("teacher"), ctx.model("student")
    bound = (bs // chunk * teacher["depth"]
             * flops.bound_s(*flops.attention(chunk, n, teacher["num_heads"], False))[0]
             + student["depth"] * flops.bound_s(*flops.attention(bs, n, student["num_heads"],
                                                                  False))[0])
    return 100.0 * bound * t.units / seconds
