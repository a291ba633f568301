"""step_enqueue_ms.train: host ms of the step function's call
(``train/step``), no synchronization; mean over the window's steps."""


def read(ctx):
    return ctx.spans.mean_ms("step.enqueue")
