"""fwd_enqueue_ms.infer: host ms from the model's forward pre-hook to its
forward hook, no synchronization: the time to enqueue a forward; mean over
the window's calls."""


def read(ctx):
    return ctx.spans.mean_ms("predict.forward")
