"""loader_wait_ms.train: host ms a step waits to take its batch (from
``data/nyu.iterate_batches`` or host memory); mean over the window's steps."""


def read(ctx):
    return ctx.spans.mean_ms("loader.wait")
