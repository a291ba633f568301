"""infer_img_s: images whose depth came back to the host through
``predict`` in the window, over the window's seconds (host clock)."""


def read(ctx):
    return ctx.images / ctx.window_s
