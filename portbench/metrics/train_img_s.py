"""train_img_s: the images of every step completed in the window over the
window's seconds; the window ends with a device synchronization."""


def read(ctx):
    return ctx.images / ctx.window_s
