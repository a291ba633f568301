"""setup_s: seconds from the process's start to the window's: imports,
building the program, making weights and inputs, every shape's first run
(in a fresh checkout, the kernels' build) and a training cell's first steps."""


def read(ctx):
    return ctx.setup_s
