"""``setup_s``: seconds from the process's start to the window's start: imports,
weights, the optimizer state and the checked steps (a first run in a checkout
builds the kernels here too)."""


def read(ctx):
    return ctx.setup_s
