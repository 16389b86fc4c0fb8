"""``kernels_per_step``: device kernels launched in the traced stretch, over its
steps.  A count: it repeats exactly, and moves with fusion."""


def read(ctx):
    s = ctx.stretch
    return len(s.kernels) / s.steps
