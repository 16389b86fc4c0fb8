"""``idle_pct``: the share of the traced stretch's wall time in which no
operation ran on the device (the union of kernel, copy and set intervals)."""


def read(ctx):
    s = ctx.stretch
    return 100.0 * (1.0 - s.busy_s / s.window_s)
