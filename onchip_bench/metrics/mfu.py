"""``mfu``: the model FLOPs of the window's steps (``work/<config>.model_flops``
a step) over the window's seconds, as a share of the H100's bf16 peak.  Read from
the untraced window of the run."""

from onchip_bench import peaks


def read(ctx):
    w = ctx.window
    if not w["steps"]:
        return None
    flops = ctx.work.model_flops(ctx.conf, ctx.traffic) * w["steps"]
    return 100.0 * flops / w["seconds"] / peaks.BF16_FLOPS_PER_S
