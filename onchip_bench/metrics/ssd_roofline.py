"""``ssd_roofline``: the SSD kernels K5 and S3 against their roofline bound,
summed over their calls in the traced stretch (``trace.roofline_pct`` with
``work/<config>.kernel_work``).  Raises where the stretch holds no call of K5
or none of S3: the cells that list this metric run both."""

from onchip_bench import peaks, trace


def read(ctx):
    return trace.roofline_pct(ctx.stretch, ctx.work.kernel_work(ctx.conf, ctx.traffic),
                              ("k5", "s3"), peaks.BF16_FLOPS_PER_S, peaks.HBM_BYTES_PER_S)
