"""Kernel 4's votes entry (`kernels/fused_conv.py`, `fused_conv_kernel`):
its bound at the cell's batch (`roofline.fused_conv`) over its device time
a launch in the traced stretch, in %.  Nothing to read where it did not
run, or ran as the HD-once route's stage entry (a spec with noise)."""

from bench import roofline


def read(ctx):
    if ctx.profile is None or ctx.setup.spec.noise != "off":
        return None
    s, n = ctx.profile.kernel_s("fused_conv_kernel")
    if not n:
        return None
    bound = roofline.fused_conv(ctx.setup.cfg, ctx.batch).bound_s()
    return 100.0 * bound * n / s
