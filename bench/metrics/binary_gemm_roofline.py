"""Kernel 1 (`kernels/binary_gemm.py`, `binary_gemm_hd*`) on the HD-once
route: the bound of one call's launches at their shapes
(`roofline.hd_once_gemms`: each FC layer, then the head) times the calls
traced, over the kernel's device time in the traced stretch, in %.
Nothing to read where it did not run."""

from bench import roofline


def read(ctx):
    if ctx.profile is None:
        return None
    s, n = ctx.profile.kernel_s("binary_gemm_hd")
    if not n:
        return None
    bound = roofline.hd_once_gemms(ctx.setup.cfg, ctx.batch).bound_s()
    return 100.0 * bound * ctx.profile.calls / s
