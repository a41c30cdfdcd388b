"""Kernel 3 (`kernels/fused_mlp.py`, `mlp_votes_kernel`): its bound at the
cell's batch (`roofline.fused_mlp`) over its device time a launch in the
traced stretch, in %.  Nothing to read where it did not run."""

from bench import roofline


def read(ctx):
    if ctx.profile is None:
        return None
    s, n = ctx.profile.kernel_s("mlp_votes_kernel")
    if not n:
        return None
    bound = roofline.fused_mlp(ctx.setup.cfg, ctx.batch).bound_s()
    return 100.0 * bound * n / s
