"""Kernel 1's grouped entry (`kernels/binary_gemm.py`
`grouped_bitlinear_hd`, `grouped_bitlinear_kernel`): the bound of a
call's grouped launches at the cell's shapes (`lm_roofline.
grouped_launches`: gate and up as one, then down, in every MoE layer,
each routed slot a row, every expert's packed rows, the packed slots
and the int32 distances) times the calls traced, over the kernel's device time in the
traced stretch, in %.  Nothing to read where it did not run."""

from bench import lm_roofline

KERNEL = "grouped_bitlinear_kernel"


def read(ctx):
    if ctx.profile is None:
        return None
    s, n = ctx.profile.kernel_s(KERNEL)
    if not n:
        return None
    b, seq = ctx.setup.rows.shape[1:]
    bound = lm_roofline.grouped_bound_s(ctx.setup.cfg, b, seq)
    return 100.0 * bound * ctx.profile.calls / s
