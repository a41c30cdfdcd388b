"""Input packing: what `CompiledPipeline.run` calls to pack its rows
(`_pack_input`: `core/binarize.py` `pack_pm1` for an MLP, the input
encoding through `ConvFront.pack` for a CNN), read from the traced
stretch: the device time of the operations launched inside that call,
in milliseconds a call.  Nothing to read where `run` no longer calls it,
or where it launches nothing."""

SPAN = "pack"


def wrap(setup):
    return SPAN, setup.pipe, "_pack_input"


def read(ctx):
    if ctx.profile is None:
        return None
    s, n = ctx.profile.layer(SPAN)
    if not n:
        return None
    return 1e3 * s / ctx.profile.calls
