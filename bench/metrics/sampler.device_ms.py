"""Samplers: the program's keyed draw on the timed path
(`core/physics.py` `SearchPhysics.sample_keyed` over `core/keys.py`,
each row's thresholds from its own key words), read from the traced
stretch: the device time of the operations launched inside that call,
in milliseconds a call.  Nothing to read where the spec takes no per-row
keys or `run` no longer calls it."""

SPAN = "sampler"


def wrap(setup):
    if setup.keys is None or setup.pipe.physics is None:
        return None
    return SPAN, setup.pipe.physics, "sample_keyed"


def read(ctx):
    if ctx.profile is None:
        return None
    s, n = ctx.profile.layer(SPAN)
    if not n:
        return None
    return 1e3 * s / ctx.profile.calls
