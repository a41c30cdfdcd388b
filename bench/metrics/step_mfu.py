"""The whole step: the least time the model's work for one batch needs on
the card (`roofline.step`: the user's rows and keys as handed in, the
packed weights, the votes written, every layer's bit-MACs; the larger of
its bytes at the memory bandwidth and its bit-MACs at the 1-bit rate)
over the window's time a batch, in %.  It counts the same work whatever
implements it."""

from bench import roofline


def read(ctx):
    w = ctx.window
    if not w.in_window:
        return None
    key_bytes = 0 if ctx.setup.keys is None else (
        ctx.setup.keys.shape[-1] * ctx.setup.keys.element_size())
    bound = roofline.step(ctx.setup.cfg, ctx.batch, key_bytes).bound_s()
    return 100.0 * bound * w.in_window / w.seconds
