"""The whole step: the least time the model's work for one call needs on
the card (the kind's `step_work`, `bench/kinds/<model>.py`; for the
binary classifiers `roofline.step`: the user's rows and keys as handed
in, the packed weights, the votes written, every layer's bit-MACs; the
largest of its bytes at the memory bandwidth, its bit-MACs at the 1-bit
rate and its floating-point operations at the bfloat16 rate) over the
window's time a call, in %.  It counts the same work whatever implements
it."""


def read(ctx):
    w = ctx.window
    if not w.in_window:
        return None
    bound = ctx.setup.kind.step_work(ctx.setup).bound_s()
    return 100.0 * bound * w.in_window / w.seconds
