"""The card: the share of the traced window in which no operation ran on
it (the union of the device operations' intervals), in %."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
