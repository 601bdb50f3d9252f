"""The share of the traced window in which no operation ran on the
device, in percent."""


def read(ctx):
    if ctx.trace.window_s <= 0.0 or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * ctx.trace.idle_share
