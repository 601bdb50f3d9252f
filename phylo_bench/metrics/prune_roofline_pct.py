"""The least time for the pruning work of the traced window's calls
(``roofline.py``, whatever walk does it) as a share of the device's busy
time in the window (the union of its operations' intervals), in percent.
A gradient counts the forward and the reverse."""


def read(ctx):
    if not ctx.calls or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * ctx.least_s / ctx.trace.busy_s
