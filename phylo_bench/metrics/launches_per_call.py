"""Kernels launched on the device in the traced window (profiler events,
the engine's own kernels and the pruning walks alike) a call."""


def read(ctx):
    if not ctx.calls or ctx.trace.launches == 0:
        return None
    return ctx.trace.launches / ctx.calls
