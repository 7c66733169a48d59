"""voxels_per_s.hist: the voxels of every request completed in the traced
window over the window's seconds, on the host's clock, in Mvox/s: the
throughput of ``FCMServeEngine.segment`` as a whole, under the profiler.

It stands per layer where the rate's runs spread too widely between
processes for an end-to-end bound; it moves the request latency."""


def read(ctx):
    if not ctx.voxels or ctx.window_s <= 0:
        return None
    return ctx.voxels / ctx.window_s / 1e6
