"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card: 100 * (1 - union of the profiler's device
intervals / window)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
