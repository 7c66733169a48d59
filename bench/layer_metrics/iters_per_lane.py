"""iters_per_lane: solver iterations a real lane took (``core/solver.py``,
the kernel's loop), the exact mean of the engine's ``route.lane_iters``
histogram over the traced window (one sample a real lane; padding lanes
are not counted)."""


def read(ctx):
    h = ctx.histogram(f"route.lane_iters{{route={ctx.route}}}")
    return None if h is None else h["sum"] / h["count"]
