"""resident_solve_roofline: row 2's share of its roofline, in %: the
least time the real lanes' work could take on the card
(``counts/resident_solve.py`` at each lane's distinct intensities and
iterations; padding lanes count nothing) over the profiler's device time
of ``resident_solve_kernel`` in the traced window."""

KERNELS = ("resident_solve_kernel",)


def read(ctx):
    tr = ctx.trace
    t = 0.0 if tr is None else tr.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    cnt = ctx.counts("resident_solve")
    c = int(ctx.config["fcm"]["n_clusters"])
    flops = nbytes = 0.0
    for lanes, iters in zip(ctx.lanes, ctx.iters):
        flops += float(cnt.flops(ctx.nonzero_bins(lanes), iters, c).sum())
        nbytes += len(iters) * cnt.nbytes(256, c)
    return 100.0 * ctx.roofline_s(flops, nbytes) / t
