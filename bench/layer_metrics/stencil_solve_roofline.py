"""stencil_solve_roofline: row 8's share of its roofline, in %: the
least time the real lanes' FCM_S whole-solves could take on the card
(``counts/stencil_solve.py`` at each lane's pixels and iterations;
padding lanes count nothing) over the profiler's device time of the
stencil whole-solve kernels in the traced window."""

KERNELS = ("stencil_onchip_kernel", "stencil_offchip_kernel")


def read(ctx):
    tr = ctx.trace
    t = 0.0 if tr is None else tr.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    cnt = ctx.counts("stencil_solve")
    c = int(ctx.config["fcm"]["n_clusters"])
    nb = int(ctx.config["spatial"]["neighbors_2d"])
    flops = nbytes = 0.0
    px = ctx.pool.slice_pixels
    for iters in ctx.iters:
        flops += float(cnt.flops(px, iters, c, nb).sum())
        nbytes += len(iters) * cnt.nbytes(px, c)
    return 100.0 * ctx.roofline_s(flops, nbytes) / t
