"""Row 8, the stencil whole-solve of the spatial route
(``csrc/fcm_stencil.cu`` ``stencil_onchip_kernel`` /
``stencil_offchip_kernel``): one lane's FCM_S over its N pixels until it
stops.

Operations the inputs need, with m = 2 and the neighbour term in its
least form, ``mean_r (v - x_r)^2 = v^2 - 2 v xbar + x2bar``:

* a pixel once: the neighbour means of x and of x^2 (nb adds and a
  division; nb multiplies, nb adds and a division), the effective
  feature ``(x + alpha xbar) / (1 + alpha)`` (3): 3 nb + 5;
* a (pixel, cluster) an iteration: the neighbour term from v^2 and 2v
  (3), the own distance (2), ``d2 + alpha * nb`` (2), the reciprocal (1),
  the sum over clusters (1), the normalisation (1), u^2 (1), the
  numerator's multiply-add (2), the denominator's add (1): 14;
* a pixel an iteration: the reciprocal of its sum (1);
* a lane an iteration: v^2 and 2v (2c), c divisions for v' and
  |v' - v| with its maximum (3c).

Bytes: the lane's float32 pixels read once, its initial centers and
tolerance read, its centers, last move and iteration count written.

Every argument may be a NumPy array of lanes.
"""


def flops(pixels: int, iters: int, c: int, neighbors: int) -> float:
    return (pixels * (3.0 * neighbors + 5)
            + iters * (pixels * (14 * c + 1) + 5.0 * c))


def nbytes(pixels: int, c: int) -> float:
    return 4.0 * (pixels + c + 1) + 4.0 * (c + 2)
