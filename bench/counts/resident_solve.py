"""Row 2, the resident whole-solve of the histogram route
(``csrc/fcm_resident.cu`` ``resident_solve_kernel``): one lane's weighted
FCM over its 256 (value, count) rows until it stops.

Operations the inputs need, at the iterations run, with m = 2 (u^m one
multiply, d^(-2/(m-1)) one reciprocal), counting only rows of nonzero
weight (an empty bin adds nothing to either sum):

* a (row, cluster) an iteration: the difference and its square (2), its
  reciprocal (1), the sum over clusters (1), the normalisation (1), u^2
  (1), the weight (1), the numerator's multiply-add (2), the denominator's
  add (1): 10;
* a row an iteration: the reciprocal of its sum (1);
* a lane an iteration: c divisions for v', and |v' - v| with its maximum
  (2c).

Bytes: each lane's 256 values and 256 weights read once (float32), its
initial centers and tolerance read, its centers, last move and iteration
count written.

Every argument may be a NumPy array of lanes.
"""


def flops(rows: int, iters: int, c: int) -> float:
    return iters * (rows * (10 * c + 1) + 3 * c)


def nbytes(bins: int, c: int) -> float:
    return 4.0 * (2 * bins + c + 1) + 4.0 * (c + 2)
