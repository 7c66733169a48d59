"""The roofline counts against shapes worked by hand."""
import numpy as np
import pytest

from harness import peaks, spec


def test_resident_solve_counts():
    cnt = spec.counts("resident_solve")
    # 3 iterations of 2 rows at c=4: 3 * (2 * (10*4 + 1) + 3*4)
    assert cnt.flops(2, 3, 4) == 282
    # 256 values + 256 weights + 4 centers + tol read, 4 + 2 written
    assert cnt.nbytes(256, 4) == 4 * (512 + 5) + 4 * 6
    rows, iters = np.array([2, 10]), np.array([3, 1])
    np.testing.assert_array_equal(cnt.flops(rows, iters, 4),
                                  [282, 10 * 41 + 12])


def test_stencil_solve_counts():
    cnt = spec.counts("stencil_solve")
    # 10 px, 8 nb, c=4, 2 iterations: 10*29 + 2*(10*57 + 20)
    assert cnt.flops(10, 2, 4, 8) == 1470
    assert cnt.nbytes(10, 4) == 4 * 15 + 24
    np.testing.assert_array_equal(cnt.flops(10, np.array([0, 2]), 4, 8),
                                  [290, 1470])


def test_roofline_takes_the_larger_bound():
    assert peaks.roofline_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.roofline_s(67e12, 6.7e12) == pytest.approx(2.0)
