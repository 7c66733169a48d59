"""Sequential FCM baselines (the paper's comparison floor).

The paper benchmarks against a sequential C implementation derived from a
Java reference. Two fidelity levels are provided:

* :func:`fcm_sequential_python` — literal per-pixel loops, matching the
  C code's structure statement-for-statement. Only usable for tiny N;
  exists so tests can pin the numerics of the other implementations to
  the paper's reference semantics.
* :func:`fcm_sequential_numpy` — the same algorithm vectorized with
  single-threaded numpy. This is the "sequential CPU" comparator (a
  Python interpreter loop would understate the paper's C baseline by
  ~100x; numpy is the closest stand-in for compiled single-core C).

Both sit behind the unified solver as
``repro_torch.core.solver.solve(pixel_problem(x), backend="sequential")``,
which runs them on the host whatever the problem's device; the paper's
CPU-vs-card comparison (``chip_smoke.py``'s Table 3 ladder) runs every
side from that one entry point.

This module is numpy only, a copy of the JAX package's
``core/sequential.py``: the same ``default_rng(seed)`` draws, so its
results equal that module's bit for bit.
"""
from __future__ import annotations

import numpy as np


def _init_membership(rng: np.random.Generator, c: int, n: int) -> np.ndarray:
    u = rng.uniform(1e-3, 1.0, size=(c, n))
    return u / u.sum(axis=0, keepdims=True)


def fcm_sequential_python(x, c=4, m=2.0, eps=5e-3, max_iters=300, seed=0):
    """Literal port: nested loops over pixels and clusters."""
    x = np.asarray(x, np.float64).ravel()
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    u = _init_membership(rng, c, n)
    v = np.zeros(c)
    exp = -2.0 / (m - 1.0)
    for it in range(max_iters):
        # Eq. 3 — cluster centers (the paper's 4-kernel phase, as loops).
        for j in range(c):
            num = 0.0
            den = 0.0
            for i in range(n):
                w = u[j, i] ** m
                num += w * x[i]
                den += w
            v[j] = num / max(den, 1e-12)
        # Eq. 4 — memberships.
        u_new = np.empty_like(u)
        for i in range(n):
            d = np.abs(x[i] - v)
            if np.any(d == 0.0):
                z = (d == 0.0)
                u_new[:, i] = z / z.sum()
                continue
            p = d ** exp
            u_new[:, i] = p / p.sum()
        delta = np.abs(u_new - u).max()
        u = u_new
        if delta < eps:
            break
    labels = u.argmax(axis=0).astype(np.int32)
    return v, labels, it + 1


def fcm_sequential_numpy(x, c=4, m=2.0, eps=5e-3, max_iters=300, seed=0,
                         u0=None):
    """Single-core numpy FCM, same algorithm and init as the Python port."""
    x = np.asarray(x, np.float64).ravel()
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    u = _init_membership(rng, c, n) if u0 is None else np.asarray(u0, np.float64)
    for it in range(max_iters):
        um = u ** m                                    # (c, n)
        v = (um @ x) / np.maximum(um.sum(axis=1), 1e-12)
        d2 = (v[:, None] - x[None, :]) ** 2            # (c, n)
        p = np.clip(d2, 1e-12, None) ** (-1.0 / (m - 1.0))
        u_new = p / p.sum(axis=0, keepdims=True)
        zero = d2 <= 0.0
        any_zero = zero.any(axis=0)
        if any_zero.any():
            zz = zero[:, any_zero]
            u_new[:, any_zero] = zz / zz.sum(axis=0, keepdims=True)
        delta = np.abs(u_new - u).max()
        u = u_new
        if delta < eps:
            break
    labels = u.argmax(axis=0).astype(np.int32)
    return v, labels, it + 1
