"""The plain reference the check holds the program to: weighted-histogram
FCM, pixel FCM and FCM_S (8 neighbours in 2-D, 6 in 3-D), in plain
PyTorch, lane by lane masked as the program's solver stops each lane.

It imports nothing of the program. Its algorithm is the configuration's:

* init: ``c`` centers spaced evenly over a lane's intensity support,
  ``lo + (j + 0.5) / c * (hi - lo)``; the support of a histogram is the
  bins with a nonzero count, of an image its pixels;
* stop: after the step whose largest center move is below
  ``tol = eps * (hi - lo) * 0.1`` (``eps`` itself where ``hi == lo``),
  or after ``max_iters`` steps; a lane's count includes that last step;
* step (Eq. 4 into Eq. 3): ``u_ji = d_ji^(-2/(m-1)) / sum_k d_ki^(-2/(m-1))``
  (a zero distance takes the whole membership, split among ties);
  ``v_j = sum_i w_i u_ji^m x_i / sum_i w_i u_ji^m``;
* FCM_S (Ahmed et al. 2002): the distance is ``d_ji^2 + alpha *
  mean_{r in N_i} d_jr^2`` and the feature ``(x_i + alpha * xbar_i) /
  (1 + alpha)``, ``N_i`` the in-grid neighbours of pixel i;
* labels: the nearest center (histogram, pixel FCM), the largest FCM_S
  membership (spatial); ties go to the lowest index.

The check solves in float64 (``solve``'s default) and labels in float32,
the program's precision, so that a label is judged by the same arithmetic
that made it. A float32 solve is no yardstick for a float32 program: on a
slice where two centers come within rounding of each other after a step,
float32 can merge them for good, and the float64 solve keeps them apart
as exact arithmetic does. The control runs the same code in bfloat16.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

D2_FLOOR = 1e-12

OFFSETS_2D_8 = ((-1, 0), (1, 0), (0, -1), (0, 1),
                (-1, -1), (-1, 1), (1, -1), (1, 1))
OFFSETS_2D_4 = OFFSETS_2D_8[:4]
OFFSETS_3D_6 = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                (0, 0, -1), (0, 0, 1))


def offsets(ndim: int, neighbors: int):
    table = {(2, 4): OFFSETS_2D_4, (2, 8): OFFSETS_2D_8, (3, 6): OFFSETS_3D_6}
    if (ndim, neighbors) not in table:
        raise ValueError(f"no {neighbors}-neighbour stencil in {ndim}-D")
    return table[(ndim, neighbors)]


def membership(d2: torch.Tensor, m: float, dim: int) -> torch.Tensor:
    """Eq. 4 along the cluster axis ``dim``."""
    p = torch.clamp(d2, min=D2_FLOOR) ** (-1.0 / (m - 1.0))
    u = p / p.sum(dim=dim, keepdim=True)
    zero = d2 <= 0.0
    share = zero.to(u.dtype) / zero.sum(dim=dim, keepdim=True).clamp(
        min=1).to(u.dtype)
    return torch.where(zero.any(dim=dim, keepdim=True), share, u)


def init_centers(lo: torch.Tensor, hi: torch.Tensor, c: int, eps: float):
    """(B,) supports -> (v0 (B, c), tol (B,)) in their dtype."""
    frac = (torch.arange(c, dtype=lo.dtype, device=lo.device) + 0.5) / c
    v0 = lo[:, None] + frac[None, :] * (hi - lo)[:, None]
    rng = hi - lo
    tol = eps * torch.where(rng > 0, rng, torch.ones_like(rng)) * 0.1
    return v0, tol


class Fit(NamedTuple):
    """A solve's centers at each lane's stop (B, c), its iteration count
    (B,), every iterate ``traj[t]`` (T + 1, B, c) of every lane, past its
    stop up to ``until`` steps where asked, each step's largest move
    ``moves[t - 1]`` (T, B) and the lanes' tolerances (B,)."""
    centers: torch.Tensor
    iters: torch.Tensor
    traj: torch.Tensor
    moves: torch.Tensor
    tol: torch.Tensor


def iterate(step, v0: torch.Tensor, tol: torch.Tensor, max_iters: int,
            until: int = 0) -> Fit:
    """Step every lane; a lane stops after the step whose largest move is
    below its tol (or at ``max_iters``), and its centers there are its
    answer. Lanes go on stepping until every lane has stopped and
    ``until`` steps are taken, so the check can read the iterate at the
    program's own count."""
    b = v0.shape[0]
    done = torch.zeros(b, dtype=torch.bool, device=v0.device)
    iters = torch.full((b,), max_iters, dtype=torch.int64, device=v0.device)
    traj, moves = [v0], []
    v = v0
    for t in range(1, max_iters + 1):
        if bool(done.all()) and t > until:
            break
        v_new = step(v)
        move = (v_new - v).abs().max(dim=1).values
        stop = ~done & (move < tol)
        iters = torch.where(stop, t, iters)
        done = done | stop
        traj.append(v_new)
        moves.append(move)
        v = v_new
    traj_t = torch.stack(traj)
    lanes = torch.arange(b, device=v0.device)
    moves_t = (torch.stack(moves) if moves
               else torch.zeros((0, b), dtype=v0.dtype, device=v0.device))
    return Fit(traj_t[iters, lanes], iters, traj_t, moves_t, tol)


# -- histogram route ---------------------------------------------------------

def histograms(pixels: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """(B, N) integer intensities -> (B, n_bins) float32 counts."""
    b = pixels.shape[0]
    idx = pixels.to(torch.int64) + n_bins * torch.arange(
        b, device=pixels.device)[:, None]
    return torch.bincount(idx.reshape(-1), minlength=b * n_bins).reshape(
        b, n_bins).to(torch.float32)


def weighted_fcm(vals: torch.Tensor, w: torch.Tensor, c: int, m: float,
                 eps: float, max_iters: int, dtype=torch.float32,
                 until: int = 0) -> Fit:
    """Weighted FCM over each lane's scalar rows: values (B, K) with
    weights (B, K). Rows of weight 0 are inert and outside the
    support."""
    vals, w = vals.to(dtype), w.to(dtype)
    big = torch.finfo(dtype).max
    present = w > 0
    lo = torch.where(present, vals, big).min(dim=1).values
    hi = torch.where(present, vals, -big).max(dim=1).values
    v0, tol = init_centers(lo, hi, c, eps)

    def step(v):
        u = membership((v[:, :, None] - vals[:, None, :]) ** 2, m, dim=1)
        um = (u ** m) * w[:, None, :]
        num = (um * vals[:, None, :]).sum(dim=-1)
        return num / torch.clamp(um.sum(dim=-1), min=D2_FLOOR)

    return iterate(step, v0, tol, max_iters, until)


def hist_fcm(hists: torch.Tensor, c: int, m: float, eps: float,
             max_iters: int, dtype=torch.float32, until: int = 0) -> Fit:
    """FCM over the bins of each lane's histogram (B, n_bins), the counts
    as weights."""
    b, nb = hists.shape
    vals = torch.arange(nb, dtype=torch.float32,
                        device=hists.device).expand(b, nb)
    return weighted_fcm(vals, hists, c, m, eps, max_iters, dtype, until)


def pixel_fcm(x: torch.Tensor, c: int, m: float, eps: float,
              max_iters: int, dtype=torch.float32, until: int = 0) -> Fit:
    """FCM over every pixel of each lane (B, N), unit weights."""
    return weighted_fcm(x, torch.ones_like(x, dtype=torch.float32), c, m,
                        eps, max_iters, dtype, until)


def nearest_labels(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, N) intensities and (B, c) centers -> (B, N) nearest-center
    labels, in ``v``'s dtype, through a table over the 256 intensities
    when ``x`` is 8-bit."""
    if x.dtype == torch.uint8:
        vals = torch.arange(256, dtype=v.dtype, device=v.device)
        lut = torch.argmin((v[:, :, None] - vals[None, None, :]) ** 2,
                           dim=1)
        return torch.gather(lut, 1, x.to(torch.int64))
    d2 = (v[:, :, None] - x.to(v.dtype)[:, None, :]) ** 2
    return torch.argmin(d2, dim=1)


# -- FCM_S -------------------------------------------------------------------

def _shift(a: torch.Tensor, off) -> torch.Tensor:
    """Zero-filled shift of the trailing axes: out[i] = a[i - off]."""
    out = torch.zeros_like(a)
    lead = a.dim() - len(off)
    dst = [slice(None)] * lead
    src = [slice(None)] * lead
    for ax, o in enumerate(off):
        n = a.shape[lead + ax]
        if abs(o) >= n:
            return out
        dst.append(slice(o, n) if o >= 0 else slice(0, n + o))
        src.append(slice(0, n - o) if o >= 0 else slice(-o, n))
    out[tuple(dst)] = a[tuple(src)]
    return out


class Stencil:
    """The iteration-invariant fields of FCM_S over lanes ``x`` (B, *grid):
    each pixel's shifted neighbours and in-grid masks, its neighbour
    count and mean intensity."""

    def __init__(self, x: torch.Tensor, neighbors: int):
        self.x = x
        offs = offsets(x.dim() - 1, neighbors)
        ones = torch.ones_like(x)
        self.masks = [_shift(ones, o) for o in offs]
        self.shifted = [_shift(x, o) for o in offs]
        cnt = torch.zeros_like(x)
        sx = torch.zeros_like(x)
        for w, xs in zip(self.masks, self.shifted):
            cnt = cnt + w
            sx = sx + w * xs
        self.cnt = torch.clamp(cnt, min=1.0)
        self.xbar = sx / self.cnt

    def distance(self, v: torch.Tensor, alpha: float) -> torch.Tensor:
        """(B, c) centers -> (B, c, *grid) effective squared distances."""
        vb = v.reshape(v.shape + (1,) * (self.x.dim() - 1))
        nb = torch.zeros((v.shape[0], v.shape[1]) + self.x.shape[1:],
                         dtype=self.x.dtype, device=self.x.device)
        for w, xs in zip(self.masks, self.shifted):
            nb = nb + w.unsqueeze(1) * (vb - xs.unsqueeze(1)) ** 2
        d2 = (vb - self.x.unsqueeze(1)) ** 2
        return d2 + alpha * (nb / self.cnt.unsqueeze(1))

    def membership(self, v: torch.Tensor, m: float,
                   alpha: float) -> torch.Tensor:
        d = self.distance(v, alpha)
        b, c = v.shape
        return membership(d.reshape(b, c, -1), m, dim=1).reshape(d.shape)


def stencil_fcm(imgs: torch.Tensor, c: int, m: float, alpha: float,
                neighbors: int, eps: float, max_iters: int,
                dtype=torch.float32, until: int = 0) -> Fit:
    """FCM_S of each lane of (B, *grid)."""
    x = imgs.to(dtype)
    flat = x.reshape(x.shape[0], -1)
    v0, tol = init_centers(flat.min(dim=1).values, flat.max(dim=1).values,
                           c, eps)
    st = Stencil(x, neighbors)
    x_eff = ((x + alpha * st.xbar) / (1.0 + alpha)).reshape(x.shape[0], 1, -1)

    def step(v):
        um = st.membership(v, m, alpha).reshape(v.shape[0], c, -1) ** m
        num = (um * x_eff).sum(dim=-1)
        return num / torch.clamp(um.sum(dim=-1), min=D2_FLOOR)

    return iterate(step, v0, tol, max_iters, until)


def stencil_labels(imgs: torch.Tensor, v: torch.Tensor, m: float,
                   alpha: float, neighbors: int,
                   dtype=torch.float32) -> torch.Tensor:
    """The largest FCM_S membership of each pixel: (B, *grid)."""
    st = Stencil(imgs.to(dtype), neighbors)
    return torch.argmax(st.membership(v.to(dtype), m, alpha), dim=1)


def solve(route: str, payload: torch.Tensor, fcm: dict, spatial: dict,
          dtype=torch.float64, until: int = 0) -> Fit:
    """One study's lanes (B, *grid) through the route's algorithm."""
    c, m = int(fcm["n_clusters"]), float(fcm["m"])
    eps, mi = float(fcm["eps"]), int(fcm["max_iters"])
    if route == "histogram":
        return hist_fcm(histograms(payload.reshape(payload.shape[0], -1)),
                        c, m, eps, mi, dtype, until)
    if route == "pixel":
        return pixel_fcm(payload.reshape(payload.shape[0], -1).to(
            torch.float32), c, m, eps, mi, dtype, until)
    if route == "spatial":
        nb = neighbors_for(spatial, payload.dim() - 1)
        return stencil_fcm(payload, c, m, float(spatial["alpha"]), nb, eps,
                           mi, dtype, until)
    raise ValueError(f"no reference for route {route!r}")


def labels(route: str, payload: torch.Tensor, v: torch.Tensor, fcm: dict,
           spatial: dict, dtype=torch.float32) -> torch.Tensor:
    """The labels the route's algorithm gives ``payload`` (B, *grid)
    from centers ``v`` (B, c), shaped like ``payload``."""
    if route in ("histogram", "pixel"):
        flat = payload.reshape(payload.shape[0], -1)
        return nearest_labels(flat, v.to(dtype)).reshape(payload.shape)
    if route == "spatial":
        nb = neighbors_for(spatial, payload.dim() - 1)
        return stencil_labels(payload, v, float(fcm["m"]),
                              float(spatial["alpha"]), nb, dtype)
    raise ValueError(f"no reference for route {route!r}")


def neighbors_for(spatial: dict, ndim: int) -> int:
    return int(spatial["neighbors_2d"] if ndim == 2 else
               spatial["neighbors_3d"])
