"""How ``correct`` is decided: the answers of the timed path held to the
plain reference (``reference.py``) on the same inputs.

Numbers compared, each against its limit in ``limits/<cell>.json``:

* ``missing``: requests of the window that raised, or returned fewer
  results or other shapes than they submitted;
* ``center_gap``: the largest ``|v_program - v_reference|`` over every
  lane of every request of the window (intensity units, 0-255), the
  reference's iterate taken at the program's own iteration count: the
  ingest (histogram or pixel rows) and the solve's arithmetic. A stop
  that a rounding moves by a step moves no center reading;
* ``iters_share``: the share of those lanes whose iteration count
  differs from the reference's: the solve's stopping. A count one step
  off is excused where the reference's move at the step in dispute lies
  within ``TIE`` (1 %) of the tolerance: there a rounding of the last
  digits decides the stop. A share, not the largest gap: a lane where
  two centers come within rounding of each other departs from exact
  arithmetic by far more than its neighbours, and its stop may move by
  a step; such a slice is one in a thousand or fewer, while a stopping
  rule that is off moves most lanes;
* ``stop_gap``: the largest ``|v_program - v_reference|`` over the same
  lanes, the reference's centers taken where the reference itself
  stopped: the answer the user gets against the reference's answer,
  whatever count the program reports;
* ``label_gap``: over the requests the seed samples, the share of voxels
  whose label differs from the one the reference's labelling gives from
  the program's own centers: the labels and the scatter that returns
  them.

A request's lanes are slices of the run's bank of volumes, so the
reference solves after the window once per bank volume, in float64 (see
``reference.py``), on the device the run used, and every lane of every
request reads its slice's solve.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import reference as R
from . import traffic as TF

NUMBERS = ("missing", "center_gap", "iters_share", "stop_gap",
           "label_gap")
#: the reading of a number that had nothing to compare (no answer)
NO_ANSWER = 1e300
#: a stop one step off is a rounding where the disputed move lies this
#: close to the tolerance, relative to it
TIE = 0.01


@dataclasses.dataclass
class Answers:
    """What the timed path returned: per request its lanes ((bank volume,
    slice) pairs, ``traffic.Pool``), centers (L, c) and iterations (L,);
    of a sample, (lanes, labels (L, *grid), centers (L, c))."""
    route: str
    lanes: List[np.ndarray] = dataclasses.field(default_factory=list)
    centers: List[np.ndarray] = dataclasses.field(default_factory=list)
    iters: List[np.ndarray] = dataclasses.field(default_factory=list)
    missing: int = 0
    sample: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        dataclasses.field(default_factory=list)


def stop_gaps(it: np.ndarray, rit: np.ndarray, moves: np.ndarray,
              tol: np.ndarray) -> np.ndarray:
    """|n_program - n_reference| a lane, 0 where the two are one step
    apart and the reference's move at the earlier of the two steps (the
    one stop in dispute), ``moves[t - 1]`` (T, lanes), lies within TIE of
    the lane's tolerance."""
    gap = np.abs(it - rit)
    move = moves[np.minimum(it, rit) - 1, np.arange(len(it))]
    near = np.abs(move - tol) <= TIE * tol
    return np.where((gap == 1) & near, 0, gap)


class _Solves:
    """The reference's solve of every slice of the bank volumes the
    answers touch, each run until its own stop and at least as far as
    the program went on any of its slices; arrays indexed [volume, ...,
    slice], iterates padded past a volume's last step."""

    def __init__(self, answers: Answers, pool: "TF.Pool", config: Dict,
                 device: torch.device):
        fcm, spatial = config["fcm"], config.get("spatial") or {}
        max_iters = int(fcm["max_iters"])
        nvol = len(pool.volumes)
        until = np.zeros(nvol, np.int64)
        for ln, it in zip(answers.lanes, answers.iters):
            np.maximum.at(until, ln[:, 0], np.clip(it, 0, max_iters))
        used = sorted(set(np.concatenate(
            [ln[:, 0] for ln in answers.lanes]).tolist())
            if answers.lanes else [])
        fits = {}
        for v in used:
            x = torch.from_numpy(pool.volumes[v]).to(device)
            fit = R.solve(answers.route, x, fcm, spatial,
                          until=int(until[v]))
            fits[v] = [t.cpu().numpy() for t in fit]
            del x, fit
        depth, c = pool.volumes[0].shape[0], int(fcm["n_clusters"])
        steps = max([f[2].shape[0] for f in fits.values()], default=1)
        self.traj = np.zeros((nvol, steps, depth, c), np.float64)
        self.moves = np.full((nvol, steps, depth), np.nan, np.float64)
        self.iters = np.zeros((nvol, depth), np.int64)
        self.centers = np.zeros((nvol, depth, c), np.float64)
        self.tol = np.ones((nvol, depth), np.float64)
        for v, (centers, iters, traj, moves, tol) in fits.items():
            t = traj.shape[0]
            self.traj[v, :t] = traj
            self.traj[v, t:] = traj[-1]
            self.moves[v, :t - 1] = moves
            self.iters[v], self.centers[v], self.tol[v] = iters, centers, tol


def readings(answers: Answers, pool: "TF.Pool", config: Dict,
             device: torch.device) -> Dict[str, float]:
    """Every number of ``NUMBERS`` for ``answers`` on the bank of
    ``pool``."""
    fcm, spatial = config["fcm"], config.get("spatial") or {}
    max_iters = int(fcm["max_iters"])
    c = int(fcm["n_clusters"])
    bad = False
    keep = []
    for j, (ln, v, it) in enumerate(zip(answers.lanes, answers.centers,
                                        answers.iters)):
        if (v.shape != (len(ln), c) or it.shape != (len(ln),)
                or it.min() < 1 or it.max() > max_iters):
            bad = True
        else:
            keep.append(j)
    center_gap = iters_share = stop_gap = 0.0
    if keep:
        ref = _Solves(answers, pool, config, device)
        ln = np.concatenate([answers.lanes[j] for j in keep])
        v = np.concatenate([answers.centers[j] for j in keep])
        it = np.concatenate([answers.iters[j] for j in keep])
        vol, z = ln[:, 0], ln[:, 1]
        at = ref.traj[vol, it, z]                 # the reference at n_program
        gaps = stop_gaps(it, ref.iters[vol, z], ref.moves[vol, :, z].T,
                         ref.tol[vol, z])
        center_gap = float(np.abs(v - at).max())
        iters_share = float((gaps > 0).mean())
        stop_gap = float(np.abs(v - ref.centers[vol, z]).max())
        del ref
    if bad:
        center_gap = stop_gap = float("inf")
        iters_share = 1.0
    wrong, total = 0, 0
    for ln, lab, v in answers.sample:
        x = torch.from_numpy(np.stack(pool.payload(ln))).to(device)
        want = R.labels(answers.route, x, torch.from_numpy(
            np.asarray(v, np.float32)).to(device), fcm, spatial)
        want = want.cpu().numpy()
        total += want.size
        wrong += (want.size if lab.shape != want.shape
                  else int((lab != want).sum()))
        del x
    return {"missing": float(answers.missing),
            "center_gap": center_gap,
            "iters_share": iters_share,
            "stop_gap": stop_gap,
            "label_gap": wrong / total if total else float("inf")}


def verdict(values: Dict[str, float],
            limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {number: {"value", "limit"}}): correct when every number
    is at most its limit. Prints each beside its limit on stderr."""
    checks = {}
    ok = True
    for name in NUMBERS:
        v, lim = float(values[name]), float(limits[name])
        good = v <= lim
        if not math.isfinite(v):    # no answer to compare: JSON-safe
            v = NO_ANSWER
        ok &= good
        checks[name] = {"value": v, "limit": lim}
        print(f"check {name} {v!r} <= {lim!r} {'ok' if good else 'FAIL'}",
              file=sys.stderr)
    return ok, checks
