"""Elastic scaling and straggler mitigation.

When devices fail, the launcher re-forms a mesh over the devices left,
restores the latest checkpoint and moves it onto the new mesh
(checkpoints are mesh-agnostic, :mod:`repro_torch.training.checkpoint`).

:func:`plan_mesh` picks the largest usable (pod, data, model)
factorization for a device count, preferring tp = 16 as the JAX package
does (one TPU v5e tray; an H100 node's NVLink domain is 8 cards, and the
policy is kept as it is). :func:`reshard_state` places a restored
state on a new mesh by its specs. :class:`StepTimer` is the straggler watchdog: step
durations, outlier flagging (> threshold x the rolling median) and a
hook the launcher can use to checkpoint and rebalance.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional, Sequence, Tuple

from ..core import distributed as D
from ..models import sharding as sh


def plan_mesh(n_devices: int, model_parallel: Optional[int] = None,
              pods: int = 1, devices: Optional[Sequence] = None) -> D.Mesh:
    """The largest mesh (pod, data, model) over at most ``n_devices``
    devices. tp is the first of 16, 8, 4, 2, 1 that divides a pod's
    devices unless ``model_parallel`` names it. ``devices`` defaults to
    the visible cards and may name one device several times."""
    per_pod = n_devices // pods
    if model_parallel is None:
        for tp in (16, 8, 4, 2, 1):
            if per_pod % tp == 0 and per_pod >= tp:
                model_parallel = tp
                break
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError(f"{n_devices} devices in {pods} pods cannot hold "
                         f"tp = {model_parallel}")
    n = pods * data * model_parallel
    devs = None if devices is None else list(devices)[:n]
    if pods > 1:
        return D.make_mesh((pods, data, model_parallel),
                           ("pod", "data", "model"), devices=devs)
    return D.make_mesh((data, model_parallel), ("data", "model"),
                       devices=devs)


def reshard_state(state, specs, new_mesh: Optional[D.Mesh]
                  ) -> Tuple[object, sh.Parallelism]:
    """Place a state tree on ``new_mesh`` per its logical ``specs``
    (:func:`repro_torch.models.sharding.place`, the JAX package's
    ``device_put`` of each leaf by its ``NamedSharding``). The source may
    be whole (on the host or a device) or placed on another mesh; each
    slot's block is cut from the source's blocks that cover it. Without
    a mesh the state comes back whole (placed leaves gathered on their
    mesh's lead device). Returns ``(state, the new Parallelism)``; every
    leaf's spec is checked against its shape and pruned for the mesh."""
    ctx = sh.make_parallelism(new_mesh)
    return sh.place(state, specs, ctx), ctx


class StepTimer:
    """Rolling straggler detector: flags steps slower than
    ``threshold`` x the rolling median and counts consecutive slow steps
    so the launcher can trigger a checkpoint and re-mesh."""

    def __init__(self, window: int = 32, threshold: float = 2.0,
                 consecutive_limit: int = 5,
                 on_straggler: Optional[Callable[[float, float],
                                                 None]] = None):
        self.durations = deque(maxlen=window)
        self.threshold = threshold
        self.consecutive_limit = consecutive_limit
        self.consecutive_slow = 0
        self.total_flagged = 0
        self.on_straggler = on_straggler
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record; returns True if rebalance is recommended."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop without start")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        med = self.median()
        self.durations.append(dt)
        if med is not None and dt > self.threshold * med:
            self.total_flagged += 1
            self.consecutive_slow += 1
            if self.on_straggler:
                self.on_straggler(dt, med)
        else:
            self.consecutive_slow = 0
        return self.consecutive_slow >= self.consecutive_limit

    def median(self) -> Optional[float]:
        if len(self.durations) < 4:
            return None
        s = sorted(self.durations)
        return s[len(s) // 2]
