"""Deterministic fault injection for chaos-testing the serving stack.

Real failures (a flaky launch, a NaN payload, a dead flusher thread) are
rare and hard to reproduce. A :class:`FaultPlan` makes them cheap and
deterministic: a seedable list of :class:`FaultSpec` entries naming an
injection *site*, a fault kind and a firing rule (the Nth..Mth eligible
hit, or an i.i.d. probability drawn from the plan's seed). The hooks in
the engine, solver and kernel layers are no-ops unless an injector is
installed, so the production path pays one ``is None`` check. One plan
fires on the same hits as the same plan in the JAX package.

Sites:

=================  ============================================  =============
site               where the hook runs                            kinds
=================  ============================================  =============
``ingest``         engine ``_ingest`` (per request)               error/latency
``launch``         engine ``_run_bucket``, per launch *attempt*   error/latency
``solve``          engine post-solve centers (per chunk)          nan/inf
``solve_batched``  global hook in ``core.solver.solve_batched``   nan/inf
``kernel``         global hook in ``kernels.ops.select_step``     error
``flusher``        top of each ``_flusher_loop`` iteration        error/kill
=================  ============================================  =============

Kinds: ``"error"`` raises :class:`InjectedFault` (transient, retryable);
``"kill"`` raises :class:`FlusherKilled` (a ``BaseException`` that
escapes ``except Exception`` supervision: hard thread death);
``"latency"`` sleeps ``latency_s``; ``"nan"`` / ``"inf"`` poison the
listed ``lanes`` of an array at a corrupt site.

Engine-owned injectors are passed to ``FCMServeEngine(faults=...)`` and
count into the engine's metrics registry; the module-level ``install()``
/ ``get()`` / ``clear()`` injector reaches the solver and kernel hooks,
which have no engine in scope.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "FaultSpec", "FaultPlan", "FaultInjector", "InjectedFault",
    "FlusherKilled", "clean_snapshot", "install", "get", "clear",
]

KINDS = ("error", "nan", "inf", "latency", "kill")


class InjectedFault(RuntimeError):
    """A deliberately injected *transient* failure (retryable)."""


class FlusherKilled(BaseException):
    """Injected hard thread death. A ``BaseException``, so it escapes
    ``except Exception`` supervision: the thread really dies, and
    recovery must come from re-ensuring a live flusher."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule.

    Fires at a ``site`` (only for one ``route`` when given), on eligible
    hits ``after <= hit < after + times`` (``times=None``: every hit from
    ``after`` on), or i.i.d. with probability ``p`` when ``p > 0`` (drawn
    from the plan's seeded generator, so runs replay). ``latency_s``
    matters for ``kind="latency"`` only; ``lanes`` names the batch lanes a
    ``nan`` / ``inf`` corrupt site poisons.
    """
    site: str
    kind: str = "error"
    route: Optional[str] = None
    times: Optional[int] = 1
    after: int = 0
    p: float = 0.0
    latency_s: float = 0.0
    lanes: Tuple[int, ...] = (0,)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seedable, ordered set of fault specs: same plan, same traffic,
    same injected failures."""
    seed: int = 0
    specs: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))


class FaultInjector:
    """Executes a :class:`FaultPlan` at the hook sites.

    Thread-safe (the flusher thread and the submitters share it). Every
    firing decision is deterministic given the plan: hit counters are per
    spec, and probabilistic specs draw from a per-spec
    ``numpy.random.Generator`` seeded from ``(plan.seed, spec index)``.
    """

    def __init__(self, plan: FaultPlan, registry: Optional[Any] = None):
        self.plan = plan
        self._registry = registry
        self._lock = threading.Lock()
        self._hits = [0] * len(plan.specs)
        self._rngs = [np.random.default_rng((plan.seed, i))
                      for i in range(len(plan.specs))]
        self._injected = 0
        self._by_site: Dict[str, int] = {}

    # -- firing decisions ---------------------------------------------------

    def _fire(self, i: int, spec: FaultSpec) -> bool:
        """Under the lock: advance spec i's hit counter and decide whether
        it fires on this hit."""
        hit = self._hits[i]
        self._hits[i] = hit + 1
        if spec.p > 0.0:
            return bool(self._rngs[i].random() < spec.p)
        if hit < spec.after:
            return False
        return spec.times is None or hit < spec.after + spec.times

    def _matching(self, site: str, route: Optional[str]):
        for i, spec in enumerate(self.plan.specs):
            if spec.site != site:
                continue
            if spec.route is not None and spec.route != route:
                continue
            yield i, spec

    def _record(self, site: str, kind: str) -> None:
        self._injected += 1
        self._by_site[site] = self._by_site.get(site, 0) + 1
        if self._registry is not None:
            self._registry.counter("faults.injected", site=site,
                                   kind=kind).inc()

    # -- hook entry points --------------------------------------------------

    def maybe_fail(self, site: str, route: Optional[str] = None) -> None:
        """Raise or delay per the plan at an execution site: ``latency``
        specs sleep (outside the lock) and fall through, ``error`` raises
        :class:`InjectedFault`, ``kill`` raises :class:`FlusherKilled`."""
        sleep_s = 0.0
        boom: Optional[BaseException] = None
        with self._lock:
            for i, spec in self._matching(site, route):
                if spec.kind in ("nan", "inf"):
                    continue            # corrupt-site specs do not raise
                if not self._fire(i, spec):
                    continue
                self._record(site, spec.kind)
                if spec.kind == "latency":
                    sleep_s += spec.latency_s
                elif spec.kind == "kill":
                    boom = FlusherKilled(f"injected kill at {site}")
                    break
                else:
                    boom = InjectedFault(
                        f"injected fault at {site}"
                        + (f" (route={route})" if route else ""))
                    break
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        if boom is not None:
            raise boom

    def corrupt(self, site: str, arr, route: Optional[str] = None):
        """Poison lanes of a centers-like array per every firing ``nan`` /
        ``inf`` spec at this site. ``arr`` is a numpy array or a torch
        tensor, leading axis the batch lanes. Returns a poisoned copy (a
        tensor's clone stays on its own device, with no host round trip),
        or ``arr`` itself when nothing fires."""
        poison = []                     # (lanes, value) pairs
        with self._lock:
            for i, spec in self._matching(site, route):
                if spec.kind not in ("nan", "inf"):
                    continue
                if not self._fire(i, spec):
                    continue
                self._record(site, spec.kind)
                poison.append((spec.lanes,
                               np.nan if spec.kind == "nan" else np.inf))
        if not poison:
            return arr
        n = arr.shape[0]
        if isinstance(arr, np.ndarray):
            out = np.array(arr, copy=True)
        else:
            out = arr.clone()
        for lanes, val in poison:
            for lane in lanes:
                if 0 <= lane < n:
                    out[lane] = val
        return out

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``faults`` section of an engine report: enough to tell an
        injected run from a clean one."""
        with self._lock:
            return {"seed": self.plan.seed,
                    "injected": self._injected,
                    "by_site": dict(self._by_site),
                    "chaos": self._injected > 0 or bool(self.plan.specs)}


def clean_snapshot() -> Dict[str, Any]:
    """What a run with no injector reports: the explicit "no faults were
    injected here" marker."""
    return {"seed": None, "injected": 0, "by_site": {}, "chaos": False}


# ---------------------------------------------------------------------------
# The global injector (solver and kernel hooks, which have no engine in scope)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[FaultInjector] = None


def install(plan_or_injector) -> FaultInjector:
    """Install the process-global injector (solver and kernel hooks).
    Takes a plan or a built injector; returns the injector. Pair every
    call with :func:`clear`."""
    global _GLOBAL
    inj = (plan_or_injector if isinstance(plan_or_injector, FaultInjector)
           else FaultInjector(plan_or_injector))
    _GLOBAL = inj
    return inj


def get() -> Optional[FaultInjector]:
    return _GLOBAL


def clear() -> None:
    global _GLOBAL
    _GLOBAL = None
