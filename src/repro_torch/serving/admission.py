"""Async admission for the serving engine: futures and the typed errors.

``FCMServeEngine.submit_async`` parks a request on the engine's
per-route queues and hands back a :class:`SegmentationFuture`; a
background flusher thread forms batches by the engine's policy (flush
when a bucket group reaches its target shape, or when the oldest queued
request has waited ``max_wait_ms``) and resolves futures as results
materialize, so concurrent callers share one bucket's launches.

This module is engine-agnostic plumbing: the future and the typed
admission and fault errors. The queueing policy lives on the engine.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

__all__ = ["SegmentationFuture", "DeadlineExceeded", "EngineShutdown",
           "InvalidInput", "Overloaded", "SolveFailed"]


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before its result materialized."""


class EngineShutdown(RuntimeError):
    """The engine was shut down with this request still pending (or a
    submit arrived after shutdown)."""


class InvalidInput(ValueError):
    """The payload was rejected at submit time (NaN/Inf floats, empty
    image) — before consuming a request id or poisoning a shared batch."""


class Overloaded(RuntimeError):
    """Shed under queue-depth overload: the engine failed this request
    (lowest urgency) fast rather than blowing deadlines for everyone."""


class SolveFailed(RuntimeError):
    """The solve produced non-finite centers for this request even after
    the reference-backend salvage pass."""


class SegmentationFuture:
    """One async segmentation request's pending result.

    Resolved exactly once — by the flusher thread, a synchronous
    ``flush`` / ``drain``, or engine shutdown — with either a
    :class:`~repro_torch.serving.fcm_engine.SegmentationResult` or an
    exception. ``result(timeout)`` blocks; ``done()`` polls. The
    timestamps ``submit_t`` / ``resolve_t`` (``time.perf_counter``
    seconds) let a load generator read submit-to-result latency.
    """

    __slots__ = ("request_id", "method", "deadline", "submit_t",
                 "resolve_t", "_lock", "_event", "_result", "_error")

    def __init__(self, request_id: int, method: str,
                 deadline: Optional[float] = None):
        self.request_id = request_id
        self.method = method
        #: absolute deadline on the perf_counter clock, or None
        self.deadline = deadline
        self.submit_t = time.perf_counter()
        self.resolve_t: Optional[float] = None
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    # -- resolution (engine side) ------------------------------------------

    def try_set_result(self, result: Any) -> bool:
        """Atomically resolve with a result; False if already resolved.
        The check and the set are one critical section, so two racing
        resolvers (flusher, shutdown, a synchronous flush) never both
        win."""
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            self.resolve_t = time.perf_counter()
            self._event.set()
            return True

    def try_set_exception(self, err: BaseException) -> bool:
        """Atomically resolve with an exception; False if already
        resolved."""
        with self._lock:
            if self._event.is_set():
                return False
            self._error = err
            self.resolve_t = time.perf_counter()
            self._event.set()
            return True

    def set_result(self, result: Any) -> None:
        if not self.try_set_result(result):
            raise RuntimeError(
                f"future for request {self.request_id} resolved twice")

    def set_exception(self, err: BaseException) -> None:
        if not self.try_set_exception(err):
            raise RuntimeError(
                f"future for request {self.request_id} resolved twice")

    # -- readout (caller side) ---------------------------------------------

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self) -> Optional[BaseException]:
        """The resolving exception, or None; does not block."""
        return self._error

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until resolved (or ``timeout`` seconds), then return the
        result or raise the resolving exception. Raises ``TimeoutError``
        if still unresolved at the timeout."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} unresolved after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-resolve wall seconds, or None while pending."""
        if self.resolve_t is None:
            return None
        return self.resolve_t - self.submit_t

    def __repr__(self) -> str:
        state = ("error" if self._error is not None
                 else "done" if self._event.is_set() else "pending")
        return (f"SegmentationFuture(id={self.request_id}, "
                f"method={self.method!r}, {state})")
