"""Typed errors of the serving engine.

Futures, deadlines and the background flusher belong to the async
serving slice and are not ported yet; the synchronous engine raises
these errors from ``submit`` and ``flush``.
"""
from __future__ import annotations

__all__ = ["DeadlineExceeded", "EngineShutdown", "InvalidInput",
           "Overloaded", "SolveFailed"]


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before its result materialized."""


class EngineShutdown(RuntimeError):
    """The engine was shut down with this request still pending (or a
    submit arrived after shutdown)."""


class InvalidInput(ValueError):
    """The payload was rejected at submit time (NaN/Inf floats, empty
    image) — before consuming a request id or poisoning a shared batch."""


class Overloaded(RuntimeError):
    """Shed under queue-depth overload."""


class SolveFailed(RuntimeError):
    """The solve produced non-finite centers for this request."""
