"""Lightweight nested spans with a ring buffer of finished traces.

A span measures one stage of work (``with tracer.span("solve",
route="histogram", bucket=64):``). Spans nest: closing a child attaches
it to its parent, closing a root appends the whole tree — as a plain
dict — to the tracer's ring buffer of the last N traces. Exceptions
propagate (the span records ``status="error"`` and the error repr).

CUDA work is asynchronous, so a span that only brackets a launch times
the enqueue, not the math. :meth:`Span.fence` synchronises the card when
the launch result holds CUDA tensors (the card that holds them, not
the thread's current one) and records the span-start ->
ready interval as ``device_s``, while returning the value:
``outs = sp.fence(prog.launch(*inputs))``. On the CPU it waits for
nothing.

``Tracer(enabled=False)`` keeps timing semantics but skips ring-buffer
and metrics recording. With a :class:`~repro_torch.obs.metrics.
MetricsRegistry` attached, every finished span also lands in a
``span_seconds{span=<name>}`` histogram.
"""
from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager
from typing import Any, Deque, Dict, List, Optional

import torch

from . import metrics as M

__all__ = ["Span", "Tracer"]


def _cuda_devices(value, found=None) -> set:
    """The CUDA devices that hold the tensors in ``value``."""
    found = set() if found is None else found
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            found.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    return found


class Span:
    """One timed stage. ``wall_s`` is set when the span closes;
    ``device_s`` only when :meth:`fence` ran inside it."""

    __slots__ = ("name", "attrs", "t_start", "wall_s", "device_s",
                 "status", "error", "children", "_t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.t_start = time.time()
        self._t0 = time.perf_counter()
        self.wall_s: Optional[float] = None
        self.device_s: Optional[float] = None
        self.status = "ok"
        self.error: Optional[str] = None
        self.children: List["Span"] = []

    def fence(self, value):
        """Wait until ``value``'s device work is done (a
        ``torch.cuda.synchronize`` of each card that holds its tensors,
        whatever the calling thread's current device; nothing on the
        CPU); record the span-start -> ready interval as this span's
        device time."""
        for device in _cuda_devices(value):
            torch.cuda.synchronize(device)
        self.device_s = time.perf_counter() - self._t0
        return value

    def close(self, error: Optional[BaseException] = None) -> None:
        self.wall_s = time.perf_counter() - self._t0
        if error is not None:
            self.status = "error"
            self.error = repr(error)

    def to_dict(self) -> dict:
        d = {"name": self.name, "t_start": self.t_start,
             "wall_s": self.wall_s, "status": self.status}
        if self.attrs:
            d["attrs"] = M.json_safe(self.attrs)
        if self.device_s is not None:
            d["device_s"] = self.device_s
        if self.error is not None:
            d["error"] = self.error
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class Tracer:
    """Span factory + ring buffer of the last ``max_traces`` root
    traces. The span stack is thread-local; the ring is shared."""

    def __init__(self, max_traces: int = 64, enabled: bool = True,
                 metrics: Optional[M.MetricsRegistry] = None,
                 span_metric: str = "span_seconds"):
        self.enabled = enabled
        self.metrics = metrics
        self.span_metric = span_metric
        self._ring: Deque[dict] = collections.deque(maxlen=max_traces)
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @property
    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    @contextmanager
    def span(self, name: str, ring: bool = True, **attrs):
        """Open a timed span. ``ring=False`` keeps a root span out of
        the trace ring while still timing and feeding metrics.
        Exceptions mark the span ``status="error"`` and propagate."""
        sp = Span(name, attrs)
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.close(e)
            raise
        finally:
            if sp.wall_s is None:       # non-error exit
                sp.close()
            stack.pop()
            if stack:
                stack[-1].children.append(sp)
            elif ring and self.enabled:
                self._ring.append(sp.to_dict())
            if self.enabled and self.metrics is not None:
                self.metrics.histogram(self.span_metric,
                                       span=name).record(sp.wall_s)

    def traces(self) -> List[dict]:
        """The finished root traces, oldest first (plain dicts)."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
