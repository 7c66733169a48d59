"""The profiler's trace of the window, reduced: device busy time as the
union of every kernel, copy and set interval, device time by operation
name, and the idle gaps between them named by what the host was doing.

The window is the ``bench.window`` annotation the harness opens around
its loop; each engine span runs inside a ``span.<name>`` annotation.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

WINDOW = "bench.window"
SPAN = "span."
REQUEST = "bench.request"
_OURS = (WINDOW, SPAN, REQUEST)


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


class Trace:
    """Device intervals and host events of one profiled window."""

    def __init__(self, events: Iterable):
        cuda = torch.autograd.DeviceType.CUDA
        self.device: List[Tuple[int, int, str]] = []
        host = []
        self.t0 = self.t1 = None
        thread = None
        for e in events:
            name = e.name()
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if e.device_type() == cuda:
                if not name.startswith(_OURS):     # our annotations mirrored
                    self.device.append((start, end, name))
                continue
            if name == WINDOW:
                self.t0, self.t1 = start, end
                thread = e.start_thread_id()
            host.append((start, end, name, e.start_thread_id()))
        if self.t0 is None:
            raise RuntimeError("the trace holds no bench.window annotation")
        self.host = sorted(((s, e, n) for s, e, n, t in host
                            if t == thread and s >= self.t0
                            and e <= self.t1 and n != WINDOW),
                           key=lambda h: (h[0], -h[1]))
        self.device = [(max(s, self.t0), min(e, self.t1), n)
                       for s, e, n in self.device if e > self.t0
                       and s < self.t1]
        self.busy = self._union()

    def _union(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for s, e, _ in sorted(self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, n in self.device:
            out[n] = out.get(n, 0.0) + (e - s) * 1e-9
        return out

    def kernel_seconds(self, names: Sequence[str]) -> float:
        """Device seconds of the operations whose name contains one of
        ``names`` (a kernel's symbol inside its templated signature)."""
        return sum((e - s) * 1e-9 for s, e, n in self.device
                   if any(k in n for k in names))

    def gaps(self) -> List[Tuple[int, int]]:
        out, t = [], self.t0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def idle_by_host(self) -> Dict[str, float]:
        """Idle device seconds by the host's activity at each gap's
        midpoint: the innermost engine span and the innermost operation
        inside it (``span.scatter > aten::copy_``)."""
        gaps = self.gaps()
        mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
        out: Dict[str, float] = {}
        stack: List[Tuple[int, int, str]] = []
        j = 0
        for mid, length in mids:
            while j < len(self.host) and self.host[j][0] <= mid:
                while stack and stack[-1][1] < self.host[j][0]:
                    stack.pop()
                stack.append(self.host[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = _activity(stack)
            out[name] = out.get(name, 0.0) + length * 1e-9
        return out


def _activity(stack: List[Tuple[int, int, str]]) -> str:
    """``span.<name> > <op>``: the innermost engine span and the innermost
    operation inside it; a request's time outside every engine span is
    ``engine (no span)``, time outside every request the harness's."""
    span: Optional[str] = None
    op: Optional[str] = None
    in_request = False
    for _, _, n in reversed(stack):
        if n == REQUEST:
            in_request = True
        elif n.startswith(SPAN) and span is None:
            span = n
        elif not n.startswith(_OURS) and op is None and span is None:
            op = n
    if span is None:
        span = "engine (no span)" if in_request else "harness (between requests)"
    return " > ".join(p for p in (span, op) if p)


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k[:160], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def events_of(prof) -> list:
    """The raw events of a finished ``torch.profiler.profile``."""
    return list(prof.profiler.kineto_results.events())
