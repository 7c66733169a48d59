"""The trace's reduction on a hand-made timeline: busy time is the union
of device intervals, idle gaps are named by the host's activity."""
import pytest
import torch

from harness import trace as TR

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, end, thread=1):
        self._n, self._d, self._s, self._e, self._t = (name, dev, start, end,
                                                       thread)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def start_thread_id(self):
        return self._t


def timeline():
    # window 0-100 ns; a request 10-90 with spans; kernels overlap
    return [Ev(TR.WINDOW, CPU, 0, 100), Ev(TR.REQUEST, CPU, 10, 90),
            Ev("span.ingest", CPU, 12, 30),
            Ev("span.launch", CPU, 30, 60), Ev("aten::max", CPU, 40, 45),
            Ev("span.scatter", CPU, 60, 88),
            Ev("aten::copy_", CPU, 50, 55, thread=2),   # another thread
            Ev("kernel_a", CUDA, 32, 42), Ev("kernel_b", CUDA, 38, 50),
            Ev("Memcpy DtoH", CUDA, 62, 70),
            Ev("span.launch", CUDA, 30, 60),            # mirrored annotation
            Ev("kernel_a", CUDA, 95, 120)]              # runs past the window


def test_busy_is_the_union_of_device_intervals_clipped_to_the_window():
    tr = TR.Trace(timeline())
    assert tr.window_s == pytest.approx(100e-9)
    # [32, 50] + [62, 70] + [95, 100]
    assert tr.busy_s == pytest.approx(31e-9)
    by = tr.seconds_by_name()
    assert by["kernel_a"] == pytest.approx(15e-9)
    assert "span.launch" not in by
    assert tr.kernel_seconds(["kernel_"]) == pytest.approx(27e-9)


def test_gaps_are_named_by_span_and_operation():
    tr = TR.Trace(timeline())
    assert tr.gaps() == [(0, 32), (50, 62), (70, 95)]
    idle = tr.idle_by_host()
    # gap midpoints 16 (ingest), 56 (launch: the copy is another
    # thread's), 82 (scatter)
    assert idle == pytest.approx({"span.ingest": 32e-9,
                                  "span.launch": 12e-9,
                                  "span.scatter": 25e-9})


def test_time_outside_spans_is_the_engine_in_a_request_else_the_harness():
    evs = [Ev(TR.WINDOW, CPU, 0, 100), Ev(TR.REQUEST, CPU, 0, 50),
           Ev("aten::empty", CPU, 10, 40), Ev("kernel", CUDA, 45, 55)]
    idle = TR.Trace(evs).idle_by_host()
    assert idle == pytest.approx({"engine (no span) > aten::empty": 45e-9,
                                  "harness (between requests)": 45e-9})


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        TR.Trace([Ev("kernel", CUDA, 0, 5)])
