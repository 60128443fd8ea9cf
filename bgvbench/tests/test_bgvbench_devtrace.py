"""The trace's reduction on hand-made device events."""
import pytest
from torch.autograd import DeviceType

from bgvbench import devtrace


class Event:
    def __init__(self, name, start, end, dev=DeviceType.CUDA):
        self._n, self._s, self._d, self._dev = name, start, end - start, dev

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def name(self):
        return self._n


def test_busy_kernels_and_idle_gaps():
    events = [Event("k1", 0, 100), Event("k2", 50, 150), Event("k1", 400, 500),
              Event("host op", 150, 400, DeviceType.CPU), Event("k3", 700, 800)]
    tr = devtrace.reduce(events, 1e-6)
    assert tr.busy_s == pytest.approx(350e-9)
    assert tr.kernels == {"k1": [2, pytest.approx(200e-9)], "k2": [1, pytest.approx(100e-9)],
                          "k3": [1, pytest.approx(100e-9)]}
    assert tr.kernel("k1") == (2, pytest.approx(200e-9))
    assert tr.top_idle() == [["before k1", pytest.approx(250e-9)],
                             ["before k3", pytest.approx(200e-9)]]
    assert tr.top_kernels(1) == [["k1", pytest.approx(200e-9)]]


def test_no_device_activity_reads_nothing():
    tr = devtrace.reduce([Event("host", 0, 10, DeviceType.CPU)], 1.0)
    assert tr.busy_s == 0 and tr.kernels == {} and tr.top_idle() == []
