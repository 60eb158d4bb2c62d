"""The window, busy and idle arithmetic on made-up timelines."""
import numpy as np
import pytest

from portbench.trace import Trace, union, WINDOW_SPAN
from portbench.metrics import device_idle, per_fit


def test_union_merges_overlaps_and_clips_to_the_window():
    iv = np.array([[0.5, 2.0], [1.0, 3.0], [4.0, 5.0], [9.0, 12.0],
                   [-1.0, 0.2]])
    got = union(iv, (0.0, 10.0))
    assert got.tolist() == [[0.0, 0.2], [0.5, 3.0], [4.0, 5.0], [9.0, 10.0]]


def _trace():
    dev = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("copy", 5.0, 6.0),
           ("k1", 8.0, 8.5)]
    host = [("portbench.fit", 0.5, 9.5), ("aten::item", 3.0, 4.5),
            ("cudaStreamSynchronize", 3.2, 4.4), ("aten::copy_", 6.0, 8.0)]
    return Trace(dev, host, (0.0, 10.0))


def test_busy_idle_and_the_device_time_by_name():
    tr = _trace()
    assert tr.window_s == 10.0
    assert tr.busy_s() == pytest.approx(2.0 + 1.0 + 0.5)
    assert device_idle.read({"trace": tr}) == pytest.approx(65.0)
    assert tr.device_time(lambda n: n == "k1") == pytest.approx(1.5)
    assert tr.top_device_ops(2) == [["k2", 1.5], ["k1", 1.5]] or \
        tr.top_device_ops(2) == [["k1", 1.5], ["k2", 1.5]]
    assert per_fit({"fits": [1, 2]}, 3.0) == 1.5


def test_idle_gaps_are_named_by_the_innermost_open_host_event():
    gaps = dict(map(tuple, _trace().idle_gaps()))
    # [0, 1): only the window; [3, 5): inside the sync (innermost open at
    # 3.0+ is aten::item, which opened at 3.0); [6, 8): copy_; [8.5, 10):
    # the fit span until 9.5 opened before 8.5
    assert gaps[WINDOW_SPAN] == pytest.approx(1.0)
    assert gaps["aten::item"] == pytest.approx(2.0)
    assert gaps["aten::copy_"] == pytest.approx(2.0)
    assert gaps["portbench.fit"] == pytest.approx(1.5)
    assert sum(gaps.values()) == pytest.approx(10.0 - 3.5)
