"""The readers of the program's own spans, on made-up timelines."""
import pytest

from portbench import spans as S
from portbench.metrics import (ctr_step_host_ms, ctr_stream_host_s,
                               linear_host_idle_s, split_s,
                               sweep_dispatch_s, tree_host_idle_s)
from portbench.trace import Trace

READERS = (split_s, sweep_dispatch_s, tree_host_idle_s, linear_host_idle_s,
           ctr_step_host_ms, ctr_stream_host_s)


def _fit_trace():
    """Two fits' worth of one selector fit: busy [1, 2), [4, 6) and
    [10, 19.5) in a window (0, 20)."""
    dev = [("k", 1.0, 2.0), ("k", 4.0, 5.0), ("Memcpy HtoD", 5.0, 6.0),
           ("k", 10.0, 19.5)]
    host = [("portbench.fit", 0.0, 20.0),
            ("selector.fit", 0.5, 19.5),
            ("selector.split", 0.5, 1.5),
            ("aten::copy_", 0.6, 1.4),
            ("selector.dispatch", 1.5, 4.0),
            ("trees.level", 1.8, 3.0),
            ("aten::copy_", 1.9, 2.8),           # idle [2, 2.8) inside it
            ("cudaMemcpyAsync", 2.0, 2.7),
            ("trees.bin", 3.0, 3.5),
            ("selector.dispatch", 6.0, 8.0),
            ("linear.solve", 6.0, 7.5),
            ("linear.iter", 6.0, 7.0),
            ("aten::mm", 6.1, 6.2),
            ("selector.collect", 8.0, 9.0),
            ("aten::item", 9.0, 10.0)]           # under selector.fit only
    return Trace(dev, host, (0.0, 20.0))


def _run(tr, fits=2):
    return {"trace": tr, "fits": [{}] * fits}


def test_idle_is_split_by_the_innermost_open_program_span():
    by = S.idle_by_span(_fit_trace())
    want = {None: 0.5 + 0.5, "selector.split": 0.5, "trees.level": 1.0,
            "trees.bin": 0.5, "selector.dispatch": 0.5 + 0.5,
            "linear.iter": 1.0, "linear.solve": 0.5,
            "selector.collect": 1.0, "selector.fit": 1.0}
    assert set(by) == set(want)
    for k, v in want.items():
        assert by[k] == pytest.approx(v), k
    # every idle second is put down to exactly one name
    tr = _fit_trace()
    assert sum(by.values()) == pytest.approx(tr.window_s - tr.busy_s())


def test_the_six_readers_on_a_made_up_fit():
    run = _run(_fit_trace())
    assert split_s.read(run) == pytest.approx(1.0 / 2)
    assert sweep_dispatch_s.read(run) == pytest.approx((2.5 + 2.0) / 2)
    # idle inside aten::copy_ nested in trees.level counts for the trees
    assert tree_host_idle_s.read(run) == pytest.approx((1.0 + 0.5) / 2)
    assert linear_host_idle_s.read(run) == pytest.approx((1.0 + 0.5) / 2)
    dev = [("k", 0.0, 1.0)]
    host = [("portbench.fit", 0.0, 1.0), ("sparse.step", 0.1, 0.101),
            ("sparse.step", 0.2, 0.203), ("stream.stage", 0.3, 0.4),
            ("stream.wait", 0.5, 0.8), ("stream.produce", 0.8, 0.9)]
    ctr = _run(Trace(dev, host, (0.0, 1.0)))
    assert ctr_step_host_ms.read(ctr) == pytest.approx(2.0)
    assert ctr_stream_host_s.read(ctr) == pytest.approx((0.1 + 0.3) / 2)


def test_idle_under_selector_fit_alone_counts_toward_no_idle_metric():
    dev = [("k", 0.0, 1.0), ("k", 3.0, 4.0)]
    host = [("portbench.fit", 0.0, 4.0), ("selector.fit", 0.0, 4.0),
            ("trees.level", 0.0, 1.0), ("linear.iter", 3.0, 4.0),
            ("aten::copy_", 1.0, 3.0)]
    run = _run(Trace(dev, host, (0.0, 4.0)), fits=1)
    assert tree_host_idle_s.read(run) == 0.0
    assert linear_host_idle_s.read(run) == 0.0
    assert S.idle_by_span(run["trace"]) == {"selector.fit": 2.0}


def test_a_trace_without_program_spans_reads_nothing():
    # the parent commit's program records no span: every reader is silent
    dev = [("k", 1.0, 2.0)]
    host = [("portbench.fit", 0.0, 3.0), ("aten::copy_", 2.0, 2.5)]
    run = _run(Trace(dev, host, (0.0, 3.0)))
    for mod in READERS:
        assert mod.read(run) is None, mod.__name__


def test_the_frozen_names_are_the_programs():
    from transmogrifai_tpu_torch.telemetry.spans import REGIONS
    assert S.PROGRAM_SPANS <= set(REGIONS)
    for mod, names in ((split_s, {split_s.SPAN}),
                       (sweep_dispatch_s, {sweep_dispatch_s.SPAN}),
                       (ctr_step_host_ms, {ctr_step_host_ms.SPAN}),
                       (ctr_stream_host_s, set(ctr_stream_host_s.SPANS))):
        assert names <= S.PROGRAM_SPANS, mod.__name__
    for prefix in (tree_host_idle_s.PREFIX, linear_host_idle_s.PREFIX):
        assert any(n.startswith(prefix) for n in S.PROGRAM_SPANS)


def _region_trace(region=True):
    """A region outside PROGRAM_SPANS (``ft.epoch``) inside
    ``selector.dispatch``: idle [2, 3) under the region, [1, 2) and
    [3, 4) around it."""
    dev = [("k", 0.0, 1.0), ("k", 4.0, 5.0)]
    host = [("portbench.fit", 0.0, 5.0), ("selector.fit", 0.0, 5.0),
            ("selector.dispatch", 1.0, 4.0), ("aten::mm", 2.2, 2.4)]
    if region:
        host.append(("ft.epoch", 2.0, 3.0))
    return Trace(dev, host, (0.0, 5.0))


def test_a_region_outside_the_frozen_names_is_passed_over_by_default():
    tr = _region_trace()
    assert "ft.epoch" not in S.PROGRAM_SPANS
    assert S.idle_by_span(tr) == S.idle_by_span(_region_trace(False)) \
        == {"selector.dispatch": 3.0}
    assert S.idle_under(tr, lambda n: n.startswith("ft.")) is None


def test_a_reader_names_its_own_region_for_the_idle_split():
    tr = _region_trace()
    mine = S.PROGRAM_SPANS | {"ft.epoch"}
    by = S.idle_by_span(tr, names=mine)
    assert by == {"selector.dispatch": 2.0, "ft.epoch": 1.0}
    assert S.idle_under(tr, lambda n: n.startswith("ft."),
                        names=mine) == pytest.approx(1.0)
    # every other reader's split stays as it was
    assert S.idle_under(tr, lambda n: n.startswith("selector.")) == 3.0
