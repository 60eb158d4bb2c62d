"""The request plane's overhead contract on the port.

Port-written counterparts of the JAX package's
``tests/test_request_overhead.py``: the 16-thread storm (scores
bitwise, ledgers balanced, tracing off and on), the always-on overhead
clock (one sample a request, the stored total the segment sum,
bitwise), the O(1)-per-batch bookkeeping (a stats-lock spy, the hoisted
clock binding), the opaudit hot-path pass on seeded trees, the pin of
the port's 15 marked hot functions, and the request profile
(``--profile-requests``) over a trace the port's ``telemetry/spans.py``
exported.

Left out: the ``legacy`` request plane and the ``dict`` queue
parametrisations and the legacy-versus-fast comparisons, because the
port has one request plane and one queue (``TM_ENGINE_REQUEST_PLANE``
and ``TM_ENGINE_QUEUE_IMPL`` raise; ROADMAP kept divergences); the two
``bench.py request_overhead`` section cases, because the port has no
bench section yet.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from transmogrifai_tpu_torch.analysis import core, hotpath, reqprofile
from transmogrifai_tpu_torch.telemetry import spans as tspans

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TENANTS = ("gold", "silver", "bronze")
_WEIGHTS = {"gold": 4, "silver": 2, "bronze": 1}
_N_THREADS = 16
_PER_THREAD = 12

_PAYLOAD_RNG = np.random.default_rng(1234)
_PAYLOADS = [[np.asarray(_PAYLOAD_RNG.normal(size=1 + (tid + i) % 3),
                         np.float32)
              for i in range(_PER_THREAD)]
             for tid in range(_N_THREADS)]


def _affine_model():
    """A one-column portable LR model on the CPU (z = 2x + 1 through a
    sigmoid pair): row-wise arithmetic, so a request's slice of a
    coalesced batch is bitwise its solo score."""
    from transmogrifai_tpu_torch import portable
    manifest = {"format": 1, "boundary": ["x", "label"],
                "responseBoundary": ["label"], "resultNames": ["score"],
                "hostPrefix": [], "scoreBuckets": [],
                "stages": [
                    {"out": "xv", "inputs": ["x"], "op": "impute",
                     "fill": 0.0, "track": False},
                    {"out": "combined", "inputs": ["xv"], "op": "concat"},
                    {"out": "score", "inputs": ["label", "combined"],
                     "op": "predict", "family": "LogisticRegression",
                     "nClasses": 2}]}
    arrays = {"2": {"params": {"beta": np.array([2.0, 1.0])}}}
    return portable.from_portable(manifest, arrays, "cpu")


_MODEL = _affine_model()


def _solo(x):
    """The model's score of one request alone."""
    return _MODEL.compile_scoring(device="cpu").score_arrays(
        {"x": x})["score"]


def _engine(**cfg_kw):
    from transmogrifai_tpu_torch.serving import (EngineConfig,
                                                 ModelRegistry,
                                                 ServingEngine)
    reg = ModelRegistry()
    reg.register("m", _MODEL, warm_sample={"x": np.zeros(1, np.float32)},
                 device="cpu")
    cfg = EngineConfig(max_wait_ms=1.0, max_batch_rows=64,
                       tenant_weights=dict(_WEIGHTS), **cfg_kw)
    return ServingEngine(registry=reg, config=cfg)


def _tenant_of(tid, i):
    return _TENANTS[(tid * _PER_THREAD + i) % len(_TENANTS)]


def _storm(sample, export=None):
    """16 threads x 12 requests through a fresh engine; (results, stats
    dict, tenants snapshot, queue gauges, overhead samples), read after
    the engine drained and stopped. ``export(tracer)`` runs before the
    tracer is reset."""
    tspans.configure(sample=sample)
    try:
        results = {}
        outs = [[] for _ in range(_N_THREADS)]
        barrier = threading.Barrier(_N_THREADS)
        with _engine() as eng:
            def work(tid):
                barrier.wait()
                for i in range(_PER_THREAD):
                    outs[tid].append((tid, i, eng.submit(
                        {"x": _PAYLOADS[tid][i]},
                        tenant=_tenant_of(tid, i))))
            threads = [threading.Thread(target=work, args=(tid,))
                       for tid in range(_N_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
                assert not t.is_alive()
            for lst in outs:
                for tid, i, fut in lst:
                    results[(tid, i)] = fut.result(timeout=60)["score"]
        samples = eng.stats.recent_host_overhead(1 << 30)
        if export is not None:
            export(tspans.TRACER)
        return (results, eng.stats.as_dict(), eng.stats.tenants_snapshot(),
                eng.stats.load_gauges(), samples)
    finally:
        tspans.configure(sample=0.0)


@pytest.mark.parametrize("sample", [0.0, 1.0])
def test_sixteen_thread_storm_bitwise_and_balanced_ledgers(sample):
    n = _N_THREADS * _PER_THREAD
    want = {t: 0 for t in _TENANTS}
    for tid in range(_N_THREADS):
        for i in range(_PER_THREAD):
            want[_tenant_of(tid, i)] += 1
    results, st, tens, gauges, samples = _storm(sample)
    assert len(results) == n
    for (tid, i), got in results.items():
        ref = _solo(_PAYLOADS[tid][i])
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert st["completed"] == n and st["failed"] == 0
    for key in ("shed_expired", "rejected_queue_full",
                "rejected_predicted_late", "rejected_tenant_budget"):
        assert st[key] == 0, key
    for t, count in want.items():
        assert tens[t]["requests"] == count
    assert gauges["queue_depth_requests"] == 0
    assert gauges["queue_depth_rows"] == 0
    assert len(samples) == n


def test_overhead_clock_monotone_segments_sum_to_total():
    _, st, _, _, samples = _storm(0.0)
    assert len(samples) == _N_THREADS * _PER_THREAD
    for adm, queue, build, resolve, total in samples:
        assert min(adm, queue, build, resolve) >= 0.0
        assert total == adm + queue + build + resolve
    oh = st["requestOverhead"]
    assert oh["requests"] == _N_THREADS * _PER_THREAD
    assert set(oh["segments"]) == {"admission", "queue", "build",
                                   "resolve"}


class _CountingLock:
    def __init__(self, real):
        self._real = real
        self.count = 0

    def acquire(self, *a, **kw):
        self.count += 1
        return self._real.acquire(*a, **kw)

    def release(self):
        self._real.release()

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self._real.release()
        return False


def test_stats_lock_is_one_round_trip_a_request_plus_o1_a_batch():
    """The batched bookkeeping: a submit takes the stats lock once, and
    every drained batch a bounded number of times, however many
    requests it holds — a per-request stats lock sneaking back into
    the dispatcher fails this."""
    n = 160
    with _engine() as eng:
        eng.score({"x": np.zeros(1, np.float32)}, timeout=30)
        batches0 = eng.stats.as_dict()["batches"]
        spy = _CountingLock(eng.stats._lock)
        eng.stats._lock = spy
        futs = [eng.submit({"x": _PAYLOADS[i % _N_THREADS][0]})
                for i in range(n)]
        for f in futs:
            f.result(timeout=60)
        batches = eng.stats.as_dict()["batches"] - batches0
    assert 0 < batches <= n
    assert n <= spy.count <= n + 8 * batches + 8, (spy.count, batches)


def test_hot_path_reads_hoisted_clock_binding(monkeypatch):
    """The submit path stamps through the module-level ``_monotonic``
    binding: patching ``time.monotonic`` after import sees at most the
    few calls the shared request constructor makes."""
    import transmogrifai_tpu_torch.serving.admission as admission_mod
    import transmogrifai_tpu_torch.serving.engine as engine_mod
    assert engine_mod._monotonic is time.monotonic
    assert admission_mod._monotonic is time.monotonic
    assert engine_mod._asarray is np.asarray
    real = time.monotonic
    calls = {"n": 0}

    def counting():
        calls["n"] += 1
        return real()

    n = 120
    with _engine() as eng:
        eng.score({"x": np.zeros(1, np.float32)}, timeout=30)
        monkeypatch.setattr(time, "monotonic", counting)
        try:
            futs = [eng.submit({"x": _PAYLOADS[i % _N_THREADS][0]})
                    for i in range(n)]
            for f in futs:
                f.result(timeout=60)
        finally:
            monkeypatch.setattr(time, "monotonic", real)
    assert calls["n"] <= n + 64, calls


# ---------------------------------------------------------------------------
# the opaudit hot-path pass
# ---------------------------------------------------------------------------

def _ctx(tmp_path, files):
    return core.AuditContext(str(tmp_path), [core.SourceFile(rel, text)
                                             for rel, text in files.items()])


_HOT_BAD = '''\
import os
import threading

_LOCK = threading.Lock()


# opaudit: hotpath
def drain(items):
    mode = os.environ.get("TM_MODE", "x")
    out = []
    for it in items:
        with _LOCK:
            out.append({"item": it, "mode": mode})
    return out
'''

_HOT_GOOD = '''\
import threading

_LOCK = threading.Lock()
_MODE = "x"


# opaudit: hotpath
def drain(items):
    out = [(it, _MODE) for it in items]
    with _LOCK:
        return list(out)


# opaudit: hotpath
def scatter(groups):
    results = []
    for g in groups:
        results.append({k: v for k, v in g})
    return results
'''


def test_hotpath_pass_catches_each_seeded_regression(tmp_path):
    ctx = _ctx(tmp_path, {"transmogrifai_tpu_torch/fake_hot.py": _HOT_BAD})
    assert sorted(d.code for d in hotpath.run(ctx)) == [
        "TM-AUDIT-311", "TM-AUDIT-312", "TM-AUDIT-313"]


def test_hotpath_pass_silent_on_repaired_shapes(tmp_path):
    ctx = _ctx(tmp_path, {"transmogrifai_tpu_torch/fake_hot.py": _HOT_GOOD})
    assert hotpath.run(ctx) == []


def test_hotpath_pass_is_opt_in(tmp_path):
    unmarked = _HOT_BAD.replace("# opaudit: hotpath\n", "")
    ctx = _ctx(tmp_path, {"transmogrifai_tpu_torch/fake_hot.py": unmarked})
    assert hotpath.run(ctx) == []


#: the port's marked request-plane functions (``submit`` is the
#: counterpart of the JAX package's ``_submit_fast``: the port has only
#: the fast plane)
HOT = {
    ("transmogrifai_tpu_torch/profiling.py", "note_submit_depth"),
    ("transmogrifai_tpu_torch/profiling.py", "note_dispatch_waits"),
    ("transmogrifai_tpu_torch/profiling.py", "note_group_complete"),
    ("transmogrifai_tpu_torch/serving/admission.py", "admit"),
    ("transmogrifai_tpu_torch/serving/admission.py", "split_expired"),
    ("transmogrifai_tpu_torch/serving/engine.py", "enqueue"),
    ("transmogrifai_tpu_torch/serving/engine.py", "drr_pop"),
    ("transmogrifai_tpu_torch/serving/engine.py", "submit"),
    ("transmogrifai_tpu_torch/serving/engine.py", "_run_pass"),
    ("transmogrifai_tpu_torch/serving/engine.py", "_finalize_group"),
    ("transmogrifai_tpu_torch/serving/engine.py", "_plan_fused"),
    ("transmogrifai_tpu_torch/serving/engine.py", "_launch_fused"),
    ("transmogrifai_tpu_torch/serving/engine.py", "_finalize_fused"),
    ("transmogrifai_tpu_torch/serving/router.py", "_dispatch"),
    ("transmogrifai_tpu_torch/serving/router.py", "_on_engine_done"),
}


def test_real_engine_hot_path_carries_markers():
    """The port's request plane is marked, so the pass is not vacuous,
    and the marked functions audit clean."""
    ctx = core.load_context(_REPO, roots=(core.PACKAGE,))
    marked = set(hotpath.marked_function_names(ctx))
    assert HOT <= marked, HOT - marked
    assert len(HOT) == 15
    assert hotpath.run(ctx) == []


# ---------------------------------------------------------------------------
# the request profile over the port's own trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["jsonl", "chrome"])
def test_profile_requests_ranks_a_port_trace(tmp_path, form):
    """A traced storm, exported by the port's tracer in either form,
    ranks its span segments by total µs, deterministically, through
    ``python -m transmogrifai_tpu_torch.analysis --profile-requests``."""
    from transmogrifai_tpu_torch.analysis import __main__ as cli
    path = str(tmp_path / f"trace.{form}")
    _storm(1.0, export=lambda tr: (tr.export_jsonl(path) if form == "jsonl"
                                   else tr.export_chrome(path)))
    rows = json.loads(reqprofile.run(path, as_json=True))
    rows = rows["segments"] if isinstance(rows, dict) else rows
    names = [r["name"] for r in rows]
    assert "engine.queue" in names or "engine.execute" in names, names
    totals = [r["total_us"] for r in rows]
    assert totals == sorted(totals, reverse=True)
    assert reqprofile.run(path, as_json=True) == reqprofile.run(
        path, as_json=True)
    assert cli.main(["--profile-requests", path, "--json"]) == 0
