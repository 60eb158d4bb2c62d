"""The port's multi-process layer (``parallel.multihost``) mirroring the
JAX package's ``tests/test_multihost.py`` case for case, on CPU ranks.

The JAX suite is all ``slow`` (tree-heavy on its 8 forced devices); the
port's cases are small and run in tier 1. The JAX package's two-process
case runs a cross-process ``psum`` over ``jax.distributed``; the port's
runs two OS processes joined by a localhost ``gloo`` group
(``tests/torch_multihost_worker.py``), each with two CPU ranks, through
a hybrid mesh and ``WorkflowRunner`` with ``OpParams.distributed``.

Tolerances: the JAX test's own for the hybrid ``grid_map`` (rtol 2e-4,
atol 2e-5); linear CV metrics rtol 1e-4, atol 1e-6 and boosted trees
atol 1e-2 against one process (row sums move with the sharding); the
two processes' results bitwise each other's (both receive every grid
row's results over the process group).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.parallel import multihost as JMH
from transmogrifai_tpu_torch import models as TM
from transmogrifai_tpu_torch import parallel as TP
from transmogrifai_tpu_torch.models import sparse as TS
from transmogrifai_tpu_torch.models.tuning import (build_fold_grid_batch,
                                                   make_fold_masks)
from transmogrifai_tpu_torch.parallel import mesh as TMESH
from transmogrifai_tpu_torch.parallel import multihost as TMH
from transmogrifai_tpu_torch.parallel import spmd

import torch_multihost_worker as W

CPU = "cpu"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def eight_cpu_ranks(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "TM_MESH_DEVICES", "TM_MESH_AXIS", "TM_MESH_RDMA_RING"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(TMESH, "visible_devices",
                        lambda: [torch.device(CPU)] * 8)
    yield monkeypatch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_initialize_single_host_noop():
    info = TMH.initialize_distributed()
    assert info["num_processes"] == 1
    assert info["local_device_count"] == info["device_count"] >= 8
    assert info == TMH.process_info()
    jinfo = JMH.initialize_distributed()
    assert jinfo["num_processes"] == info["num_processes"]
    assert not torch.distributed.is_initialized()


def test_initialize_needs_the_whole_launch_contract(eight_cpu_ranks):
    eight_cpu_ranks.setenv("NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        TMH.initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_host_device_groups_contiguous_fallback():
    devs = [torch.device(CPU)] * 8
    groups = TMH.host_device_groups(devs, per_host=4)
    jgroups = JMH.host_device_groups(jax.devices()[:8], per_host=4)
    assert groups.shape == jgroups.shape == (2, 4)
    assert list(groups.reshape(-1)) == devs
    with pytest.raises(ValueError):
        TMH.host_device_groups(devs, per_host=3)


def test_host_device_groups_by_process_index():
    class FakeDev:
        def __init__(self, pid, did):
            self.process_index, self.id = pid, did
    devs = [FakeDev(1, 3), FakeDev(0, 0), FakeDev(1, 2), FakeDev(0, 1)]
    for groups in (TMH.host_device_groups(devs),
                   JMH.host_device_groups(devs)):
        assert groups.shape == (2, 2)
        assert [d.id for d in groups[0]] == [0, 1]    # host 0, id-ordered
        assert [d.id for d in groups[1]] == [2, 3]
    with pytest.raises(ValueError, match="uneven devices per host"):
        TMH.host_device_groups(devs[:3])


def test_a_data_axis_across_processes_raises():
    """The port's rows live in one process: a Mesh2D row holding two
    processes' entries raises, naming hybrid_mesh (whose first axis is
    the one that spans processes)."""
    h = [TMH.DeviceHandle(p, torch.device(CPU), i, f"p{p}/cpu:{i}")
         for i, p in enumerate((0, 1, 0, 1))]
    with pytest.raises(ValueError, match="hybrid_mesh"):
        TP.Mesh2D([h[:2], h[2:]], ("grid", "data"))
    mine = TP.Mesh2D([[h[0], h[2]], [h[1], h[3]]], ("dcn_grid", "data"))
    assert mine.local_rows == [0] and mine.rows[1] is None
    assert mine.labels() == ["p0/cpu:0", "p0/cpu:2", "p1/cpu:1",
                             "p1/cpu:3"]


def test_hybrid_mesh_grid_map_matches_single_device():
    """Grid across simulated hosts, rows data-parallel within a host:
    the per-item weighted log loss equals the unsharded fits (and the
    JAX package's vmapped ones)."""
    mesh = TP.hybrid_mesh([CPU] * 8, per_host=4)
    assert mesh.axis_names == ("dcn_grid", "data")
    assert mesh.shape["dcn_grid"] == 2 and mesh.shape["data"] == 4

    fam = TM.MODEL_FAMILIES["LogisticRegression"]
    rng = np.random.default_rng(0)
    n, d = 96, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    grid = [{"regParam": r, "elasticNetParam": 0.0}
            for r in (0.01, 0.03, 0.1, 0.3)]
    train_m, val_m = make_fold_masks(n, 2)
    tr, va, hy = build_fold_grid_batch(grid, train_m, val_m)

    def fit_eval(items, Xr, yr, wr):
        w_train, w_val = (torch.as_tensor(a) for a in items[:2])
        h = {k: torch.as_tensor(v) for k, v in items[2].items()}
        b = w_train.shape[0]
        params = fam.fit_batch(Xr.expand(b, -1, -1), yr.expand(b, -1),
                               wr[None] * w_train, h, 2)
        out = []
        for j in range(b):
            probs = fam.predict_kernel({k: v[j] for k, v in params.items()},
                                       Xr, 2)
            p1 = torch.clamp(probs[:, 1], 1e-6, 1 - 1e-6)
            ll = -(yr * torch.log(p1) + (1 - yr) * torch.log(1 - p1))
            wv = wr * w_val[j]
            num, den = spmd.row_sum((wv * ll).sum().reshape(1),
                                    wv.sum().reshape(1))
            out.append(num[0] / torch.clamp(den[0], min=1e-9))
        return torch.stack(out)

    repl = tuple(torch.from_numpy(a) for a in (X, y, w))
    sharded = TP.grid_map(fit_eval, (tr, va, hy), repl, mesh).numpy()
    single = fit_eval((tr, va, hy), *repl).numpy()
    np.testing.assert_allclose(sharded, single, rtol=2e-4, atol=2e-5)

    from transmogrifai_tpu.models.base import MODEL_FAMILIES as JF
    jfam = JF["LogisticRegression"]

    def jfit_eval(t, v, h):
        params = jfam.fit_kernel(jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(w) * t, h, 2)
        probs = jfam.predict_kernel(params, jnp.asarray(X), 2)
        p1 = jnp.clip(probs[:, 1], 1e-6, 1 - 1e-6)
        ll = -(y * jnp.log(p1) + (1 - y) * jnp.log(1 - p1))
        wv = w * v
        return jnp.sum(wv * ll) / jnp.maximum(jnp.sum(wv), 1e-9)

    jax_single = np.asarray(jax.vmap(jfit_eval)(tr, va, hy))
    np.testing.assert_allclose(sharded, jax_single, rtol=2e-4, atol=2e-5)


def _binary_ds(rng, n, d):
    from transmogrifai_tpu_torch import FeatureBuilder
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import types as ft
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = ((X[:, 0] + X[:, 1] > 0)).astype(np.float64)
    ds = Dataset({"v": X, "label": y}, {"v": ft.OPVector, "label": ft.RealNN})
    label = FeatureBuilder.of(ft.RealNN, "label").from_column().as_response()
    vec = FeatureBuilder.of(ft.OPVector, "v").from_column().as_predictor()
    return ds, label, vec


def test_selector_over_hybrid_mesh():
    ds, label, vec = _binary_ds(np.random.default_rng(0), 128, 6)
    sel = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=2, device=CPU, candidates=[["LogisticRegression",
                                            {"regParam": [0.01, 0.1],
                                             "elasticNetParam": [0.0]}]])
    sel.set_mesh(TP.hybrid_mesh([CPU] * 8, per_host=4))
    fitted = sel.set_input(label, vec).fit(ds)
    assert fitted.summary["bestModel"]["family"] == "LogisticRegression"
    one = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=2, device=CPU, candidates=[["LogisticRegression",
                                            {"regParam": [0.01, 0.1],
                                             "elasticNetParam": [0.0]}]])
    ref = one.set_input(label, vec).fit(ds).summary
    np.testing.assert_allclose(
        fitted.summary["validationResults"][0]["gridMetrics"],
        ref["validationResults"][0]["gridMetrics"], rtol=1e-4, atol=1e-6)


def test_selector_tree_folded_over_hybrid_mesh():
    """Tree candidates on the hybrid ("dcn_grid", "data") mesh: grid
    items across the simulated hosts, rows sharded with the histogram
    sums over each host's data ranks."""
    fam = TM.MODEL_FAMILIES["GBTClassifier"]
    old = fam.n_rounds_cap
    fam.n_rounds_cap = 6
    try:
        ds, label, vec = _binary_ds(np.random.default_rng(1), 160, 6)
        sel = TM.BinaryClassificationModelSelector.with_cross_validation(
            n_folds=2, device=CPU,
            candidates=[["GBTClassifier", {"stepSize": [0.1, 0.3]}]])
        sel.set_mesh(TP.hybrid_mesh([CPU] * 8, per_host=4))
        fitted = sel.set_input(label, vec).fit(ds)
        best = fitted.summary["bestModel"]
        assert best["family"] == "GBTClassifier"
        tr = fitted.summary["trainEvaluation"]
        assert tr.get("AuROC", tr.get("auroc", 0.0)) > 0.8
    finally:
        fam.n_rounds_cap = old


def test_sparse_sharded_fit_over_hybrid_mesh():
    """Sparse rows ride the hybrid mesh's intra-host "data" axis (not the
    cross-host one) and reproduce the single-device fit."""
    mesh = TP.hybrid_mesh(per_host=4)          # (2, 4) = (dcn_grid, data)
    assert mesh.axis_names == ("dcn_grid", "data")
    rng = np.random.default_rng(11)
    n, K, D, B = 1024, 4, 3, 1 << 10
    idx = rng.integers(0, B, size=(n, K)).astype(np.int32)
    X = rng.normal(size=(n, D)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    single = TS.fit_sparse_lr(idx, X, y, w, B, lr=0.1, epochs=1,
                              batch_size=256, device=CPU)
    sharded = TS.fit_sparse_lr_sharded(idx, X, y, w, B, mesh=mesh, lr=0.1,
                                       epochs=1, batch_size=256)
    np.testing.assert_allclose(sharded["table"], single["table"],
                               rtol=1e-4, atol=1e-6)


def _free_addr() -> str:
    with socket.socket() as s:                  # free localhost port
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _two_processes(tmp_path, *extra):
    """Run ``tests/torch_multihost_worker.py`` as processes 0 and 1 at a
    free localhost port (``extra``: its further arguments); both must
    exit 0 within 120 s. Returns what each wrote."""
    addr = _free_addr()
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                        "TM_MESH_AXIS", "TM_MESH_DEVICES")}
    env.update(PYTHONPATH=_REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    worker = os.path.join(_REPO, "tests", "torch_multihost_worker.py")
    outs = [tmp_path / f"p{p}.json" for p in (0, 1)]
    procs = [subprocess.Popen([sys.executable, worker, addr, str(p),
                               str(outs[p]), *extra], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=_REPO,
                              env=env) for p in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    return [json.loads(o.read_text()) for o in outs]


def test_real_two_process_gloo_runner(tmp_path):
    """Two OS processes, a localhost coordinator, each with two CPU
    ranks: ``initialize_distributed`` (and its idempotent second call),
    the hybrid and default meshes over both processes, a cross-process
    ``grid_map``, and the LR + GBT selector through ``WorkflowRunner``
    TRAIN with ``OpParams.distributed``: both processes see every grid
    row's results (the same metrics and winner, bitwise), within the
    tolerances of the one-process fit."""
    seen = _two_processes(tmp_path)
    for pid, s in enumerate(seen):
        assert s["info"] == s["again"] == {
            "process_id": pid, "num_processes": 2, "device_count": 4,
            "local_device_count": 2}
        assert s["mesh"] == {
            "axes": ["dcn_grid", "data"], "shape": {"dcn_grid": 2,
                                                    "data": 2},
            "labels": ["p0/cpu:0", "p0/cpu:1", "p1/cpu:0", "p1/cpu:1"],
            "local_rows": [pid]}
        assert s["default_mesh"] == {"axes": ["dcn_grid", "data"],
                                     "shape": {"dcn_grid": 2, "data": 2}}
        assert s["default_grid_mesh"] == {"axes": ["dcn_grid", "grid"],
                                          "shape": {"dcn_grid": 2,
                                                    "grid": 2}}
        assert s["grid_map"] == [28.0 * i for i in range(5)]
        assert s["grid_map_1d"] == [28.0 * i for i in range(5)]
    assert seen[0]["grid"] == seen[1]["grid"]
    assert seen[0]["winner"] == seen[1]["winner"]
    gbt = TM.MODEL_FAMILIES["GBTClassifier"]
    old = gbt.n_rounds_cap
    try:
        ds, sel = W.selector(CPU)           # cuts GBT's rounds as the workers
        ref = sel.fit(ds).summary
    finally:
        gbt.n_rounds_cap = old
    want = W.grid_metrics(ref)
    assert seen[0]["winner"] == ref["bestModel"]["family"]
    np.testing.assert_allclose(seen[0]["grid"]["LogisticRegression"],
                               want["LogisticRegression"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(seen[0]["grid"]["GBTClassifier"],
                               want["GBTClassifier"], rtol=0, atol=1e-2)


def test_two_processes_retry_an_out_of_memory_alike(tmp_path):
    """Process 1's first LogisticRegression fit runs out of memory: it
    tells process 0 through the rows' gather, both raise the
    out-of-memory error and both re-run the batch in the same chunks, so
    their gathers stay paired (as many on each) and both report the
    same metrics and winner, within the tolerances of the one-process
    fit."""
    seen = _two_processes(tmp_path, "oom")
    assert [s["oom_fired"] for s in seen] == [False, True]
    assert seen[0]["gathers"] == seen[1]["gathers"]
    assert seen[0]["grid"] == seen[1]["grid"]
    assert seen[0]["winner"] == seen[1]["winner"]
    gbt = TM.MODEL_FAMILIES["GBTClassifier"]
    old = gbt.n_rounds_cap
    try:
        ds, sel = W.selector(CPU)
        ref = sel.fit(ds).summary
    finally:
        gbt.n_rounds_cap = old
    want = W.grid_metrics(ref)
    assert seen[0]["winner"] == ref["bestModel"]["family"]
    np.testing.assert_allclose(seen[0]["grid"]["LogisticRegression"],
                               want["LogisticRegression"], rtol=1e-4,
                               atol=1e-6)


class _Parts:
    """``multihost._all_gather`` replaced by fixed peers' payloads."""

    def __init__(self, monkeypatch, *peers):
        self.peers = peers
        monkeypatch.setattr(TMH, "_all_gather", self)

    def __call__(self, mine):
        return [mine, *({**mine, **p} for p in self.peers)]


def _two_row_mesh():
    return TP.Mesh2D([[CPU], [CPU]], ("dcn_grid", "data"))


def test_gather_refuses_rows_of_different_dispatches(monkeypatch):
    """A peer whose gather belongs to another dispatch (another batch or
    another place in its sequence) fails the gather on every process."""
    mesh = _two_row_mesh()
    _Parts(monkeypatch, {"key": (0, "sweep/other"), "rows": {1: 1.0}})
    with pytest.raises(RuntimeError, match="different dispatches"):
        TMH.gather_rows_results({0: 0.0}, mesh, "sweep/lr")


@pytest.mark.parametrize("oom", [True, False])
def test_gather_raises_a_peers_failure_on_every_process(monkeypatch, oom):
    """A peer whose rows raised sends its error instead of rows: this
    process raises too, an out-of-memory error when the peer ran out of
    memory (so both take the same retry), else a RuntimeError naming
    the peer."""
    mesh = _two_row_mesh()
    err = ("OutOfMemoryError" if oom else "ValueError", "boom", oom)
    _Parts(monkeypatch, {"error": err, "rows": {}})
    want = torch.cuda.OutOfMemoryError if oom else RuntimeError
    with pytest.raises(want, match="process 1 failed its mesh rows"):
        TMH.gather_rows_results({0: 0.0}, mesh, "sweep/lr")


def test_gather_raises_its_own_failure_after_the_gather(monkeypatch):
    """The process whose rows raised still takes part in the gather (its
    peers are not left waiting), then raises its own error."""
    mesh = _two_row_mesh()
    parts = _Parts(monkeypatch, {"rows": {1: 1.0}})
    calls = []
    monkeypatch.setattr(TMH, "_all_gather",
                        lambda mine: calls.append(mine) or parts(mine))
    with pytest.raises(ValueError, match="mine"):
        TMH.gather_rows_results({}, mesh, "sweep/lr",
                               error=ValueError("mine"))
    assert calls and calls[0]["error"][0] == "ValueError"
