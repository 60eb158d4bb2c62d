"""The port's fused multi-model serving engine on the CPU, against the
JAX package's fused engine on the same models and requests.

Models are trained by the JAX package (the fused-serving suite's
seeds), exported as portable artifacts and loaded by the port with
``device="cpu"``. Scores agree within 1e-5 (f32 arithmetic in another
order); under ``TM_KERNEL_EXACT=1`` the port's fused results are
bitwise-equal to its own per-model scoring.
"""
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from tests.serving_util import train_small_serving_model
from transmogrifai_tpu.portable_export import export_portable

SEEDS = (11, 23, 37, 41, 59)
BUCKETS = (8, 32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """[(jax model, portable dir, result name)] + the shared data."""
    out, ds = [], None
    for seed in SEEDS:
        model, d, pred = train_small_serving_model(seed)
        path = str(tmp_path_factory.mktemp(f"eng{seed}"))
        export_portable(model, path, buckets=BUCKETS)
        out.append((model, path, pred))
        ds = ds or d
    return out, ds


def _requests(ds, count, k, seed=0):
    """count (model index, {column: array}) requests of 1-6 rows."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(count):
        n = int(rng.integers(1, 7))
        lo = int(rng.integers(0, ds.n_rows - n))
        cols = {f"x{i}": ds.column(f"x{i}")[lo:lo + n] for i in range(5)}
        reqs.append((int(rng.integers(0, k)), cols))
    return reqs


def _port_engine(trained, k, **cfg):
    from transmogrifai_tpu_torch.serving import (EngineConfig,
                                                 ModelRegistry,
                                                 ServingEngine)
    models, _ds = trained
    reg = ModelRegistry()
    for i, (_m, path, _p) in enumerate(models[:k]):
        reg.register(f"m{i:03d}", path, buckets=BUCKETS, device="cpu")
    cfg.setdefault("max_wait_ms", 50.0)
    return ServingEngine(registry=reg, config=EngineConfig(
        fused_kernel=True, **cfg)).start()


def _jax_engine(trained, k):
    from transmogrifai_tpu.dataset import Dataset
    from transmogrifai_tpu.serving import ModelRegistry, ServingEngine
    from transmogrifai_tpu.serving.engine import EngineConfig
    models, ds = trained
    reg = ModelRegistry()
    warm = Dataset({c: ds.column(c)[:1] for c in ds.column_names},
                   {c: ds.ftype(c) for c in ds.column_names})
    for i, (m, _path, _p) in enumerate(models[:k]):
        reg.register(f"m{i:03d}", m, buckets=BUCKETS, warm_sample=warm)
    return ServingEngine(registry=reg, config=EngineConfig(
        fused_kernel=True, max_wait_ms=50.0)).start()


def _jax_data(ds, cols):
    from transmogrifai_tpu.dataset import Dataset
    from transmogrifai_tpu.features import types as ft
    d = dict(cols)
    d["label"] = np.zeros(len(cols["x0"]))
    return Dataset(d, {c: (ft.RealNN if c == "label" else ft.Real)
                       for c in d})


@pytest.mark.parametrize("k", [2, 5])
def test_port_fused_engine_matches_jax_fused_engine(trained, k,
                                                    monkeypatch):
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    models, ds = trained
    reqs = _requests(ds, 40, k, seed=k)
    port = _port_engine(trained, k)
    jeng = _jax_engine(trained, k)
    try:
        pf = [port.submit(c, model=f"m{i:03d}") for i, c in reqs]
        jf = [jeng.submit(_jax_data(ds, c), model=f"m{i:03d}")
              for i, c in reqs]
        for (i, _c), a, b in zip(reqs, pf, jf):
            name = models[i][2]
            got, ref = a.result(30)[name], b.result(30)[name]
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, atol=1e-5)
    finally:
        port.stop()
        jeng.stop()
    st = port.stats.as_dict()
    assert st["fused_batches"] > 0 and st["fused_fallbacks"] == 0
    assert st["completed"] == len(reqs) and st["failed"] == 0
    assert jeng.stats.as_dict()["fused_batches"] > 0


def test_exact_mode_fused_is_bitwise_per_model(trained, monkeypatch):
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    models, ds = trained
    reqs = _requests(ds, 60, 5, seed=99)
    solo = [portable.load(p, device="cpu").compile_scoring(buckets=BUCKETS)
            for _m, p, _n in models]
    eng = _port_engine(trained, 5)
    try:
        futs = [eng.submit(c, model=f"m{i:03d}") for i, c in reqs]
        for (i, c), f in zip(reqs, futs):
            name = models[i][2]
            np.testing.assert_array_equal(
                f.result(30)[name], solo[i].score_arrays(c)[name])
    finally:
        eng.stop()
    assert eng.stats.as_dict()["fused_batches"] > 0
    scorer = next(iter(eng._fused_scorers.values()))
    assert scorer.exact and scorer.policy_token == sk.serve_policy_token(
        "cpu")


def test_aliases_co_batch_into_one_dispatch(trained):
    from transmogrifai_tpu_torch.serving import (EngineConfig,
                                                 ModelRegistry,
                                                 ServingEngine)
    models, ds = trained
    reg = ModelRegistry()
    reg.register("base", models[0][1], buckets=BUCKETS, device="cpu")
    for a in ("org1", "org2", "org3"):
        reg.alias(a, "base")
    assert reg.resolve("org2") == "base"
    eng = ServingEngine(registry=reg, config=EngineConfig(
        fused_kernel=True, max_wait_ms=50.0)).start()
    reqs = _requests(ds, 9, 1, seed=5)
    try:
        futs = [eng.submit(c, model=("org1", "org2", "org3")[j % 3])
                for j, (_i, c) in enumerate(reqs)]
        res = [f.result(30)[models[0][2]] for f in futs]
    finally:
        eng.stop()
    st = eng.stats.as_dict()
    assert st["batches"] == 1 and st["batched_requests"] == 9
    assert st["fused_batches"] == 0      # one backend: nothing to fuse
    assert set(st["models"]["top"]) == {"org1", "org2", "org3"}
    solo = reg.get("base").backend.scorer
    for (_i, c), r in zip(reqs, res):
        np.testing.assert_array_equal(r, solo.score_arrays(c)[models[0][2]])


def test_unknown_model_is_loud(trained):
    from transmogrifai_tpu_torch.serving import ModelNotFound
    eng = _port_engine(trained, 2)
    try:
        with pytest.raises(ModelNotFound, match="nope"):
            eng.submit({"x0": np.zeros(1)}, model="nope")
        with pytest.raises(KeyError):
            eng.registry.resolve("m999")
    finally:
        eng.stop()
    assert eng.stats.as_dict()["submitted"] == 0


def test_eight_thread_storm_leaves_a_balanced_ledger(trained):
    models, ds = trained
    reqs = _requests(ds, 160, 5, seed=8)
    eng = _port_engine(trained, 5, max_wait_ms=2.0, max_batch_rows=32)
    solo = {i: eng.registry.get(f"m{i:03d}").backend.scorer
            for i in range(5)}
    errors = []

    def client(t):
        try:
            for j in range(t, len(reqs), 8):
                i, c = reqs[j]
                got = eng.submit(c, model=f"m{i:03d}").result(30)
                name = models[i][2]
                np.testing.assert_allclose(
                    got[name], solo[i].score_arrays(c)[name], atol=1e-6)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    eng.stop()
    assert not errors, errors[0]
    st = eng.stats.as_dict()
    assert st["submitted"] == st["completed"] == len(reqs)
    for key in ("failed", "shed_expired", "cancelled", "rejected_queue_full",
                "rejected_predicted_late", "rejected_tenant_budget",
                "queue_depth_requests", "queue_depth_rows",
                "fused_fallbacks"):
        assert st[key] == 0, key
    assert st["fused_batches"] > 0
    assert st["batched_requests"] == len(reqs)
    assert sum(v["requests"] for v in st["tenants"].values()) == len(reqs)


def test_chip_smoke_serving_phase_rehearsal():
    """chip_smoke.py's serving phase at full width on the CPU: the
    100-id catalog over four from_portable LR backends, buckets
    (16, 64), Zipf ids from 8 threads; every result checked against
    its numpy score under the operand policy of the plane that served
    it, as the engine's spans name that plane."""
    out = chip_smoke.serving_phase(3, torch.device("cpu"), requests=128)
    assert out["failed"] == 0 and out["fused_fallbacks"] == 0
    assert out["fused_batches"] > 0 and out["completed"] == 128
    assert out["matched"]["fused"] == out["fused_requests"] > 0
    assert out["matched"]["fused"] + out["matched"]["classic"] == 128
    assert 0 < out["fused_dispatch_rows_mean"] <= chip_smoke.MAX_BATCH_ROWS
    assert out["fused_dispatch_p99_ms"] >= out["fused_dispatch_p50_ms"] > 0


def _ir_model(rng, name, family, n_classes, L):
    manifest, arrays, _par = chip_smoke.make_model_ir(rng, name)
    head = manifest["stages"][-1]
    head.update(family=family, nClasses=n_classes)
    p1 = chip_smoke.P_KEEP + 1
    key = str(len(manifest["stages"]) - 1)
    arrays[key] = {"params": (
        {"theta": rng.normal(size=(p1, L))} if L > 1
        else {"beta": rng.normal(size=p1)})}
    return manifest, arrays


@pytest.mark.parametrize("family,n_classes,L", [
    ("LogisticRegression", 3, 3), ("LinearRegression", 1, 1),
    ("LinearSVC", 2, 1)])
def test_other_stackable_heads_fuse(family, n_classes, L, monkeypatch):
    """Softmax, identity and SVC heads stack too; fused scores equal
    each model's own scoring (f32 on the CPU, atol 1e-5)."""
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.serving import (EngineConfig,
                                                 ModelRegistry,
                                                 ServingEngine,
                                                 stack_spec_of)
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    rng = np.random.default_rng(L)
    reg = ModelRegistry()
    for k in range(3):
        m, a = _ir_model(rng, f"out{k}", family, n_classes, L)
        reg.register(f"m{k}", portable.from_portable(m, a, "cpu"),
                     buckets=(16, 64))
    spec = stack_spec_of(reg.get("m0").backend)
    assert spec is not None and spec.L == L
    eng = ServingEngine(registry=reg, config=EngineConfig(
        fused_kernel=True, max_wait_ms=50.0)).start()
    reqs = [(k % 3, {f"x{i}": rng.normal(size=3) for i in range(12)})
            for k in range(12)]
    try:
        futs = [eng.submit(c, model=f"m{k}") for k, c in reqs]
        for (k, c), f in zip(reqs, futs):
            solo = reg.get(f"m{k}").backend.scorer.score_arrays(c)
            np.testing.assert_allclose(f.result(30)[f"out{k}"],
                                       solo[f"out{k}"], atol=1e-5)
    finally:
        eng.stop()
    assert eng.stats.as_dict()["fused_batches"] > 0


def test_unstackable_backend_falls_back_loudly():
    """A two-result chain cannot stack: it keeps classic co-batching
    with correct scores, and every such group counts a fallback."""
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.serving import (EngineConfig,
                                                 ModelRegistry,
                                                 ServingEngine)
    from transmogrifai_tpu_torch.telemetry import RECORDER
    rng = np.random.default_rng(1)
    reg = ModelRegistry()
    for k in range(2):
        m, a, _ = chip_smoke.make_model_ir(rng, f"out{k}")
        m["resultNames"] = [f"out{k}", "combined"]
        reg.register(f"m{k}", portable.from_portable(m, a, "cpu"),
                     buckets=(16,))
    RECORDER.clear()
    eng = ServingEngine(registry=reg, config=EngineConfig(
        fused_kernel=True, max_wait_ms=50.0)).start()
    cols = {f"x{i}": rng.normal(size=2) for i in range(12)}
    try:
        futs = [eng.submit(cols, model=f"m{k}") for k in (0, 1, 0, 1)]
        res = [f.result(30) for f in futs]
    finally:
        eng.stop()
    st = eng.stats.as_dict()
    assert st["fused_batches"] == 0 and st["fused_fallbacks"] >= 2
    assert res[0]["combined"].shape == (2, 24)
    assert RECORDER.events(subsystem="serving")


def test_fused_knobs_parse_strictly():
    """The port keeps the JAX package's strict TM_SERVE_FUSED_* parse;
    its Pallas selector has no counterpart, so the name is rejected."""
    from transmogrifai_tpu.serving.engine import EngineConfig as JaxConfig
    from transmogrifai_tpu_torch.serving import EngineConfig
    env = {"TM_SERVE_FUSED_KERNEL": "1", "TM_SERVE_FUSED_MIN_MODELS": "3"}
    cfg, ref = EngineConfig.from_env(env), JaxConfig.from_env(env)
    assert (cfg.fused_kernel, cfg.fused_min_models) == \
        (ref.fused_kernel, ref.fused_min_models) == (True, 3)
    for bad in ({"TM_SERVE_FUSED_PALLAS": "1"},
                {"TM_SERVE_FUSED_KERNLE": "1"},
                {"TM_SERVE_FUSED_MIN_MODELS": "1"}):
        with pytest.raises(ValueError, match="TM_SERVE_FUSED"):
            EngineConfig.from_env(bad)
    assert EngineConfig().fused_kernel is False     # default off, as JAX


@pytest.mark.parametrize("name,value", [
    ("TM_ENGINE_REQUEST_PLANE", "legacy"), ("TM_ENGINE_QUEUE_IMPL", "dict"),
    ("TM_MODEL_CROSS_BATCH", "0")])
def test_jax_only_plane_selectors_are_rejected(name, value):
    """The JAX package's baseline-plane selectors have no counterpart
    in the port (one request plane, always cross-model): the strict
    parse rejects them instead of silently ignoring them."""
    from transmogrifai_tpu.serving.engine import EngineConfig as JaxConfig
    from transmogrifai_tpu_torch.serving import EngineConfig
    JaxConfig.from_env({name: value})
    with pytest.raises(ValueError, match=name.rsplit("_", 2)[0]):
        EngineConfig.from_env({name: value})


def test_lru_cache_evicts_and_reloads_lazy_versions(trained):
    """max_loaded bounds the warm population: the least recently used
    lazy version is evicted, reloads on its next acquire, and scores
    as before; every load and eviction is counted."""
    from transmogrifai_tpu_torch.serving import ModelRegistry
    models, ds = trained
    reg = ModelRegistry(max_loaded=2)
    for i in range(3):
        reg.register_lazy(f"m{i}", models[i][1], buckets=BUCKETS,
                          device="cpu")
    cols = {f"x{i}": ds.column(f"x{i}")[:4] for i in range(5)}
    first = {}
    for i in range(3):
        with reg.acquire(f"m{i}") as (_name, backend):
            first[i] = backend.scorer.score_arrays(cols)[models[i][2]]
    st = reg.cache_stats()
    assert (st["cold_loads"], st["evictions"], st["loaded"]) == (3, 1, 2)
    assert not reg.versions()["m1"]["loaded"]     # m0 is the default
    with reg.acquire("m1") as (_name, backend):
        again = backend.scorer.score_arrays(cols)[models[1][2]]
    np.testing.assert_array_equal(again, first[1])
    st = reg.cache_stats()
    assert (st["reloads"], st["evictions"], st["capacity"]) == (1, 2, 2)
