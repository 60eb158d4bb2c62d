"""The fused serving pass's prefix form on the CPU: the prefix compiler,
the plain version ``fused_prefix_scores_torch`` and the port's
``FusedGroupScorer`` on its stacked branch, against numpy and against
the JAX package's ``FusedGroupScorer`` on the same members and inputs;
the engine on a generic-form pair and on a tree head it refuses.

Tolerances: against the numpy f64 oracle, f32 accumulation over at most
p + 1 products of values of order one, so about 1e-5 relative (rtol =
atol = 1e-5); against the JAX package, 1e-5 as the engine parity test
states (f32 arithmetic in another order). The identity table is bitwise
``fused_linear_scores_torch``: the gather copies values. The CUDA
kernel runs only on the card: tests/test_torch_cuda.py.
"""
import types

import numpy as np
import pytest
import torch

import chip_smoke
from transmogrifai_tpu_torch import portable
from transmogrifai_tpu_torch.models import serving_kernels as sk
from transmogrifai_tpu_torch.serving import fusion

HEADS = {   # act -> (family, nClasses, L)
    "sigmoid_pair": ("LogisticRegression", 2, 1),
    "softmax": ("LogisticRegression", 3, 3),
    "identity": ("LinearRegression", 1, 1),
}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _prefix_inputs(seed, n, C, p, K, L):
    """Boundary values with 5% NaN, one column all NaN and one integer
    valued; random tables, weights and model ids (two rows out of
    range)."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, C)).astype(np.float32)
    V[rng.random((n, C)) < 0.05] = np.nan
    V[:, 0] = np.nan
    V[:, 1] = rng.integers(-50, 50, size=n)
    src = rng.integers(0, C, size=(K, p)).astype(np.int32)
    op = rng.integers(sk.OP_FILLED, sk.OP_NULL + 1,
                      size=(K, p)).astype(np.uint8)
    fill = rng.normal(size=(K, p)).astype(np.float32)
    W = (0.5 * rng.normal(size=(K, p + 1, L))).astype(np.float32)
    mid = rng.integers(0, K, size=n).astype(np.int32)
    mid[:2] = (-1, K)[:n]
    return V, mid, src, op, fill, W


def _np_features(V, mid, src, op, fill):
    K = src.shape[0]
    X = np.zeros((V.shape[0], src.shape[1]), np.float32)
    for i, m in enumerate(mid):
        m = m if 0 <= m < K else 0
        v = V[i, src[m]]
        null = np.isnan(v)
        X[i] = np.where(op[m] == sk.OP_NULL, null.astype(np.float32),
                        np.where((op[m] == sk.OP_FILLED) & null, fill[m], v))
    return X


def _np_act(act, z):
    if act == "sigmoid_pair":
        p1 = 1.0 / (1.0 + np.exp(-z[:, 0]))
        return np.stack([1.0 - p1, p1], axis=1)
    if act == "softmax":
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)
    return z


@pytest.mark.parametrize("n", [1, 37, 64])
@pytest.mark.parametrize("act", sorted(HEADS))
def test_plain_prefix_scores_match_numpy_oracle(act, n):
    L = HEADS[act][2]
    V, mid, src, op, fill, W = _prefix_inputs(n * 7 + L, n, 13, 22, 4, L)
    got = sk.fused_prefix_scores_torch(*_t(V, mid, src, op, fill, W),
                                       act=act).numpy()
    X = _np_features(V, mid, src, op, fill)
    assert np.isfinite(X).all()
    ok = (mid >= 0) & (mid < 4)
    z = sk.np_reference_scores(X, W, np.where(ok, mid, 0))
    z[~ok] = 0.0                        # out of range: z = 0
    want = _np_act(act, z)
    assert got.shape == want.shape == (n, 2 if act == "sigmoid_pair"
                                       else L)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the wrapper on CPU tensors IS the plain version, and launches
    # nothing
    before = sk.fused_linear_scores.launches
    wrapped = sk.fused_prefix_scores(*_t(V, mid, src, op, fill, W),
                                     act=act).numpy()
    np.testing.assert_array_equal(wrapped, got)
    assert sk.fused_linear_scores.launches == before


def test_out_of_range_rows_get_zero_scores_before_the_activation():
    V, mid, src, op, fill, W = _prefix_inputs(3, 16, 13, 22, 4, 3)
    W[3] = np.inf                       # a model no row selects
    mid = np.where(np.arange(16) % 2 == 0, mid % 3, 4).astype(np.int32)
    mid[1] = -7
    args = _t(V, mid, src, op, fill, W)
    soft = sk.fused_prefix_scores_torch(*args, act="softmax").numpy()
    ident = sk.fused_prefix_scores_torch(*args, act="identity").numpy()
    assert np.isfinite(soft).all() and np.isfinite(ident).all()
    np.testing.assert_array_equal(ident[1::2], 0.0)
    np.testing.assert_allclose(soft[1::2], 1.0 / 3.0, rtol=1e-6)
    pair = sk.fused_prefix_scores_torch(
        *_t(V, mid, src, op, fill, W[..., :1]), act="sigmoid_pair").numpy()
    np.testing.assert_array_equal(pair[1::2], 0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 3])
def test_identity_table_is_bitwise_fused_linear_scores(dtype, L):
    """src[k, j] = j and every op "value as is": the prefix form is the
    plain contraction, NaN rows and all."""
    rng = np.random.default_rng(L)
    n, p, K = 41, 24, 5
    X = rng.normal(size=(n, p)).astype(np.float32)
    X[3, 4] = np.nan
    W = rng.normal(size=(K, p + 1, L)).astype(np.float32)
    mid = rng.integers(0, K, size=n).astype(np.int32)
    src = np.tile(np.arange(p, dtype=np.int32), (K, 1))
    op = np.full((K, p), sk.OP_VALUE, np.uint8)
    fill = np.zeros((K, p), np.float32)
    got = sk.fused_prefix_scores_torch(*_t(X, mid, src, op, fill, W),
                                       act="identity", dtype=dtype)
    ref = sk.fused_linear_scores_torch(*_t(X, W, mid), dtype=dtype)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.numpy().view(np.uint32))


def test_prefix_arguments_are_checked():
    V, mid, src, op, fill, W = _t(*_prefix_inputs(1, 8, 13, 22, 4, 3))
    f = sk.fused_prefix_scores
    with pytest.raises(ValueError, match="sigmoid pair head has L = 1"):
        f(V, mid, src, op, fill, W, act="sigmoid_pair")
    with pytest.raises(ValueError, match="unknown activation"):
        f(V, mid, src, op, fill, W, act="tanh")
    with pytest.raises(ValueError, match="prefix tables disagree"):
        f(V, mid, src, op[:, :-1], fill, W, act="softmax")
    with pytest.raises(ValueError, match="weight blocks for 4"):
        f(V, mid, src, op, fill, W[:3], act="softmax")
    with pytest.raises(ValueError, match="weight stack rows"):
        f(V, mid, src, op, fill, W[:, 1:], act="softmax")
    with pytest.raises(TypeError, match="uint8"):
        f(V, mid, src, op.to(torch.int32), fill, W, act="softmax")
    with pytest.raises(TypeError, match="V and W must be float32"):
        f(V.double(), mid, src, op, fill, W, act="softmax")
    with pytest.raises(ValueError, match="mid has"):
        f(V, mid[:-1], src, op, fill, W, act="softmax")


def test_prefix_cost_counts_each_input_and_output_once():
    c = sk.fused_prefix_cost(64, 13, 22, 4, 1, 2)
    assert c["bytes"] == 64 * 13 * 4 + 64 * 4 + 4 * 22 * 9 \
        + 4 * 23 * 1 * 4 + 64 * 2 * 4
    assert c["flops"] == 2 * 64 * 23 * 1


# ---------------------------------------------------------------------------
# the prefix compiler and the stacked pass
# ---------------------------------------------------------------------------

def _ir(rng, name, act):
    """chip_smoke's serving-phase workflow IR with the head ``act``."""
    family, n_classes, L = HEADS[act]
    manifest, arrays, _par = chip_smoke.make_model_ir(rng, name)
    manifest["stages"][-1].update(family=family, nClasses=n_classes)
    p1 = chip_smoke.P_KEEP + 1
    arrays[str(len(manifest["stages"]) - 1)] = {"params": (
        {"theta": rng.normal(size=(p1, L))} if L > 1
        else {"beta": rng.normal(size=p1)})}
    return manifest, arrays


def _port_member(manifest, arrays):
    pm = portable.from_portable(manifest, arrays, "cpu")
    backend = types.SimpleNamespace(
        scorer=pm.compile_scoring(buckets=chip_smoke.BUCKETS))
    return backend, fusion.stack_spec_of(backend)


def _jax_member(manifest, arrays):
    """The same IR as a JAX-package member: its own device functions
    for impute / concat / keep_cols, its own StackSpec."""
    from transmogrifai_tpu.ops.sanity_checker import SanityCheckerModel
    from transmogrifai_tpu.ops.vectorizers import (VectorsCombiner,
                                                   _impute_device_fn)
    from transmogrifai_tpu.serving.fusion import StackSpec
    from transmogrifai_tpu.workflow import FusedScorer
    infos = []
    for i, st in enumerate(manifest["stages"]):
        if st["op"] == "impute":
            fn = _impute_device_fn(float(st["fill"]), bool(st["track"]))
        elif st["op"] == "concat":
            fn = VectorsCombiner().make_device_fn()
        elif st["op"] == "keep_cols":
            fn = SanityCheckerModel(
                keep_indices=arrays[str(i)]["keep"]).make_device_fn()
        else:
            fn = None       # the head: the stacked branch reads W only
        infos.append((st["inputs"], fn, st["out"]))
    head = manifest["stages"][-1]
    params = arrays[str(len(manifest["stages"]) - 1)]["params"]
    family = head["family"]
    if "theta" in params:
        W, act = np.asarray(params["theta"], np.float32), "softmax"
    else:
        W = np.asarray(params["beta"], np.float32).reshape(-1, 1)
        act = "identity" if family == "LinearRegression" else "sigmoid_pair"
    slicer = types.SimpleNamespace(buckets=chip_smoke.BUCKETS)
    scorer = types.SimpleNamespace(
        device_infos=infos,
        _bucket_slices=lambda n: FusedScorer._bucket_slices(slicer, n))
    spec = StackSpec(family, act, W, head["inputs"][1], head["out"],
                     manifest["boundary"], manifest["responseBoundary"],
                     chip_smoke.BUCKETS)
    return types.SimpleNamespace(scorer=scorer), spec


def _request(rng, n):
    """chip_smoke's request columns: 5% NaN, x0 all NaN, x1 none, x2
    integers (served as int32)."""
    cols = {f"x{i}": np.where(rng.random(n) < 0.05, np.nan,
                              rng.normal(size=n))
            for i in range(chip_smoke.N_COLUMNS)}
    cols["x0"][:] = np.nan
    cols["x1"] = rng.normal(size=n)
    cols["x2"] = rng.integers(-50, 50, size=n)
    return cols


@pytest.mark.parametrize("n", [23, 64, 150])
@pytest.mark.parametrize("act", sorted(HEADS))
def test_port_fused_group_scorer_matches_jax_fused_group_scorer(
        act, n, monkeypatch):
    """The stacked branch on the CPU (the plain prefix form, one packed
    buffer a slice) against the JAX package's jitted pass (eager prefix
    per member, where-select, the XLA twin, activation), 1e-5; 150 rows
    take three bucket slices."""
    from transmogrifai_tpu.serving.fusion import (
        FusedGroupScorer as JaxGroupScorer)
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    rng = np.random.default_rng(n)
    irs = [_ir(rng, f"out{k}", act) for k in range(4)]
    port = fusion.FusedGroupScorer([_port_member(*ir) for ir in irs])
    jax_ = JaxGroupScorer([_jax_member(*ir) for ir in irs],
                          pallas_mode="0")
    assert port._tails is None and not jax_.exact
    _n, vals = port.backends[0].scorer._boundary_host(_request(rng, n))
    assert vals[2].dtype == np.int32
    mid = rng.integers(0, 4, size=n).astype(np.int32)
    got = port.finalize(port.launch(n, vals, mid))
    want = jax_.finalize(jax_.launch(n, vals, mid))
    assert got.shape == want.shape == (n, port.n_out)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_compiler_never_reads_the_label_and_keeps_the_fill_in_f32():
    rng = np.random.default_rng(4)
    manifest, arrays, par = chip_smoke.make_model_ir(rng, "out")
    manifest["stages"][0]["fill"] = 0.1     # not an f32 value
    backend, spec = _port_member(manifest, arrays)
    assert spec.form == fusion.TABLE
    label = manifest["boundary"].index("label")
    src, op, fill = fusion.compile_prefix(
        backend.scorer, spec.feature_name, [()] * len(manifest["boundary"]))
    assert label not in src and spec.p == chip_smoke.P_KEEP
    # feature 2c is column c filled, 2c + 1 its indicator, then keep
    col = np.repeat(np.arange(chip_smoke.N_COLUMNS), 2)[par["keep"]]
    np.testing.assert_array_equal(src, col)
    np.testing.assert_array_equal(
        op, np.tile([sk.OP_FILLED, sk.OP_NULL],
                    chip_smoke.N_COLUMNS)[par["keep"]])
    first = np.flatnonzero((src == 0) & (op == sk.OP_FILLED))
    assert all(fill[first] == np.float32(0.1))


def _serve_pair(irs, rng):
    """Two portable members behind one engine with the fused plane on,
    four requests submitted together. Returns (registry, engine stats,
    request columns, [(member, result)])."""
    from transmogrifai_tpu_torch.serving import (EngineConfig,
                                                 ModelRegistry,
                                                 ServingEngine)
    reg = ModelRegistry()
    for k, (m, a) in enumerate(irs):
        reg.register(f"m{k}", portable.from_portable(m, a, "cpu"),
                     buckets=chip_smoke.BUCKETS)
    eng = ServingEngine(registry=reg, config=EngineConfig(
        fused_kernel=True, max_wait_ms=50.0)).start()
    cols = _request(rng, 5)
    try:
        res = [(k, f.result(30)) for k, f in
               [(k, eng.submit(cols, model=f"m{k}")) for k in (0, 1, 0, 1)]]
    finally:
        eng.stop()
    return reg, eng.stats.as_dict(), cols, res


def test_member_with_another_prefix_stage_rides_the_generic_form(
        monkeypatch):
    """A prefix the compiler does not know (``chip_smoke.
    make_stacked_ir``: an inner predict feeding the head) gets a
    StackSpec of the generic form: the engine fuses
    both members (each one's own prefix, then the kernel's identity
    table through the activation), no fallback, each row within 1e-5
    of its own model (the CPU's f32 in another order)."""
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    rng = np.random.default_rng(6)
    irs = [chip_smoke.make_stacked_ir(rng, f"out{k}")[:2]
           for k in range(2)]
    reg, st, cols, res = _serve_pair(irs, rng)
    for k in range(2):
        backend = reg.get(f"m{k}").backend
        assert fusion.compile_prefix(backend.scorer, "inner") is None
        assert fusion.stack_spec_of(backend).form == fusion.GENERIC
    assert st["fused_batches"] > 0 and st["fused_fallbacks"] == 0
    assert st["failed"] == 0
    for k, r in res:
        solo = reg.get(f"m{k}").backend.scorer.score_arrays(cols)
        np.testing.assert_allclose(r[f"out{k}"], solo[f"out{k}"],
                                   rtol=0, atol=1e-5)


def _tree_head_ir(rng, name):
    """chip_smoke's serving IR with a depth-2 decision tree head over
    the kept features, a head neither package stacks."""
    manifest, arrays, _par = chip_smoke.make_model_ir(rng, name)
    manifest["stages"][-1].update(family="DecisionTreeClassifier",
                                  nClasses=2)
    arrays[str(len(manifest["stages"]) - 1)] = {"params": {
        "feat": rng.integers(0, chip_smoke.P_KEEP, (1, 3)).astype(np.int32),
        "thr": rng.normal(size=(1, 3)).astype(np.float32),
        "leaf": rng.dirichlet((1.0, 1.0), (1, 4)).astype(np.float32),
        "tree_w": np.ones(1, np.float32)}}
    return manifest, arrays


def test_tree_head_falls_back_loudly():
    """No StackSpec for a tree head (the JAX package stacks only the
    linear families): the engine serves it on the classic plane, counts
    fused_fallbacks and records it, with each model's own scores."""
    from transmogrifai_tpu_torch.telemetry import RECORDER
    rng = np.random.default_rng(9)
    irs = [_tree_head_ir(rng, f"out{k}") for k in range(2)]
    RECORDER.clear()
    reg, st, cols, res = _serve_pair(irs, rng)
    for k in range(2):
        assert fusion.stack_spec_of(reg.get(f"m{k}").backend) is None
    assert st["fused_batches"] == 0 and st["fused_fallbacks"] >= 2
    assert st["failed"] == 0
    assert any(e["event"] == "fused_fallback"
               for e in RECORDER.events(subsystem="serving"))
    for k, r in res:
        solo = reg.get(f"m{k}").backend.scorer.score_arrays(cols)
        np.testing.assert_array_equal(r[f"out{k}"], solo[f"out{k}"])


def test_superset_scorer_reuse_indexes_the_stacked_tables(monkeypatch):
    """The engine's scorer cache hands a family's subset a cached
    superset scorer with remapped positions: rows riding under those
    positions get their own model's tables and weights."""
    from transmogrifai_tpu_torch.serving import (EngineConfig,
                                                 ModelRegistry,
                                                 ServingEngine)
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    rng = np.random.default_rng(8)
    reg = ModelRegistry()
    for k in range(3):
        m, a, _par = chip_smoke.make_model_ir(rng, f"out{k}")
        reg.register(f"m{k}", portable.from_portable(m, a, "cpu"),
                     buckets=chip_smoke.BUCKETS)
    eng = ServingEngine(registry=reg, config=EngineConfig(fused_kernel=True))
    members = []
    for k in range(3):
        backend = reg.get(f"m{k}").backend
        members.append((("<f4",), [], f"m{k}", backend,
                        fusion.stack_spec_of(backend)))
    full, pos = eng._fused_scorer(members)
    assert pos == (0, 1, 2)
    sub, pos = eng._fused_scorer([members[0], members[2]])
    assert sub is full and pos == (0, 2)
    cols = _request(rng, 12)
    n, vals = members[0][3].prepare(cols)
    mid = np.array([pos[j % 2] for j in range(n)], np.int32)
    got = sub.finalize(sub.launch(n, vals, mid))
    for j, k in enumerate(mid):
        solo = members[k][3].scorer.score_arrays(cols)[f"out{k}"]
        np.testing.assert_allclose(got[j], solo[j], atol=1e-5)
