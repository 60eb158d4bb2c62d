"""The port's FT-Transformer (``models/ft_transformer.py``) against the
JAX package's, on the CPU, at a small size: both families are set to
``d_model`` 16, ``d_ff`` 32 and 20 AdamW steps (their other sizes as
shipped: 4 heads, 2 layers). The same numpy inputs go through both
packages.

* The forward on JAX's initial draw, the loss gradient there (against
  ``jax.grad``) and a whole fit from that draw, in f32.
* The grid axis: two learning rates, and zero-weight fold rows, give
  different fits; an item of a batch equals its fit alone.
* ``TM_FT_BF16=1`` in both packages: the forward and a fit from JAX's
  draw within the bf16 rounding the two place differently, and the
  precision contract itself (which leaves are cast, the dtype entering
  each product, softmax, GELU and norm) read from the port's dispatched
  ops and from the JAX package's jaxpr, with planted faults that break it.
* The regressor's (n, 1) output, bf16 quality against f32,
  ``TM_KERNEL_EXACT=1`` pinning f32.
* The selector takes the family as an opt-in candidate; save/load.
* A workflow saved by either package scores in the other; a portable
  artifact exported by either scores in the other's runtime (the JAX
  package's numpy ``_predict_ft`` included); ``model_contributions``.
* The sweep's out-of-memory retry halves an FT chunk.

The JAX package's own ``tests/test_ft_transformer.py`` is marked
``slow`` as a whole; its behaviours are the cases above, at this size.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import ft_transformer as JFT
from transmogrifai_tpu_torch.models import ft_transformer as TFT
from transmogrifai_tpu_torch.models.base import MODEL_FAMILIES as TMF
from transmogrifai_tpu_torch.models.base import params_to_numpy, tree_map

#: the small size both packages' families are set to
SMALL = {"d_model": 16, "d_ff": 32, "n_steps": 20}
N_HEADS = 4
#: f32 forward on the same parameters: matrix products of <= 32 terms,
#: summed in another order
FWD_ATOL = 1e-5
#: the loss gradient, each leaf against max|g| of that leaf
GRAD_RTOL = 1e-5
#: after SMALL["n_steps"] AdamW steps from the same draw: probabilities
#: absolutely, parameters against max|p| of their leaf (measured on
#: this data: 1.2e-7 and 6.2e-7)
FIT_PROB_ATOL = 1e-5
FIT_PARAM_RTOL = 1e-5
#: a workflow or artifact scored across packages (the fits' own f32
#: rounding stays behind; only the forward differs)
CROSS_ATOL = 1e-5
#: TM_FT_BF16=1 in both packages, on JAX's draw. The two round in other
#: places (XLA keeps some bf16 intermediates in f32 and composes the
#: GELU of several bf16 ops; torch rounds each op's output once), so the
#: forwards differ by bf16 rounding: measured 1.7e-3 (binary) and 2.0e-3
#: (regression) on this data
BF16_FWD_ATOL = 4e-3
#: after SMALL["n_steps"] bf16 AdamW steps from that draw, the rounding
#: differences compound: median |dp| measured 4.8e-4 (binary) and
#: 1.8e-2 (regression), max |dp| of the probabilities 4.9e-2
BF16_FIT_MEDIAN = 4e-2
BF16_FIT_PROB_MAX = 0.1
FAMILIES = {"binary": "FTTransformerClassifier",
            "regression": "FTTransformerRegressor"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs: the suite runs several
    workers at once, and torch's intra-op threads on these small tensors
    only add contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small(monkeypatch):
    from transmogrifai_tpu.models.base import MODEL_FAMILIES as JF
    from transmogrifai_tpu_torch.models.base import MODEL_FAMILIES as TF
    for reg in (JF, TF):
        for name in FAMILIES.values():
            for k, v in SMALL.items():
                monkeypatch.setattr(reg[name], k, v)
    for k in ("TM_FT_BF16", "TM_KERNEL_EXACT", "TM_SWEEP_FUSION"):
        monkeypatch.delenv(k, raising=False)
    yield


def _data(problem, n=96, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if problem == "regression":
        y = X[:, 0] * X[:, 1] + 0.1 * rng.normal(size=n)
    else:
        y = (2.0 * X[:, 0] * X[:, 1] + X[:, 2]
             + 0.3 * rng.normal(size=n) > 0)
    return X, y.astype(np.float32)


def _k(problem):
    return 1 if problem == "regression" else 2


def _jax_draw(problem, d):
    """JAX's initial parameters (PRNGKey(0)) at the small size, numpy."""
    return jax.tree.map(np.asarray, JFT._init_params(
        jax.random.PRNGKey(0), d, SMALL["d_model"], N_HEADS, 2,
        SMALL["d_ff"], _k(problem)))


def _port_net(draw):
    """The draw as the port's (1, ...)-batched tensors, its own layout."""
    fam = TMF["FTTransformerClassifier"]
    d, k = draw["tok_w"].shape[0], draw["head_w"].shape[1]
    return tree_map(lambda a: a[None], fam.init_params(
        d, 1 if k == 1 else k, init=draw))


def _max_rel(a, b):
    """max over leaves of max|a - b| / max|b| (pytrees of numpy)."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    return max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
               for x, y in zip(la, lb))


@pytest.mark.parametrize("problem", sorted(FAMILIES))
def test_forward_matches_jax_on_its_draws(problem):
    X, _ = _data(problem)
    draw = _jax_draw(problem, X.shape[1])
    want = np.asarray(jax.jit(lambda p, x: JFT._forward(p, x, N_HEADS))(
        draw, X))
    got = TFT._forward(_port_net(draw), torch.as_tensor(X)[None],
                       N_HEADS)[0].numpy()
    assert got.shape == want.shape == (len(X), _k(problem))
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def _jax_loss(p, Xs, y, wn, k_out):
    out = JFT._forward(p, Xs, N_HEADS)
    if k_out == 1:
        return jnp.sum(wn * (out[:, 0] - y) ** 2)
    logp = jax.nn.log_softmax(out, axis=-1)
    return -jnp.sum(wn * jnp.take_along_axis(
        logp, y.astype(jnp.int32)[:, None], axis=1)[:, 0])


@pytest.mark.parametrize("problem", sorted(FAMILIES))
def test_loss_gradient_matches_jax_grad(problem):
    X, y = _data(problem)
    draw = _jax_draw(problem, X.shape[1])
    w = np.random.default_rng(3).random(len(y)).astype(np.float32)
    wn = w / w.sum()
    k_out = _k(problem)
    want = jax.jit(jax.grad(_jax_loss), static_argnums=4)(
        draw, X, y, wn, k_out)
    net = tree_map(lambda a: a.clone().requires_grad_(), _port_net(draw))
    yt = torch.as_tensor(y)[None]
    target = yt if k_out == 1 else yt.to(torch.int64)[..., None]
    loss = TFT._loss(net, torch.as_tensor(X)[None], target,
                     torch.as_tensor(wn)[None], N_HEADS)
    leaves = [t for t in jax.tree.leaves(net)]
    grads = torch.autograd.grad(loss, leaves)
    got = jax.tree.unflatten(jax.tree.structure(net),
                             [g[0].numpy() for g in grads])
    assert _max_rel(got, jax.tree.map(np.asarray, want)) <= GRAD_RTOL


def _jax_fit(problem):
    """(X, y, JAX fitted params, JAX predictions) at the small size with
    the default hypers, jitted (traced now, under this TM_FT_BF16)."""
    from transmogrifai_tpu.models.base import MODEL_FAMILIES
    fam = type(MODEL_FAMILIES[FAMILIES[problem]])()
    for k, v in SMALL.items():
        setattr(fam, k, v)
    X, y = _data(problem)
    hyper = {k: jnp.float32(v) for k, v in fam.default_hyper.items()}
    k_out = _k(problem)

    def fit(X, y, w):
        p = fam.fit_kernel(X, y, w, hyper, k_out)
        return p, fam.predict_kernel(p, X, k_out)

    p, pred = jax.jit(fit)(X, y, np.ones(len(y), np.float32))
    return X, y, jax.tree.map(np.asarray, p), np.asarray(pred)


def _port_fit(problem, X, y):
    """The port's fit of :func:`_jax_fit` from JAX's draw: (params,
    predictions)."""
    fam = TFT.FTTransformerClassifierFamily() if problem == "binary" \
        else TFT.FTTransformerRegressorFamily()
    for k, v in SMALL.items():
        setattr(fam, k, v)
    draw = _jax_draw(problem, X.shape[1])
    tp = fam.fit_kernel(torch.as_tensor(X), torch.as_tensor(y),
                        torch.ones(len(y)), fam.default_hyper, _k(problem),
                        init=draw)
    return tp, fam.predict_kernel(tp, torch.as_tensor(X),
                                  _k(problem)).numpy()


@pytest.fixture(scope="module")
def jax_fits():
    """{problem: :func:`_jax_fit`} in f32."""
    return {problem: _jax_fit(problem) for problem in FAMILIES}


@pytest.mark.parametrize("problem", sorted(FAMILIES))
def test_fit_matches_jax_from_its_init(problem, jax_fits):
    X, y, jp, jpred = jax_fits[problem]
    tp, pred = _port_fit(problem, X, y)
    assert pred.shape == jpred.shape
    np.testing.assert_allclose(pred, jpred, rtol=0, atol=FIT_PROB_ATOL)
    assert _max_rel(params_to_numpy(tp), jp) <= FIT_PARAM_RTOL


@pytest.mark.parametrize("problem", sorted(FAMILIES))
def test_bf16_forward_and_fit_match_jax(problem, monkeypatch):
    """TM_FT_BF16=1 in both packages: the forward on JAX's draw and a
    fit from it, within the bf16 rounding that the two packages place
    differently. A cast fault moves these numbers by one more bf16
    rounding, no more than that difference, so the precision contract
    itself is held by :func:`test_bf16_precision_flow_matches_jax`."""
    monkeypatch.setenv("TM_FT_BF16", "1")
    X, y, _jp, jpred = _jax_fit(problem)
    draw = _jax_draw(problem, X.shape[1])
    want = np.asarray(jax.jit(lambda p, x: JFT._forward(p, x, N_HEADS))(
        draw, X))
    got = TFT._forward(_port_net(draw), torch.as_tensor(X)[None],
                       N_HEADS)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_FWD_ATOL)
    _tp, pred = _port_fit(problem, X, y)
    dp = np.abs(pred - jpred)
    assert np.median(dp) <= BF16_FIT_MEDIAN, np.median(dp)
    if problem == "binary":
        assert dp.max() <= BF16_FIT_PROB_MAX, dp.max()


class _PortFlow(TorchDispatchMode):
    """Records, for one forward, the leaves cast to bf16 (by path) and
    the dtypes that enter each matrix product, softmax, GELU and layer
    norm, in order."""
    KINDS = {"bmm": "matmul", "mm": "matmul", "_softmax": "softmax",
             "gelu": "gelu", "native_layer_norm": "norm"}

    def __init__(self, leaves):
        super().__init__()
        self.leaves, self.cast, self.ops = leaves, set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name == "_to_copy" and kwargs.get("dtype") == torch.bfloat16:
            self.cast |= {p for p, t in self.leaves if args[0] is t}
        elif name in self.KINDS:
            n_in = 2 if self.KINDS[name] == "matmul" else 1
            self.ops.append((self.KINDS[name], tuple(
                str(a.dtype).replace("torch.", "") for a in args[:n_in])))
        return func(*args, **kwargs)


def _jax_flow(draw, X):
    """:class:`_PortFlow`'s record for the JAX package's ``_forward``,
    read from its jaxpr: casts of the inputs to bf16, and the operand
    dtypes of each dot_general, softmax (its exp), GELU (its tanh) and
    layer norm (its ``var``)."""
    flat = jax.tree_util.tree_flatten_with_path(({"net": draw}, X))[0]
    closed = jax.make_jaxpr(lambda p, x: JFT._forward(p["net"], x,
                                                      N_HEADS))(
        {"net": draw}, X)
    names = {v: jax.tree_util.keystr(p)
             for v, (p, _) in zip(closed.jaxpr.invars, flat)}
    cast, ops = set(), []

    def walk(jaxpr):
        for e in jaxpr.eqns:
            prim = e.primitive.name
            dts = tuple(str(v.aval.dtype) for v in e.invars)
            if prim == "convert_element_type" and e.invars[0] in names \
                    and e.params["new_dtype"] == jnp.bfloat16:
                cast.add(names[e.invars[0]])
            elif prim == "dot_general":
                ops.append(("matmul", dts[:2]))
            elif prim == "exp":
                ops.append(("softmax", dts[:1]))
            elif prim == "tanh":
                ops.append(("gelu", dts[:1]))
            elif "var" in str(e.params.get("name", "")):
                ops.append(("norm", dts[:1]))
            else:
                for v in e.params.values():
                    if hasattr(v, "jaxpr"):
                        walk(v.jaxpr)

    walk(closed.jaxpr)
    return cast, ops


def _plant(fault, monkeypatch):
    """Break one clause of the port's precision contract."""
    bf = torch.bfloat16
    if fault == "softmax_bf16":
        real_softmax = torch.softmax
        monkeypatch.setattr(torch, "softmax", lambda x, dim: real_softmax(
            x.to(bf), dim=dim))
    elif fault == "head_bf16":
        real_bmm = torch.bmm
        monkeypatch.setattr(torch, "bmm", lambda a, b: real_bmm(
            a.to(bf), b.to(bf)).to(a.dtype) if a.dtype == torch.float32
            else real_bmm(a, b))
    elif fault == "norm_params_cast":
        real_ln = TFT._layer_norm
        monkeypatch.setattr(TFT, "_layer_norm", lambda x, ln: real_ln(
            x, {k: v.to(bf) for k, v in ln.items()}))


@pytest.mark.parametrize("fault", [None, "softmax_bf16", "head_bf16",
                                   "norm_params_cast"])
def test_bf16_precision_flow_matches_jax(fault, monkeypatch):
    """Under TM_FT_BF16=1 the port casts exactly the leaves the JAX
    package casts (tokenizer, CLS, each layer's projections and feed-
    forward, the features), and every product, softmax, GELU and norm
    sees the JAX package's dtypes in the same order: logits, softmax,
    norms and head in f32. Each planted fault breaks the match."""
    monkeypatch.setenv("TM_FT_BF16", "1")
    X, _ = _data("binary", n=8)
    draw = _jax_draw("binary", X.shape[1])
    net, Xt = _port_net(draw), torch.as_tensor(X)[None]
    leaves = [(jax.tree_util.keystr(p), t) for p, t in
              jax.tree_util.tree_flatten_with_path(({"net": net}, Xt))[0]]
    _plant(fault, monkeypatch)
    with _PortFlow(leaves) as flow:
        TFT._forward(net, Xt, N_HEADS)
    want = _jax_flow(draw, X)
    assert len(want[0]) == 8 * 2 + 3 + 1 and ("matmul", (
        "float32", "float32")) == want[1][-1]
    if fault is None:
        assert (flow.cast, flow.ops) == want
    else:
        assert (flow.cast, flow.ops) != want


def test_grid_items_differ_by_learning_rate_and_fold_weights():
    """One fit_batch over four items: two learning rates, and one of
    them again with a zero-weight fold; every item is a different fit,
    and each equals its own fit alone."""
    fam = TMF["FTTransformerClassifier"]
    X, y = _data("binary")
    n = len(y)
    fold = np.ones(n, np.float32)
    fold[: n // 3] = 0.0
    w = torch.as_tensor(np.stack([np.ones(n, np.float32)] * 2
                                 + [fold] * 2))
    lr = torch.tensor([1e-3, 1e-2, 1e-3, 1e-2])
    hyper = {"learningRate": lr, "weightDecay": torch.full((4,), 1e-4)}
    Xt = torch.as_tensor(X).expand(4, -1, -1)
    yt = torch.as_tensor(y).expand(4, -1)
    params = fam.fit_batch(Xt, yt, w, hyper, 2)
    probs = [fam.predict_kernel(tree_map(lambda a: a[j], params),
                                torch.as_tensor(X), 2)[:, 1].numpy()
             for j in range(4)]
    for a in range(4):
        for b in range(a + 1, 4):
            assert not np.allclose(probs[a], probs[b], atol=1e-4), (a, b)
    for j in (0, 3):
        alone = fam.fit_kernel(torch.as_tensor(X), torch.as_tensor(y), w[j],
                               {"learningRate": float(lr[j]),
                                "weightDecay": 1e-4}, 2)
        p = fam.predict_kernel(alone, torch.as_tensor(X), 2)[:, 1].numpy()
        np.testing.assert_allclose(p, probs[j], rtol=0, atol=1e-6)


def test_regressor_outputs_one_column_and_learns():
    fam = TMF["FTTransformerRegressor"]
    X, y = _data("regression", n=300)
    params = fam.fit_kernel(torch.as_tensor(X), torch.as_tensor(y),
                            torch.ones(len(y)), fam.default_hyper, 1)
    pred = fam.predict_kernel(params, torch.as_tensor(X), 1).numpy()
    assert pred.shape == (len(y), 1)
    fam.n_steps = 200
    params = fam.fit_kernel(torch.as_tensor(X), torch.as_tensor(y),
                            torch.ones(len(y)), fam.default_hyper, 1)
    pred = fam.predict_kernel(params, torch.as_tensor(X), 1).numpy()[:, 0]
    r2 = 1 - ((pred - y) ** 2).sum() / ((y - y.mean()) ** 2).sum()
    assert r2 > 0.5, r2         # linear R^2 on x0 * x1 is ~0


def test_bf16_compute_quality(monkeypatch):
    """TM_FT_BF16=1 runs the matrix products in bf16 (norms, softmax,
    head and loss stay f32); the fit stays predictive and close to the
    f32 fit's accuracy (the JAX package's test_ft_bf16_compute_quality)."""
    fam = TMF["FTTransformerClassifier"]
    monkeypatch.setattr(fam, "n_steps", 80)
    rng = np.random.default_rng(1)
    n, d = 300, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    logit = 2.0 * X[:, 0] - X[:, 1]
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)

    def acc(flag):
        monkeypatch.setenv("TM_FT_BF16", flag)
        p = fam.fit_kernel(torch.as_tensor(X), torch.as_tensor(y),
                           torch.ones(n), fam.default_hyper, 2)
        probs = fam.predict_kernel(p, torch.as_tensor(X), 2).numpy()
        return float(np.mean((probs[:, 1] > 0.5) == (y > 0.5)))

    a32, a16 = acc("0"), acc("1")
    assert a16 > 0.8
    assert abs(a16 - a32) < 0.08


def test_compute_dtype_knobs(monkeypatch):
    assert TFT.ft_dtype("cpu") == torch.float32
    assert TFT.ft_dtype("cuda") == torch.bfloat16
    monkeypatch.setenv("TM_FT_BF16", "1")
    assert TFT.ft_dtype("cpu") == torch.bfloat16
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    assert TFT.ft_dtype("cpu") == TFT.ft_dtype("cuda") == torch.float32
    monkeypatch.setenv("TM_FT_BF16", "0")
    monkeypatch.delenv("TM_KERNEL_EXACT")
    assert TFT.ft_dtype("cuda") == torch.float32
    # under exact mode a bf16-flagged fit equals the f32 one bitwise
    fam = TMF["FTTransformerClassifier"]
    X, y = _data("binary")

    def probs():
        p = fam.fit_kernel(torch.as_tensor(X), torch.as_tensor(y),
                           torch.ones(len(y)), fam.default_hyper, 2)
        return fam.predict_kernel(p, torch.as_tensor(X), 2).numpy()

    ref = probs()
    monkeypatch.setenv("TM_FT_BF16", "1")
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    assert np.array_equal(probs(), ref)


def test_init_is_checked_and_defaults_to_a_seeded_draw():
    fam = TMF["FTTransformerClassifier"]
    a, b = fam.init_params(5, 2), fam.init_params(5, 2)
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    draw = _jax_draw("binary", 5)
    mine = params_to_numpy(a)
    assert jax.tree.structure(mine) == jax.tree.structure(draw)
    for x, y in zip(jax.tree.leaves(mine), jax.tree.leaves(draw)):
        assert x.shape == y.shape
        assert x.std() == pytest.approx(y.std(), rel=0.5, abs=1e-6)
    draw["layers"][1]["wq"] = draw["layers"][1]["wq"][:, :8]
    with pytest.raises(ValueError, match="wq"):
        fam.init_params(5, 2, init=draw)


# -- the front door ----------------------------------------------------------

def _vector_ds(pkg, X, y):
    import importlib
    root = importlib.import_module(pkg)
    ft = root.features.types
    ds = root.Dataset({"v": X.astype(np.float32),
                       "label": y.astype(np.float64)},
                      {"v": ft.OPVector, "label": ft.RealNN})
    label = root.FeatureBuilder.of(ft.RealNN, "label").from_column() \
        .as_response()
    vec = root.FeatureBuilder.of(ft.OPVector, "v").from_column() \
        .as_predictor()
    return ds, label, vec


def _p1(model, ds, name):
    return np.asarray([r["probability_1"] for r in
                       model.score(ds).column(name)])


def test_selector_takes_ft_as_an_opt_in_candidate(tmp_path):
    from transmogrifai_tpu_torch.models import (
        BinaryClassificationModelSelector, ModelSelector)
    from transmogrifai_tpu_torch.workflow import Workflow, WorkflowModel
    assert "FTTransformerClassifier" not in \
        ModelSelector.default_candidates("binary")
    X, y = _data("binary")
    ds, label, vec = _vector_ds("transmogrifai_tpu_torch", X, y)
    pred = BinaryClassificationModelSelector.with_train_validation_split(
        candidates=[["FTTransformerClassifier",
                     {"learningRate": [3e-3, 1e-2], "weightDecay": [1e-4]}]]
    ).set_input(label, vec).output
    model = Workflow([pred]).train(ds, device="cpu")
    summ = model.selected_model().summary
    assert summ["bestModel"]["family"] == "FTTransformerClassifier"
    assert len(summ["validationResults"][0]["gridMetrics"]) == 2
    p1 = _p1(model, ds, pred.name)
    model.save(str(tmp_path / "m"))
    again = WorkflowModel.load(str(tmp_path / "m"), device="cpu")
    assert np.array_equal(_p1(again, ds, pred.name), p1)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{pkg: (saved dir, prediction name, its scores)}: the same
    OpFTTransformerClassifier workflow trained and saved by each
    package (the module's small size set on both families)."""
    from transmogrifai_tpu.models.base import MODEL_FAMILIES as JF
    from transmogrifai_tpu_torch.models.base import MODEL_FAMILIES as TF
    import importlib
    old = {}
    for reg in (JF, TF):
        for k, v in SMALL.items():
            old[(id(reg), k)] = getattr(reg["FTTransformerClassifier"], k)
            setattr(reg["FTTransformerClassifier"], k, v)
    X, y = _data("binary")
    out = {}
    try:
        for pkg in ("transmogrifai_tpu", "transmogrifai_tpu_torch"):
            models = importlib.import_module(f"{pkg}.models")
            workflow = importlib.import_module(f"{pkg}.workflow")
            ds, label, vec = _vector_ds(pkg, X, y)
            pred = models.OpFTTransformerClassifier().set_input(
                label, vec).output
            kw = {"device": "cpu"} if pkg.endswith("torch") else {}
            model = workflow.Workflow([pred]).train(ds, **kw)
            path = str(tmp_path_factory.mktemp(pkg) / "model")
            model.save(path)
            out[pkg] = (path, pred.name, _p1(model, ds, pred.name), model)
    finally:
        for reg in (JF, TF):
            for k in SMALL:
                setattr(reg["FTTransformerClassifier"], k,
                        old[(id(reg), k)])
    return X, y, out


@pytest.mark.parametrize("src,dst", [
    ("transmogrifai_tpu", "transmogrifai_tpu_torch"),
    ("transmogrifai_tpu_torch", "transmogrifai_tpu")],
    ids=["jax_saved_on_port", "port_saved_on_jax"])
def test_saved_workflow_scores_in_the_other_package(saved, src, dst):
    import importlib
    X, y, out = saved
    path, name, want = out[src][:3]
    wf = importlib.import_module(f"{dst}.workflow")
    kw = {"device": "cpu"} if dst.endswith("torch") else {}
    model = wf.WorkflowModel.load(path, **kw)
    ds, _, _ = _vector_ds(dst, X, y)
    np.testing.assert_allclose(_p1(model, ds, name), want, rtol=0,
                               atol=CROSS_ATOL)


@pytest.mark.parametrize("src", ["transmogrifai_tpu",
                                 "transmogrifai_tpu_torch"],
                         ids=["jax_export", "port_export"])
def test_portable_artifact_scores_in_both_runtimes(saved, src, tmp_path):
    """An FT artifact exported by ``src`` loads and scores in the port
    (``portable.load`` -> ``compile_scoring``) and in the JAX package's
    numpy runtime (``_predict_ft``); its params.npz keeps the layer
    list, and the port refuses a head count its family does not run."""
    from transmogrifai_tpu import portable as jportable
    from transmogrifai_tpu_torch import portable as tportable
    X, y, out = saved
    _path, name, want, model = out[src]
    art = str(tmp_path / "art")
    model.export_portable(art)
    manifest = json.load(open(os.path.join(art, "manifest.json")))
    assert manifest["stages"][-1]["nHeads"] == N_HEADS
    keys = set(np.load(os.path.join(art, "params.npz")).files)
    assert any("/net/layers/1/wq" in k for k in keys), sorted(keys)[:5]
    cols = {"v": X}
    got_np = np.asarray(jportable.load(art).score_columns(cols)[name])
    pm = tportable.load(art, device="cpu")
    assert pm.stages[-1].family.name == "FTTransformerClassifier"
    got_port = np.asarray(pm.compile_scoring().score_arrays(cols)[name])
    for got in (got_np, got_port):
        p1 = got[:, 1] if got.ndim == 2 else got
        np.testing.assert_allclose(p1, want, rtol=0, atol=CROSS_ATOL)
    # an artifact whose head count is not the family's is refused
    head = dict(manifest["stages"][-1], nHeads=2)
    with pytest.raises(ValueError, match="nHeads=2"):
        tportable.from_portable(
            dict(manifest, stages=manifest["stages"][:-1] + [head]),
            pm.arrays, "cpu")


def test_model_contributions_on_ft(saved):
    from transmogrifai_tpu.insights import model_contributions as jmc
    from transmogrifai_tpu_torch.insights import model_contributions as tmc
    X, _y, out = saved
    tmodel = out["transmogrifai_tpu_torch"][3].stages[-1]
    jmodel = out["transmogrifai_tpu"][3].stages[-1]
    c = tmc(tmodel)
    assert c.shape == (X.shape[1],) and np.all(c >= 0)
    np.testing.assert_allclose(
        c, np.linalg.norm(params_to_numpy(tmodel.model_params)["net"]
                          ["tok_w"], axis=1), rtol=1e-6)
    assert jmc(jmodel).shape == c.shape


def test_sweep_out_of_memory_halves_an_ft_chunk(monkeypatch):
    """A CUDA out-of-memory in the first FT chunk re-runs the sweep in
    chunks of half the items; every item then equals the sweep that ran
    at that chunk from the start."""
    from transmogrifai_tpu_torch.models import tuning as TTU
    fam = TMF["FTTransformerClassifier"]
    X, y = _data("binary")
    w = np.ones(len(y), np.float32)
    grid = fam.make_grid({"learningRate": [1e-3, 1e-2],
                          "weightDecay": [1e-4]})
    cv = TTU.OpCrossValidation(n_folds=2, metric="auroc")

    def sweep():
        return cv.collect(cv.dispatch_many([("ft", fam, grid)], X, y, w, 2,
                                           device="cpu")["ft"]).grid_metrics

    monkeypatch.setitem(TTU.SWEEP_CHUNK, "cpu", 2)
    ref = sweep()
    monkeypatch.setitem(TTU.SWEEP_CHUNK, "cpu", 4)
    real = type(fam).fit_batch
    sizes = []

    def flaky(self, X, y, w, hyper, n_classes, init=None):
        sizes.append(X.shape[0])
        if X.shape[0] > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(self, X, y, w, hyper, n_classes, init=init)

    monkeypatch.setattr(type(fam), "fit_batch", flaky)
    got = sweep()
    assert sizes == [4, 2, 2]
    np.testing.assert_array_equal(got, ref)
