"""The port's linear families against the JAX package's on the CPU: each
fit of ``models/linear.py`` on a grid of G >= 2 items (mixed hypers,
each item its own fold weights) against the JAX function run item by
item; each predict on parameters the JAX package fitted, carried over
by ``params_from_numpy``; the reference cases of ``tests/test_models.py``
(Newton budget, fold masking, lasso recovery, elastic alpha 0, softmax
Newton against a long first-order run, GLM gamma and tweedie) on the
port; the Op* stages; and the evaluators against the JAX package's.

Tolerances, and why: both packages run the same f32 program and differ
only in the order of summation (XLA's dot against torch's bmm and
reductions). Newton and closed-form fits land on the same optimum, so
coefficients agree within 1e-5 (measured up to 2.4e-7). The first-order
paths (FISTA 200-300 steps, Nesterov 200) carry the first difference
through every step without growing it (each step contracts): 2e-5
(measured up to 3.6e-7). Multinomial logistic is identified only up to
a shift of each feature's row across the classes (the intercept row is
unpenalized, the 1e-5 Hessian ridge pins it), so its coefficients are
compared after centering each row over the classes, and its
probabilities with the same tolerance as the coefficients (the
first-order path at d = 91 measured 5.6e-6 on a probability). Naive
Bayes is bitwise in practice (held at 1e-6). Predicts on carried-over
parameters agree within 1e-6 (f32 dot products in another order),
evaluators within 1e-6 (f32 sums).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu import models as JM
from transmogrifai_tpu.models import linear as JL
from transmogrifai_tpu_torch import models as TM
from transmogrifai_tpu_torch.models import linear as TL
from transmogrifai_tpu_torch.models.base import (params_from_numpy,
                                                 params_to_numpy)

NEWTON_TOL = 1e-5
FIRST_ORDER_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the suite runs several
    workers at once, and torch's intra-op threads on these small tensors
    only add contention (half the CPU time of the default threads here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _data(seed, n=240, d=6, G=3):
    """Features, a binary label and G fold-weight vectors."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + rng.normal(size=n) > 0).astype(np.float32)
    w = (rng.random((G, n)) < 0.7).astype(np.float32)
    return X, y, w


def _grid(X, y, w):
    G = w.shape[0]
    return (_t(np.broadcast_to(X, (G,) + X.shape)),
            _t(np.broadcast_to(y, (G,) + y.shape)), _t(w))


def _each(jfn, X, y, w, *hypers, static=()):
    """The JAX function item by item (jitted: eager JAX compiles every
    primitive)."""
    fn = jax.jit(jfn, static_argnums=static)
    return np.stack([np.asarray(fn(X, y, w[g], *[h[g] if isinstance(
        h, np.ndarray) else h for h in hypers])) for g in range(w.shape[0])])


REG = np.array([0.001, 0.01, 0.1], np.float32)
ALPHA = np.array([0.5, 0.0, 1.0], np.float32)


# ---------------------------------------------------------------------------
# The shared solvers
# ---------------------------------------------------------------------------

def test_shared_solvers_match_jax():
    """_penalty_mask, _soft_threshold, _power_lipschitz (12 power steps)
    and _fista (on a lasso, 150 steps) on G = 3 items against the JAX
    functions item by item."""
    rng = np.random.default_rng(20)
    assert np.array_equal(TL._penalty_mask(5, "cpu").numpy(),
                          np.asarray(JL._penalty_mask(5)))
    x = rng.normal(size=(3, 7)).astype(np.float32)
    t = np.array([0.1, 0.5, 1.0], np.float32)
    np.testing.assert_array_equal(
        TL._soft_threshold(_t(x), _t(t)[:, None]).numpy(),
        np.stack([np.asarray(JL._soft_threshold(x[g], t[g]))
                  for g in range(3)]))
    Xw = rng.normal(size=(3, 200, 6)).astype(np.float32)
    np.testing.assert_allclose(
        TL._power_lipschitz(_t(Xw)).numpy(),
        [float(jax.jit(JL._power_lipschitz)(Xw[g])) for g in range(3)],
        rtol=1e-5)
    yv = rng.normal(size=(3, 200)).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 1, 0], np.float32)
    lr = np.array([0.01, 0.02, 0.005], np.float32)
    l1 = np.array([0.1, 0.0, 0.5], np.float32)
    Xt, yt = _t(Xw), _t(yv)
    got = TL._fista(lambda b: TL._mtv(Xt, TL._mv(Xt, b) - yt),
                    torch.zeros(3, 6), _t(lr), _t(l1), _t(mask), 150)
    for g in range(3):
        want = jax.jit(lambda X, y, lr, l1: JL._fista(
            lambda b: X.T @ (X @ b - y), jnp.zeros(6), lr, l1,
            jnp.asarray(mask), 150))(Xw[g], yv[g], lr[g], l1[g])
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want),
                                   atol=FIRST_ORDER_TOL)


# ---------------------------------------------------------------------------
# Fits against the JAX functions, G items at once
# ---------------------------------------------------------------------------

def test_fit_logistic_binary_matches_jax():
    X, y, w = _data(0)
    got = TL.fit_logistic_binary(*_grid(X, y, w), _t(REG)).numpy()
    want = _each(JL.fit_logistic_binary, X, y, w, REG)
    np.testing.assert_allclose(got, want, atol=NEWTON_TOL, rtol=NEWTON_TOL)


def test_fit_logistic_elastic_matches_jax():
    X, y, w = _data(1)
    got = TL.fit_logistic_elastic(*_grid(X, y, w), _t(REG),
                                  _t(ALPHA)).numpy()
    want = _each(JL.fit_logistic_elastic, X, y, w, REG, ALPHA)
    np.testing.assert_allclose(got, want, atol=FIRST_ORDER_TOL)


def _multiclass(seed, d, k=3, n=240, G=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(d, k)) * 2.0
    y = np.argmax(X @ W + rng.gumbel(size=(n, k)) * 0.5,
                  axis=1).astype(np.float32)
    w = (rng.random((G, n)) < 0.7).astype(np.float32)
    return X, y, w


def _centered(theta):
    return theta - theta.mean(-1, keepdims=True)


@pytest.mark.parametrize("branch,d", [("newton", 6), ("nesterov", 90)])
def test_fit_softmax_matches_jax(branch, d):
    """Both branches: d*k = 21 <= SOFTMAX_NEWTON_MAX_PARAMS takes Newton,
    91*3 = 273 above it Nesterov."""
    X, y, w = _multiclass(2, d)
    assert ((d + 1) * 3 <= TL.SOFTMAX_NEWTON_MAX_PARAMS) == (branch
                                                              == "newton")
    got = TL.fit_softmax(*_grid(X, y, w), _t(REG), 3).numpy()
    want = _each(JL.fit_softmax, X, y, w, REG, 3, static=(4,))
    tol = NEWTON_TOL if branch == "newton" else FIRST_ORDER_TOL
    np.testing.assert_allclose(_centered(got), _centered(want), atol=tol)
    for g in range(3):
        np.testing.assert_allclose(
            TL.predict_softmax(_t(got[g]), _t(X)).numpy(),
            np.asarray(JL.predict_softmax(want[g], X)), atol=tol)


def test_fit_softmax_elastic_matches_jax():
    X, y, w = _multiclass(3, 6)
    got = TL.fit_softmax_elastic(*_grid(X, y, w), _t(REG), _t(ALPHA),
                                 3).numpy()
    want = _each(JL.fit_softmax_elastic, X, y, w, REG, ALPHA, 3,
                 static=(5,))
    np.testing.assert_allclose(_centered(got), _centered(want),
                               atol=FIRST_ORDER_TOL)


def _regression(seed, n=240, d=6, G=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + 0.5
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    w = (rng.random((G, n)) < 0.7).astype(np.float32)
    return X, y, w


def test_fit_ridge_and_linear_elastic_match_jax():
    X, y, w = _regression(4)
    got = TL.fit_ridge(*_grid(X, y, w), _t(REG)).numpy()
    np.testing.assert_allclose(got, _each(JL.fit_ridge, X, y, w, REG),
                               atol=NEWTON_TOL, rtol=NEWTON_TOL)
    got = TL.fit_linear_elastic(*_grid(X, y, w), _t(REG), _t(ALPHA)).numpy()
    np.testing.assert_allclose(
        got, _each(JL.fit_linear_elastic, X, y, w, REG, ALPHA),
        atol=FIRST_ORDER_TOL)


def test_fit_linear_svc_matches_jax():
    X, y, w = _data(5)
    got = TL.fit_linear_svc(*_grid(X, y, w), _t(REG)).numpy()
    np.testing.assert_allclose(got, _each(JL.fit_linear_svc, X, y, w, REG),
                               atol=FIRST_ORDER_TOL)


@pytest.mark.parametrize("k", [2, 3])
def test_fit_gnb_matches_jax(k):
    X, y, w = (_data(6) if k == 2 else _multiclass(6, 5))
    sm = np.array([1.0, 0.5, 1e-3], np.float32)
    got = TL.fit_gnb(*_grid(X, y, w), _t(sm), k)
    fn = jax.jit(JL.fit_gnb, static_argnums=4)
    for g in range(3):
        want = fn(X, y, w[g], sm[g], k)
        for key in ("mean", "var", "logprior"):
            np.testing.assert_allclose(got[key][g].numpy(),
                                       np.asarray(want[key]), atol=1e-6,
                                       rtol=1e-6)


def _glm_data(seed, n=300, d=3, G=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    mu = np.exp(X @ np.array([0.4, -0.2, 0.1]) + 0.5)
    y = rng.gamma(4.0, mu / 4.0).astype(np.float32)
    w = (rng.random((G, n)) < 0.7).astype(np.float32)
    return X, y, w


@pytest.mark.parametrize("fit", ["fit_poisson", "fit_gamma"])
def test_fit_poisson_gamma_match_jax(fit):
    X, y, w = _glm_data(7)
    got = getattr(TL, fit)(*_grid(X, y, w), _t(REG)).numpy()
    want = _each(getattr(JL, fit), X, y, w, REG)
    np.testing.assert_allclose(got, want, atol=NEWTON_TOL, rtol=NEWTON_TOL)


def test_fit_tweedie_matches_jax():
    X, y, w = _glm_data(8)
    vp = np.array([1.2, 1.5, 1.8], np.float32)
    got = TL.fit_tweedie(*_grid(X, y, w), _t(REG), _t(vp)).numpy()
    want = _each(JL.fit_tweedie, X, y, w, REG, vp)
    np.testing.assert_allclose(got, want, atol=NEWTON_TOL, rtol=NEWTON_TOL)


@pytest.mark.parametrize("links", [[0.0, 1.0, 2.0, 3.0], 1.0, 2.0, 0.0,
                                   3.0])
def test_glm_family_static_and_traced_link_match_jax(links):
    """A list of links is traced (both solvers run, each item selects);
    a float is static (only its family's solver runs). Either way every
    item equals the JAX family's fit with the same kind of link."""
    X, y, _ = _glm_data(9)
    traced = isinstance(links, list)
    G = len(links) if traced else 2
    w = (np.random.default_rng(9).random((G, len(y))) < 0.7
         ).astype(np.float32)
    reg = np.linspace(0.01, 0.1, G).astype(np.float32)
    hyper = {"regParam": _t(reg), "variancePower": 1.5,
             "familyLink": _t(links) if traced else links}
    got = TM.MODEL_FAMILIES["GeneralizedLinearRegression"].fit_batch(
        *_grid(X, y, w), hyper, 1)
    jfam = JM.MODEL_FAMILIES["GeneralizedLinearRegression"]
    for g in range(G):
        link = (jnp.asarray(links[g]) if traced else links)
        want = jax.jit(lambda X, y, w, r, l: jfam.fit_kernel(
            X, y, w, {"regParam": r, "familyLink": l,
                      "variancePower": 1.5}, 1),
            static_argnums=() if traced else (4,))(X, y, w[g], reg[g], link)
        np.testing.assert_allclose(got["beta"][g].numpy(),
                                   np.asarray(want["beta"]),
                                   atol=NEWTON_TOL, rtol=NEWTON_TOL)
        assert float(got["familyLink"][g]) == float(want["familyLink"])


def test_logistic_family_static_alpha_skips_fista():
    """A static elasticNetParam of 0 runs Newton alone; traced, the
    FISTA tail runs as a no-op at alpha 0 and lands on the same
    optimum (test_elastic_alpha_zero_matches_pure_l2's claim, per
    item)."""
    X, y, w = _data(10)
    fam = TM.MODEL_FAMILIES["LogisticRegression"]
    static = fam.fit_batch(*_grid(X, y, w), {"regParam": _t(REG),
                                             "elasticNetParam": 0.0}, 2)
    assert torch.equal(static["beta"],
                       TL.fit_logistic_binary(*_grid(X, y, w), _t(REG)))
    traced = fam.fit_batch(*_grid(X, y, w), {
        "regParam": _t(REG), "elasticNetParam": torch.zeros(3)}, 2)
    np.testing.assert_allclose(traced["beta"].numpy(),
                               static["beta"].numpy(), atol=1e-4)


def test_fit_items_do_not_depend_on_their_batch():
    """An item of a grid fit equals the same item fitted alone, bit for
    bit, on the CPU: the sweep runs the CPU one item a chunk, and this
    pins that the fits hold no cross-item state."""
    X, y, w = _data(11)
    grid = _grid(X, y, w)
    full = TL.fit_logistic_elastic(*grid, _t(REG), _t(ALPHA))
    for g in range(3):
        one = TL.fit_logistic_elastic(*(a[g:g + 1] for a in grid),
                                      _t(REG[g:g + 1]), _t(ALPHA[g:g + 1]))
        np.testing.assert_allclose(one[0].numpy(), full[g].numpy(),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# Predicts on JAX-fitted parameters
# ---------------------------------------------------------------------------

PREDICT_CASES = [
    ("LogisticRegression", 2, {"regParam": 0.01, "elasticNetParam": 0.5}),
    ("LogisticRegression", 3, {"regParam": 0.01, "elasticNetParam": 0.0}),
    ("LinearSVC", 2, {"regParam": 0.01}),
    ("NaiveBayes", 2, {"smoothing": 1.0}),
    ("NaiveBayes", 3, {"smoothing": 0.5}),
    ("LinearRegression", 1, {"regParam": 0.01, "elasticNetParam": 0.5}),
    ("GeneralizedLinearRegression", 1,
     {"regParam": 0.01, "familyLink": 0.0, "variancePower": 1.5}),
    ("GeneralizedLinearRegression", 1,
     {"regParam": 0.01, "familyLink": 2.0, "variancePower": 1.5}),
]


def _case_data(k, seed):
    if k == 3:
        X, y, _ = _multiclass(seed, 5)
    elif k == 2:
        X, y, _ = _data(seed, d=5)
    else:
        X, y, _ = _glm_data(seed, d=3)
    return X, y


@pytest.mark.parametrize("family,k,hyper", PREDICT_CASES)
def test_predict_on_jax_params(family, k, hyper):
    X, y = _case_data(k, 12)
    jfam = JM.MODEL_FAMILIES[family]
    jparams = jax.jit(lambda X, y, w, h: jfam.fit_kernel(X, y, w, h, k))(
        X, y, np.ones(len(y), np.float32),
        {h: jnp.asarray(v, jnp.float32) for h, v in hyper.items()})
    arrays = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(arrays, "cpu")
    got = TM.MODEL_FAMILIES[family].predict_kernel(params, _t(X), k)
    want = np.asarray(jfam.predict_kernel(jparams, jnp.asarray(X), k))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    back = params_to_numpy(params)
    for key, a in arrays.items():
        assert back[key].dtype == np.float32
        np.testing.assert_array_equal(back[key], a.astype(np.float32))


@pytest.mark.parametrize("family,k,hyper", PREDICT_CASES)
def test_predict_rows_are_independent(family, k, hyper):
    """A row scores the same bits alone and inside a batch (what the
    serving engine's exact mode relies on)."""
    X, y = _case_data(k, 13)
    fam = TM.MODEL_FAMILIES[family]
    params = fam.fit_kernel(_t(X), _t(y), torch.ones(len(y)),
                            {h: torch.tensor(v) for h, v in hyper.items()},
                            k)
    full = fam.predict_kernel(params, _t(X), k)
    for i in (0, 7, len(y) - 1):
        assert torch.equal(fam.predict_kernel(params, _t(X[i:i + 1]), k),
                           full[i:i + 1])


# ---------------------------------------------------------------------------
# tests/test_models.py's reference cases, on the port
# ---------------------------------------------------------------------------

def _binary_data(rng, n=400, d=5):
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta = np.arange(1, d + 1, dtype=np.float32) / d
    logits = X @ beta - 0.2
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y


def _one(X, y, w=None):
    w = np.ones(len(y), np.float32) if w is None else w
    return _t(X)[None], _t(y)[None], _t(w)[None]


def test_newton_iteration_budget_converged():
    """The 15-step Newton budget lands on the optimum a 4x budget finds,
    separable data at tiny l2 included (only the penalty bounds |beta|
    there, and the trust region throttles the steps)."""
    rng = np.random.default_rng(0)
    n, d = 400, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    for y, l2 in (((rng.random(n) < 0.5).astype(np.float32), 0.01),
                  ((X[:, 0] > 0).astype(np.float32), 1e-4)):
        fast = TL.fit_logistic_binary(*_one(X, y), l2)
        ref = TL.fit_logistic_binary(*_one(X, y), l2, iters=60)
        np.testing.assert_allclose(fast.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_fold_weight_masking_isolates_folds():
    """Fitting with w = mask equals fitting on the subset: weights ARE
    the fold mechanism."""
    rng = np.random.default_rng(1)
    X, y = _binary_data(rng, n=200)
    mask = (rng.random(200) < 0.7).astype(np.float32)
    masked = TL.fit_logistic_binary(*_one(X, y, mask), 0.01)
    sub = mask > 0.5
    subset = TL.fit_logistic_binary(*_one(X[sub], y[sub]), 0.01)
    np.testing.assert_allclose(masked.numpy(), subset.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_elastic_net_lasso_sparse_recovery():
    rng = np.random.default_rng(2)
    n, d = 400, 10
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta_true = np.zeros(d, np.float32)
    beta_true[0], beta_true[3] = 2.0, -1.5
    y = X @ beta_true + 0.3 + 0.05 * rng.normal(size=n).astype(np.float32)
    b = TL.fit_linear_elastic(*_one(X, y.astype(np.float32)), 0.05,
                              1.0)[0].numpy()
    zero_idx = [i for i in range(d) if beta_true[i] == 0.0]
    assert np.all(b[zero_idx] == 0.0), b[zero_idx]
    assert b[0] > 1.5 and b[3] < -1.0
    assert abs(float(b[d]) - 0.3) < 0.15            # unpenalized intercept


def test_elastic_alpha_zero_matches_pure_l2():
    rng = np.random.default_rng(3)
    X, y = _binary_data(rng, n=250)
    b_newton = TL.fit_logistic_binary(*_one(X, y), 0.05)
    b_elastic = TL.fit_logistic_elastic(*_one(X, y), 0.05, torch.zeros(1))
    np.testing.assert_allclose(b_elastic.numpy(), b_newton.numpy(),
                               rtol=1e-3, atol=1e-4)
    yr = (X @ np.arange(1, X.shape[1] + 1, dtype=np.float32)
          ).astype(np.float32)
    r_closed = TL.fit_ridge(*_one(X, yr), 0.05)
    r_elastic = TL.fit_linear_elastic(*_one(X, yr), 0.05, torch.zeros(1))
    np.testing.assert_allclose(r_elastic.numpy(), r_closed.numpy(),
                               rtol=1e-3, atol=1e-3)


def test_softmax_newton_matches_longrun_first_order(monkeypatch):
    """The small-model Newton path lands on the predictions of an
    exhaustively run Nesterov fit, in the strong-signal tiny-l2 regime
    where the 200-step first-order budget under-converges."""
    rng = np.random.default_rng(4)
    n, d, k = 300, 8, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(d, k)) * 2.0
    y = np.argmax(X @ W + rng.gumbel(size=(n, k)) * 0.3,
                  axis=1).astype(np.float32)
    newt = TL.fit_softmax(*_one(X, y), 1e-4, k)[0]
    monkeypatch.setattr(TL, "SOFTMAX_NEWTON_MAX_PARAMS", 0)
    ref = TL.fit_softmax(*_one(X, y), 1e-4, k, iters=3000)[0]
    np.testing.assert_allclose(TL.predict_softmax(newt, _t(X)).numpy(),
                               TL.predict_softmax(ref, _t(X)).numpy(),
                               atol=5e-4)


def test_glm_gamma_log_link_recovers_coefficients():
    """familyLink=2 fits a gamma GLM with log link: coefficients near
    the generating ones, unlike the gaussian branch, and equal to the
    standalone fit_gamma oracle; predictions positive."""
    rng = np.random.default_rng(5)
    fam = TM.MODEL_FAMILIES["GeneralizedLinearRegression"]
    n, d = 2000, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta_true = np.array([0.5, -0.3, 0.2], np.float32)
    y = rng.gamma(5.0, np.exp(X @ beta_true + 1.0) / 5.0).astype(np.float32)
    w = torch.ones(n)
    params = fam.fit_kernel(_t(X), _t(y), w, {
        "regParam": torch.tensor(1e-4), "familyLink": torch.tensor(2.0)}, 1)
    beta = params["beta"].numpy()
    np.testing.assert_allclose(beta[:d], beta_true, atol=0.08)
    assert abs(beta[-1] - 1.0) < 0.1
    gauss = fam.fit_kernel(_t(X), _t(y), w, {
        "regParam": torch.tensor(1e-4), "familyLink": torch.tensor(0.0)}, 1)
    assert np.max(np.abs(beta - gauss["beta"].numpy())) > 0.1
    oracle = TL.fit_gamma(*_one(X, y), 1e-4)[0].numpy()
    np.testing.assert_allclose(beta, oracle, atol=2e-3)
    pred = fam.predict_kernel(params, _t(X), 1)[:, 0].numpy()
    assert np.all(pred > 0)


def test_glm_tweedie_brackets_poisson_and_gamma():
    rng = np.random.default_rng(6)
    n, d = 1500, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    mu = np.exp(X @ np.array([0.4, -0.2, 0.1], np.float32) + 0.5)
    y = rng.gamma(4.0, mu / 4.0).astype(np.float32)
    tw2 = TL.fit_tweedie(*_one(X, y), 1e-4, 2.0).numpy()
    np.testing.assert_allclose(tw2, TL.fit_gamma(*_one(X, y), 1e-4).numpy(),
                               atol=2e-3)
    tw1 = TL.fit_tweedie(*_one(X, y), 1e-4, 1.0).numpy()
    np.testing.assert_allclose(tw1,
                               TL.fit_poisson(*_one(X, y), 1e-4).numpy(),
                               atol=2e-3)


# ---------------------------------------------------------------------------
# The Op* stages
# ---------------------------------------------------------------------------

STAGES = [("OpLogisticRegression", {"regParam": 0.05}, "binary"),
          ("OpLinearSVC", {"regParam": 0.05}, "binary"),
          ("OpNaiveBayes", {}, "binary"),
          ("OpLinearRegression", {"regParam": 0.05}, "regression"),
          ("OpGeneralizedLinearRegression", {"familyLink": 1.0},
           "regression")]


@pytest.mark.parametrize("stage,hyper,problem", STAGES)
def test_op_stages_fit_like_the_jax_package(stage, hyper, problem):
    from transmogrifai_tpu import Dataset as JD, FeatureBuilder as JFB
    from transmogrifai_tpu.features import types as jft
    from transmogrifai_tpu_torch.dataset import Dataset as TD
    from transmogrifai_tpu_torch.features import FeatureBuilder as TFB
    from transmogrifai_tpu_torch.features import types as tft
    rng = np.random.default_rng(15)
    X = rng.normal(size=(200, 4)).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.normal(size=200) > 0).astype(np.float64)
    if problem == "regression":
        y = np.exp(0.3 * X[:, 0] + 0.1 * rng.normal(size=200))
    out = []
    for D, FB, ft, mods, kw in ((JD, JFB, jft, JM, {}),
                                (TD, TFB, tft, TM, {"device": "cpu"})):
        ds = D({"y": y, "x": X}, {"y": ft.RealNN, "x": ft.OPVector})
        lbl = FB.of(ft.RealNN, "y").from_column().as_response()
        vec = FB.OPVector("x").from_column().as_predictor()
        model = getattr(mods, stage)(**hyper, **kw).set_input(lbl, vec).fit(ds)
        out.append({k: np.asarray(v.detach().cpu() if isinstance(
            v, torch.Tensor) else v) for k, v in model.model_params.items()})
    for key in out[0]:
        np.testing.assert_allclose(out[1][key], out[0][key],
                                   atol=FIRST_ORDER_TOL, rtol=1e-5)


# ---------------------------------------------------------------------------
# Evaluators
# ---------------------------------------------------------------------------

def _eval_ds(pkg, y, probs, problem):
    if pkg == "jax":
        from transmogrifai_tpu.dataset import Dataset
        from transmogrifai_tpu.features import types as ft
        from transmogrifai_tpu.models.base import prediction_column
    else:
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.features import types as ft
        from transmogrifai_tpu_torch.models.base import prediction_column
    return Dataset({"y": y, "p": prediction_column(probs, problem)},
                   {"y": ft.RealNN, "p": ft.Prediction})


def _assert_metrics_close(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_metrics_close(a[k], b[k])
        else:
            np.testing.assert_allclose(np.asarray(b[k], float),
                                       np.asarray(a[k], float), atol=1e-6,
                                       rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["binary", "binary_curves", "multiclass",
                                  "multiclass_unseen", "regression",
                                  "bin_score"])
def test_evaluators_match_jax(kind):
    from transmogrifai_tpu.evaluators import Evaluators as JE
    from transmogrifai_tpu_torch.evaluators import Evaluators as TE
    rng = np.random.default_rng(16)
    n = 300
    if kind.startswith("multiclass"):
        probs = rng.dirichlet(np.ones(3), size=n)
        y = rng.integers(0, 4 if kind.endswith("unseen") else 3,
                         n).astype(np.float64)
        problem, make = "multiclass", "multi_classification"
        kw = {}
    elif kind == "regression":
        y = rng.normal(size=n)
        probs = (y + 0.2 * rng.normal(size=n))[:, None]
        problem, make, kw = "regression", "regression", {}
    else:
        probs = rng.dirichlet(np.ones(2), size=n)
        y = (rng.random(n) < probs[:, 1]).astype(np.float64)
        problem = "binary"
        make = "bin_score" if kind == "bin_score" else "binary_classification"
        kw = {"include_curves": True} if kind == "binary_curves" else {}
    jm = getattr(JE, make)(**kw).evaluate(_eval_ds("jax", y, probs, problem),
                                          "y", "p")
    tkw = dict(kw) if make == "bin_score" else dict(kw, device="cpu")
    tm = getattr(TE, make)(**tkw).evaluate(
        _eval_ds("torch", y, probs, problem), "y", "p")
    _assert_metrics_close(jm, tm)


def test_multiclass_evaluator_includes_threshold_metrics():
    from transmogrifai_tpu_torch.evaluators import Evaluators
    rng = np.random.default_rng(0)
    n, k = 50, 3
    probs = rng.dirichlet(np.ones(k), size=n)
    y = rng.integers(0, k, n).astype(np.float64)
    m = Evaluators.multi_classification(device="cpu").evaluate(
        _eval_ds("torch", y, probs, "multiclass"), "y", "p")
    tm = m["ThresholdMetrics"]
    assert np.asarray(tm["correctCounts"]).shape == (2, 20)
    s = (np.asarray(tm["correctCounts"]) + np.asarray(tm["incorrectCounts"])
         + np.asarray(tm["noPredictionCounts"]))
    np.testing.assert_allclose(s, 1.0, atol=1e-6)


def test_topk_threshold_metrics_unseen_label_counts_incorrect():
    from transmogrifai_tpu_torch.evaluators import functional as F
    out = {k: v.numpy() for k, v in F.multiclass_topk_threshold_metrics(
        torch.tensor([[0.9, 0.1], [0.8, 0.2]]), torch.tensor([0, 2]),
        topns=(1, 2), num_thresholds=2).items()}
    for t in (0, 1):
        assert np.isclose(out["correctCounts"][t, 0], 0.5)
        assert np.isclose(out["incorrectCounts"][t, 0], 0.5)


def test_custom_evaluator():
    from transmogrifai_tpu_torch.evaluators import Evaluators
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(2), size=40)
    y = (rng.random(40) > 0.5).astype(np.float64)
    ds = _eval_ds("torch", y, probs, "binary")
    ev = Evaluators.custom(
        "CostWeightedError",
        lambda yy, preds, pp: float(np.mean((preds != yy) * (1 + yy))),
        larger_is_better=False)
    m = ev.evaluate(ds, "y", "p")
    assert set(m) == {"CostWeightedError"}
    assert ev.default_metric_value(m) == m["CostWeightedError"]
    assert not ev.larger_is_better
    assert Evaluators.custom("A", lambda yy, preds, pp: {
        "A": 1.0, "B": 2.0}).evaluate(ds, "y", "p") == {"A": 1.0, "B": 2.0}
    with pytest.raises(ValueError, match="Missing"):
        Evaluators.custom("Missing", lambda yy, preds, pp: {
            "X": 1.0}).evaluate(ds, "y", "p")


def test_evaluators_default_to_cuda(monkeypatch):
    from transmogrifai_tpu_torch.evaluators import Evaluators
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    probs = np.full((4, 2), 0.5)
    ds = _eval_ds("torch", np.array([0.0, 1.0, 0.0, 1.0]), probs, "binary")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Evaluators.binary_classification().evaluate(ds, "y", "p")
