"""Linear model families: logistic, linear/ridge, SVC, naive Bayes, GLM.

Counterpart of ``transmogrifai_tpu/models/linear.py`` (reference:
OpLogisticRegression, OpLinearSVC, OpNaiveBayes, OpLinearRegression,
OpGeneralizedLinearRegression). The fits are the JAX package's
fixed-iteration solvers: binary logistic and the GLMs by damped Newton
(IRLS), multinomial logistic by Newton below
``SOFTMAX_NEWTON_MAX_PARAMS`` flattened parameters and Nesterov above,
the elastic-net paths by FISTA from a smooth warm start, LinearSVC by
Nesterov on the squared hinge, ridge and naive Bayes in closed form.
Weighted everywhere: a CV fold is a 0/1 weight vector.

**The grid axis.** Where the JAX package vmaps one fit over a (fold x
hyper) batch, every fit here takes an explicit leading axis G on every
tensor: X (G, n, d), y and w (G, n), and each hyper either a (G,)
tensor (traced: every item computes the same program) or a Python
float (static: the float picks the branch, as a concrete value does at
JAX trace time — ``elasticNetParam == 0`` skips the FISTA tail, a GLM
link runs only its own solver). Each ``lax.scan`` is a Python loop of
the same fixed length; every product is a batched ``bmm`` and every
positive-definite solve a batched Cholesky factor and two triangular
solves. Nothing here reads a tensor on the host, so a fit on the card
never waits for it (a Python branch on a tensor, ``.item()`` or
``torch.linalg.solve``'s error check would). The products are meant in
f32: TF32 matmuls (off by default in torch) would move the fits.

**Rows sharded over a data mesh.** Inside ``parallel.spmd.run_ranks``
(a 2-D grid x data sweep) each rank fits on its own rows, and every
reduction over rows is a per-rank partial summed over the ranks by
``spmd.row_sum`` (the CUDA ring on the card): ``_mtv``, ``_gram``,
``_sum_w`` and so ``_power_lipschitz``; a Newton or IRLS step packs its
gradient's and its Hessian's partials into one exchange. ``_mv`` is
row-local. Outside ``run_ranks`` the sums are the partials themselves,
so the one-device fits are unchanged to the bit. The JAX package gets
these sums from GSPMD.

**Predicts.** ``predict_kernel`` (one fitted model: the selector's
refit, the ModelStage wrappers, the serving chain) is row-independent
to the bit: a row scores the same alone or inside any padded, coalesced
batch, which is what lets the engine's exact mode promise that a fused
launch scores each row bitwise like its own model's scorer. Two torch
idioms would break that, so they are avoided: a GEMM chooses its
blocking by shape (the affine map is an elementwise product and a sum
over features instead, :func:`affine`), and the CPU's elementwise
``sigmoid`` takes a SIMD path for whole vector blocks and a scalar path
for the tail, which round differently (the binary head is a two-way
softmax over ``[0, z]`` instead, :func:`sigmoid_pair`, computed per
row). The validation sweep scores each fitted item through it too.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..parallel.spmd import row_sum
from ..telemetry.spans import TRACER
from .base import ModelFamily

_JITTER = 1e-5

Hyper = Union[float, torch.Tensor]


# ---------------------------------------------------------------------------
# Batched building blocks
# ---------------------------------------------------------------------------

def add_intercept(X: torch.Tensor) -> torch.Tensor:
    """Append a column of ones: (..., n, d) -> (..., n, d+1)."""
    return torch.cat([X, torch.ones(X.shape[:-1] + (1,), dtype=X.dtype,
                                    device=X.device)], dim=-1)


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ v per item: (G, n, d), (G, d) -> (G, n)."""
    return torch.bmm(A, v.unsqueeze(-1)).squeeze(-1)


def _mtv_part(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """This rank's A^T @ v per item: (G, n, d), (G, n) -> (G, d)."""
    return torch.bmm(A.transpose(1, 2), v.unsqueeze(-1)).squeeze(-1)


def _mtv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A^T @ v per item over every row: (G, n, d), (G, n) -> (G, d)."""
    return row_sum(_mtv_part(A, v))[0]


def _col(h: Hyper, ndim: int) -> Hyper:
    """A hyper as a broadcastable column: a (G,) tensor becomes
    (G, 1, ...) of ``ndim`` dims; a Python float stays a float."""
    if isinstance(h, torch.Tensor):
        return h.reshape((-1,) + (1,) * (ndim - 1))
    return float(h)


def _sum_w(w: torch.Tensor) -> torch.Tensor:
    """max(sum w, 1) per item over every row -> (G,)."""
    return torch.clamp(row_sum(w.sum(1))[0], min=1.0)


def _penalty_mask(d: int, device) -> torch.Tensor:
    """No L2 on the intercept (last column, added by the kernels). Built
    by a comparison, not an item write: writing a Python scalar into a
    card tensor copies it from the host and waits."""
    return (torch.arange(d, device=device) < d - 1).to(torch.float32)


#: rows of one partial Gram (see :func:`_gram_part`)
GRAM_BLOCK = 1024


def _gram(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^T B per item over every row (see :func:`_gram_part`)."""
    return row_sum(_gram_part(A, B))[0]


def _gram_part(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """This rank's A^T B per item: (G, n, d), (G, n, e) -> (G, d, e).
    Over many rows the product is a sum of partial Grams of GRAM_BLOCK
    rows each (zero rows pad the last block): one (G, d, e) product over
    n rows leaves one tile a item for the card's 132 SMs, each walking
    all n rows. The split depends only on n, so an item's result does
    not depend on its batch."""
    G, n, d = A.shape
    if n < 8 * GRAM_BLOCK:
        return torch.bmm(A.transpose(1, 2), B)
    pad = (-n) % GRAM_BLOCK
    if pad:
        A = torch.cat([A, A.new_zeros((G, pad, d))], dim=1)
        B = torch.cat([B, B.new_zeros((G, pad, B.shape[2]))], dim=1)
    P = (n + pad) // GRAM_BLOCK
    part = torch.bmm(A.reshape(G * P, GRAM_BLOCK, d).transpose(1, 2),
                     B.reshape(G * P, GRAM_BLOCK, B.shape[2]))
    return part.reshape(G, P, d, B.shape[2]).sum(1)


def _eye(d: int, device) -> torch.Tensor:
    return torch.eye(d, dtype=torch.float32, device=device)


def _solve_pos(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """H^-1 g for symmetric positive-definite H (G, d, d), g (G, d): a
    Cholesky solve, as ``jax.scipy.linalg.solve(assume_a="pos")``.
    ``cholesky_ex`` and the triangular solves check no error flag, so
    the host never waits on them."""
    L = torch.linalg.cholesky_ex(H).L
    z = torch.linalg.solve_triangular(L, g.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.transpose(1, 2), z,
                                         upper=True).squeeze(-1)


def _damp(delta: torch.Tensor) -> torch.Tensor:
    """Trust-region damping: cap each item's step norm at 10."""
    flat = delta.reshape(delta.shape[0], -1)
    nrm = torch.linalg.vector_norm(flat, dim=1)
    scale = torch.clamp(10.0 / torch.clamp(nrm, min=1e-12), max=1.0)
    return delta * scale.reshape((-1,) + (1,) * (delta.dim() - 1))


def _power_lipschitz(Xw: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Largest eigenvalue of X^T X per item via power iteration (for the
    gradient steps' size): (G, n, d) -> (G,)."""
    G, _, d = Xw.shape
    v = torch.full((G, d), float(np.float32(1.0) / np.sqrt(np.float32(d))),
                   dtype=Xw.dtype, device=Xw.device)
    with TRACER.region("linear.solve", solver="power", iters=iters):
        for _ in range(iters):
            with TRACER.region("linear.iter"):
                u = _mtv(Xw, _mv(Xw, v))
                v = u / torch.clamp(torch.linalg.vector_norm(
                    u, dim=1, keepdim=True), min=1e-12)
        return torch.clamp((v * _mtv(Xw, _mv(Xw, v))).sum(1), min=1e-8)


def _soft_threshold(x: torch.Tensor, t) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def _fista(grad_smooth, x0: torch.Tensor, lr: torch.Tensor, l1: Hyper,
           mask: torch.Tensor, iters: int) -> torch.Tensor:
    """Accelerated proximal gradient (FISTA) with L1 soft-thresholding:
    min_x f(x) + l1 * ||mask * x||_1, grad_smooth the gradient of f.
    x0 (G, ...), lr (G,), l1 (G,) or a float; a fixed iteration count.
    The momentum sequence t_k is data-independent, so it is computed on
    the host in f32 (the JAX package's scan carries it in f32 too).

    Budget (measured by the JAX package): the 200 default is a floor —
    on a strongly correlated design 200 iterations still leave spurious
    support coordinates; do not trim it for throughput."""
    nd = x0.dim()
    thr = _col(lr, nd) * _col(l1, nd)
    keep = mask > 0

    def prox(v):
        return torch.where(keep, _soft_threshold(v, thr), v)

    lr_c = _col(lr, nd)
    x_prev, z = x0, x0
    t = np.float32(1.0)
    with TRACER.region("linear.solve", solver="fista", iters=iters):
        for _ in range(iters):
            with TRACER.region("linear.iter"):
                x = prox(z - lr_c * grad_smooth(z))
                t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
                    np.float32(1.0) + np.float32(4.0) * t * t))
                z = x + float((t - np.float32(1.0)) / t_new) * (x - x_prev)
                x_prev, t = x, t_new
    return x_prev


def _static_zero(v) -> bool:
    """True iff v is a Python number equal to 0 (a static hyper): the
    no-elastic-net path then keeps the pure Newton/closed-form solver."""
    return isinstance(v, (int, float)) and float(v) == 0.0


def _l1_l2(reg: Hyper, alpha: Hyper):
    return reg * alpha, reg * (1.0 - alpha)


def _sqrt_w(w: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(w / sw[:, None])[..., None]


# ---------------------------------------------------------------------------
# Binary logistic regression — damped Newton / IRLS
# ---------------------------------------------------------------------------

#: the logistic Newton budget (the JAX package measured 15 sufficient,
#: separable data at l2=1e-4 included)
LOGISTIC_NEWTON_ITERS = 15


def _newton_logistic(Xb, y, w, l2: Hyper, iters: int) -> torch.Tensor:
    G, _, d = Xb.shape
    dev = Xb.device
    mask = _penalty_mask(d, dev)
    sw = _sum_w(w)
    l2c = _col(l2, 2)
    ridge = (_col(l2, 3) * mask + _JITTER) * _eye(d, dev)
    beta = torch.zeros((G, d), dtype=Xb.dtype, device=dev)
    with TRACER.region("linear.solve", solver="newton", iters=iters):
        for _ in range(iters):
            with TRACER.region("linear.iter"):
                p = torch.sigmoid(_mv(Xb, beta))
                s = w * torch.clamp(p * (1.0 - p), min=1e-6) / sw[:, None]
                gp, Hp = row_sum(_mtv_part(Xb, w * (p - y)),
                                 _gram_part(Xb, Xb * s[..., None]))
                g = gp / sw[:, None] + l2c * mask * beta
                H = Hp + ridge
                beta = beta - _damp(_solve_pos(H, g))
    return beta


def fit_logistic_binary(X, y, w, l2: Hyper,
                        iters: int = LOGISTIC_NEWTON_ITERS) -> torch.Tensor:
    """Damped-Newton logistic fit, X (G, n, d) -> beta (G, d+1)."""
    return _newton_logistic(add_intercept(X), y, w, l2, iters)


def fit_logistic_elastic(X, y, w, reg: Hyper, alpha: Hyper,
                         iters: int = 200) -> torch.Tensor:
    """Elastic-net binary logistic, penalty reg*(alpha*||b||_1 +
    (1-alpha)/2*||b||_2^2): Newton warm start on the smooth part, then
    FISTA for the L1 part (alpha == 0 makes the prox the identity)."""
    l1, l2 = _l1_l2(reg, alpha)
    Xb = add_intercept(X)
    d = Xb.shape[2]
    mask = _penalty_mask(d, Xb.device)
    sw = _sum_w(w)
    beta0 = _newton_logistic(Xb, y, w, l2, LOGISTIC_NEWTON_ITERS)
    lam = _power_lipschitz(Xb * _sqrt_w(w, sw))
    lr = 1.0 / (0.25 * lam + l2 + 1e-6)
    l2c = _col(l2, 2)

    def grad_f(beta):
        p = torch.sigmoid(_mv(Xb, beta))
        return _mtv(Xb, w * (p - y)) / sw[:, None] + l2c * mask * beta

    return _fista(grad_f, beta0, lr, l1, mask, iters)


def affine(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``add_intercept(X) @ w`` for X (n, d) and w (d+1,) or (d+1, k), as
    a row-independent product-and-sum (see the module docstring)."""
    Xb = add_intercept(X)
    if w.dim() == 1:
        return (Xb * w).sum(dim=1)
    return (Xb[:, :, None] * w[None]).sum(dim=1)


def sigmoid_pair(z: torch.Tensor) -> torch.Tensor:
    """(...,) scores -> (..., 2) ``[1 - sigmoid(z), sigmoid(z)]``, as the
    row-wise softmax of ``[0, z]`` (see the module docstring)."""
    return torch.softmax(torch.stack([torch.zeros_like(z), z], dim=-1),
                         dim=-1)


def predict_logistic_binary(beta: torch.Tensor,
                            X: torch.Tensor) -> torch.Tensor:
    return sigmoid_pair(affine(X, beta))


# ---------------------------------------------------------------------------
# Multinomial (softmax) — Newton below the cap, Nesterov above
# ---------------------------------------------------------------------------

#: above this flattened-parameter count (d*k) the multinomial Newton
#: step's (d*k)^2 Hessian is not worth building and Nesterov runs
SOFTMAX_NEWTON_MAX_PARAMS = 256


def _one_hot(y: torch.Tensor, k: int) -> torch.Tensor:
    """jax.nn.one_hot of float labels: a label outside [0, k) is zeros."""
    lab = y.to(torch.int64)
    return (lab[..., None] == torch.arange(k, device=y.device)
            ).to(torch.float32)


def _softmax_grad(Xb, y_oh, w, sw, l2c, mask):
    def grad(theta):
        p = torch.softmax(torch.bmm(Xb, theta), dim=-1)
        return (_gram(Xb, (p - y_oh) * w[..., None]) / sw[:, None, None]
                + l2c * mask * theta)
    return grad


def _softmax_hessian(Xb: torch.Tensor, A: torch.Tensor,
                     gram=_gram) -> torch.Tensor:
    """H[i,c,j,e] = sum_r Xb[r,i] A[r,c,e] Xb[r,j], flattened (i*k+c,
    j*k+e), from one batched Gram over the k(k+1)/2 distinct weightings
    (A is symmetric in c, e) — never an (n, d, k, k, d) temporary.
    ``gram``: :func:`_gram`, or :func:`_gram_part` for this rank's
    partial (its sum is then the caller's)."""
    G, n, d = Xb.shape
    k = A.shape[-1]
    pairs = [(c, e) for c in range(k) for e in range(c, k)]
    index = {}
    for p_i, (c, e) in enumerate(pairs):
        index[(c, e)] = index[(e, c)] = p_i
    Wt = torch.cat([Xb * A[:, :, c, e, None] for c, e in pairs], dim=2)
    gram = gram(Xb, Wt).reshape(G, d, len(pairs), d)
    H = torch.stack([gram[:, :, index[(c, e)]] for c in range(k)
                     for e in range(k)], dim=2).reshape(G, d, k, k, d)
    # [i, c, e, j] -> [i, c, j, e]
    return H.permute(0, 1, 2, 4, 3).reshape(G, d * k, d * k)


def fit_softmax(X, y, w, l2: Hyper, n_classes: int, iters=None
                ) -> torch.Tensor:
    """Multinomial logistic fit -> theta (G, d+1, k). d*k <=
    SOFTMAX_NEWTON_MAX_PARAMS takes damped Newton on the flattened
    theta (20 iterations), larger models Nesterov (200); an explicit
    ``iters`` is honored on whichever path runs."""
    Xb = add_intercept(X)
    G, n, d = Xb.shape
    k = n_classes
    dev = Xb.device
    mask = _penalty_mask(d, dev)[:, None]
    sw = _sum_w(w)
    y_oh = _one_hot(y, k)
    l2c = _col(l2, 3)
    grad = _softmax_grad(Xb, y_oh, w, sw, l2c, mask)
    theta = torch.zeros((G, d, k), dtype=Xb.dtype, device=dev)

    if d * k <= SOFTMAX_NEWTON_MAX_PARAMS:
        dk = d * k
        mask_f = mask.expand(d, k).reshape(dk)
        ridge = (_col(l2, 3) * mask_f + _JITTER) * _eye(dk, dev)
        eye_k = _eye(k, dev)
        ws = (w / sw[:, None])[..., None, None]
        n_it = 20 if iters is None else iters
        with TRACER.region("linear.solve", solver="newton", iters=n_it):
            for _ in range(n_it):
                with TRACER.region("linear.iter"):
                    p = torch.softmax(torch.bmm(Xb, theta), dim=-1)
                    A = ws * (p[..., :, None] * eye_k
                              - p[..., :, None] * p[..., None, :])
                    gp, Hp = row_sum(
                        _gram_part(Xb, (p - y_oh) * w[..., None]),
                        _softmax_hessian(Xb, A, _gram_part))
                    g = (gp / sw[:, None, None]
                         + l2c * mask * theta).reshape(G, dk)
                    H = Hp + ridge
                    delta = _damp(_solve_pos(H, g))
                    theta = theta - delta.reshape(G, d, k)
        return theta

    lam = _power_lipschitz(Xb * _sqrt_w(w, sw))
    lr = _col(1.0 / (0.5 * lam + l2 + 1e-6), 3)
    mom = torch.zeros_like(theta)
    n_it = 200 if iters is None else iters
    with TRACER.region("linear.solve", solver="nesterov", iters=n_it):
        for _ in range(n_it):
            with TRACER.region("linear.iter"):
                v = theta + 0.9 * mom
                new = v - lr * grad(v)
                mom = new - theta
                theta = new
    return theta


def predict_softmax(theta: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return torch.softmax(affine(X, theta), dim=1)


def fit_softmax_elastic(X, y, w, reg: Hyper, alpha: Hyper, n_classes: int,
                        iters: int = 200) -> torch.Tensor:
    """Elastic-net multinomial logistic: warm start from the L2-only
    fit, then FISTA over the (d, k) matrix."""
    l1, l2 = _l1_l2(reg, alpha)
    Xb = add_intercept(X)
    d = Xb.shape[2]
    mask = _penalty_mask(d, Xb.device)[:, None]
    sw = _sum_w(w)
    y_oh = _one_hot(y, n_classes)
    theta0 = fit_softmax(X, y, w, l2, n_classes)
    lam = _power_lipschitz(Xb * _sqrt_w(w, sw))
    lr = 1.0 / (0.5 * lam + l2 + 1e-6)
    grad_f = _softmax_grad(Xb, y_oh, w, sw, _col(l2, 3), mask)
    return _fista(grad_f, theta0, lr, l1, mask, iters)


def predict_logistic(params: Dict[str, torch.Tensor], X: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    if n_classes == 2:
        return predict_logistic_binary(params["beta"], X)
    return predict_softmax(params["theta"], X)


class _LinearFamily(ModelFamily):
    """A linear family: ``fit_batch`` fits a grid (leading G axis on
    every tensor, each hyper a (G,) tensor or a static float);
    ``fit_kernel`` is one fit, the grid at G = 1."""
    rows_sharded = True

    def fit_batch(self, X, y, w, hyper, n_classes):
        raise NotImplementedError

    def fit_kernel(self, X, y, w, hyper, n_classes):
        hb = {k: (v.reshape(1) if isinstance(v, torch.Tensor) else v)
              for k, v in hyper.items()}
        params = self.fit_batch(X[None], y[None], w[None], hb, n_classes)
        return {k: v[0] for k, v in params.items()}


class LogisticRegressionFamily(_LinearFamily):
    name = "LogisticRegression"
    problem_types = ("binary", "multiclass")
    default_hyper = {"regParam": 0.01, "elasticNetParam": 0.0}
    default_grid = {"regParam": [0.001, 0.01, 0.1],
                    "elasticNetParam": [0.0, 0.5]}
    #: a static elasticNetParam == 0 runs the pure Newton solver; a
    #: traced one pays the FISTA tail on every item
    static_hyper_keys = ("elasticNetParam",)

    def fit_batch(self, X, y, w, hyper, n_classes):
        reg = hyper["regParam"]
        alpha = hyper.get("elasticNetParam", 0.0)
        if n_classes == 2:
            if _static_zero(alpha):
                return {"beta": fit_logistic_binary(X, y, w, reg)}
            return {"beta": fit_logistic_elastic(X, y, w, reg, alpha)}
        if _static_zero(alpha):
            return {"theta": fit_softmax(X, y, w, reg, n_classes)}
        return {"theta": fit_softmax_elastic(X, y, w, reg, alpha,
                                             n_classes)}

    def predict_kernel(self, params, X, n_classes):
        return predict_logistic(params, X, n_classes)


# ---------------------------------------------------------------------------
# Linear / ridge regression — closed form, FISTA for the L1 part
# ---------------------------------------------------------------------------

def _ridge(Xb, y, w, l2: Hyper) -> torch.Tensor:
    d = Xb.shape[2]
    dev = Xb.device
    with TRACER.region("linear.solve", solver="ridge", iters=0):
        mask = _penalty_mask(d, dev)
        sw = _sum_w(w)
        Ap, bp = row_sum(_gram_part(Xb, Xb * w[..., None]),
                         _mtv_part(Xb, w * y))
        A = (Ap / sw[:, None, None]
             + (_col(l2, 3) * mask + _JITTER) * _eye(d, dev))
        b = bp / sw[:, None]
        return _solve_pos(A, b)


def fit_ridge(X, y, w, l2: Hyper) -> torch.Tensor:
    return _ridge(add_intercept(X), y, w, l2)


def fit_linear_elastic(X, y, w, reg: Hyper, alpha: Hyper,
                       iters: int = 300) -> torch.Tensor:
    """Elastic-net least squares: closed-form ridge warm start, then
    FISTA for the L1 part (exact zeros on irrelevant coordinates)."""
    l1, l2 = _l1_l2(reg, alpha)
    Xb = add_intercept(X)
    d = Xb.shape[2]
    mask = _penalty_mask(d, Xb.device)
    sw = _sum_w(w)
    beta0 = _ridge(Xb, y, w, l2)
    lam = _power_lipschitz(Xb * _sqrt_w(w, sw))
    lr = 1.0 / (lam + l2 + 1e-6)
    l2c = _col(l2, 2)

    def grad_f(beta):
        r = _mv(Xb, beta) - y
        return _mtv(Xb, w * r) / sw[:, None] + l2c * mask * beta

    return _fista(grad_f, beta0, lr, l1, mask, iters)


def predict_linear_regression(params: Dict[str, torch.Tensor],
                              X: torch.Tensor,
                              n_classes: int) -> torch.Tensor:
    return affine(X, params["beta"])[:, None]


class LinearRegressionFamily(_LinearFamily):
    name = "LinearRegression"
    problem_types = ("regression",)
    default_hyper = {"regParam": 0.01, "elasticNetParam": 0.0}
    default_grid = {"regParam": [0.001, 0.01, 0.1],
                    "elasticNetParam": [0.0, 0.5]}
    #: a static elasticNetParam == 0 runs the closed form only
    static_hyper_keys = ("elasticNetParam",)

    def fit_batch(self, X, y, w, hyper, n_classes):
        reg = hyper["regParam"]
        alpha = hyper.get("elasticNetParam", 0.0)
        if _static_zero(alpha):
            return {"beta": fit_ridge(X, y, w, reg)}
        return {"beta": fit_linear_elastic(X, y, w, reg, alpha)}

    def predict_kernel(self, params, X, n_classes):
        return predict_linear_regression(params, X, n_classes)


# ---------------------------------------------------------------------------
# Linear SVC — squared hinge, Nesterov
# ---------------------------------------------------------------------------

def fit_linear_svc(X, y, w, l2: Hyper, iters: int = 200) -> torch.Tensor:
    Xb = add_intercept(X)
    G, _, d = Xb.shape
    mask = _penalty_mask(d, Xb.device)
    sw = _sum_w(w)
    ys = 2.0 * y - 1.0
    lam = _power_lipschitz(Xb * _sqrt_w(w, sw))
    lr = _col(1.0 / (2.0 * lam + l2 + 1e-6), 2)
    l2c = _col(l2, 2)

    def grad(beta):
        viol = torch.clamp(1.0 - ys * _mv(Xb, beta), min=0.0)
        return (-_mtv(Xb, w * ys * viol) * 2.0 / sw[:, None]
                + l2c * mask * beta)

    beta = torch.zeros((G, d), dtype=Xb.dtype, device=Xb.device)
    mom = torch.zeros_like(beta)
    with TRACER.region("linear.solve", solver="svc", iters=iters):
        for _ in range(iters):
            with TRACER.region("linear.iter"):
                v = beta + 0.9 * mom
                new = v - lr * grad(v)
                mom = new - beta
                beta = new
    return beta


def predict_linear_svc(params: Dict[str, torch.Tensor], X: torch.Tensor,
                       n_classes: int) -> torch.Tensor:
    # platt-less squashing for Prediction parity
    return sigmoid_pair(affine(X, params["beta"]))


class LinearSVCFamily(_LinearFamily):
    name = "LinearSVC"
    problem_types = ("binary",)
    default_hyper = {"regParam": 0.01}
    default_grid = {"regParam": [0.001, 0.01, 0.1]}

    def fit_batch(self, X, y, w, hyper, n_classes):
        return {"beta": fit_linear_svc(X, y, w, hyper["regParam"])}

    def predict_kernel(self, params, X, n_classes):
        return predict_linear_svc(params, X, n_classes)


# ---------------------------------------------------------------------------
# Gaussian naive Bayes — closed form
# ---------------------------------------------------------------------------

def fit_gnb(X, y, w, smoothing: Hyper, n_classes: int
            ) -> Dict[str, torch.Tensor]:
    """X (G, n, d) -> per item mean and var (G, k, d), logprior (G, k)."""
    with TRACER.region("linear.solve", solver="gnb", iters=0):
        y_oh = _one_hot(y, n_classes) * w[..., None]       # (G, n, k)
        cp, mp, sp = row_sum(y_oh.sum(1), _gram_part(y_oh, X),
                             _gram_part(y_oh, X * X))
        cnt = torch.clamp(cp, min=1e-6)                     # (G, k)
        mean = mp / cnt[..., None]
        sq = sp / cnt[..., None]
        var = torch.clamp(sq - mean ** 2, min=1e-6) + _col(smoothing, 3)
        prior = cnt / cnt.sum(1, keepdim=True)
        return {"mean": mean, "var": var, "logprior": torch.log(prior)}


def predict_gnb(params: Dict[str, torch.Tensor], X: torch.Tensor
                ) -> torch.Tensor:
    mean, var = params["mean"], params["var"]            # (k, d)
    ll = -0.5 * torch.sum((X[:, None, :] - mean[None]) ** 2 / var[None]
                          + torch.log(var)[None], dim=2) \
        + params["logprior"][None]
    return torch.softmax(ll, dim=1)


class NaiveBayesFamily(_LinearFamily):
    name = "NaiveBayes"
    problem_types = ("binary", "multiclass")
    default_hyper = {"smoothing": 1.0}
    default_grid = {"smoothing": [1.0]}

    def fit_batch(self, X, y, w, hyper, n_classes):
        return fit_gnb(X, y, w, hyper["smoothing"], n_classes)

    def predict_kernel(self, params, X, n_classes):
        return predict_gnb(params, X)


# ---------------------------------------------------------------------------
# GLM (reference: OpGeneralizedLinearRegression) — IRLS with a log link
#
# Budget (measured by the JAX package): iters=30 is a floor. With a
# strong signal the 10.0 step-norm trust region throttles how far eta
# travels per iteration and poisson reaches its optimum only at ~25-30
# iterations; gamma/tweedie converge by 15-20. Do not trim these.
# ---------------------------------------------------------------------------

def _irls(Xb, w, l2: Hyper, beta0, iters, score_and_weight):
    """Damped Newton for a log-link GLM: ``score_and_weight(mu)`` ->
    (per-row score factor, per-row Fisher weight or None for a constant
    Hessian X^T diag(w) X)."""
    d = Xb.shape[2]
    dev = Xb.device
    mask = _penalty_mask(d, dev)
    sw = _sum_w(w)
    l2c = _col(l2, 2)
    ridge = (_col(l2, 3) * mask + _JITTER) * _eye(d, dev)
    H_const = None
    beta = beta0
    with TRACER.region("linear.solve", solver="irls", iters=iters):
        for _ in range(iters):
            with TRACER.region("linear.iter"):
                mu = torch.exp(torch.clamp(_mv(Xb, beta), -30.0, 30.0))
                score, fisher = score_and_weight(mu)
                gp = _mtv_part(Xb, w * score)
                if fisher is None:
                    if H_const is None:
                        gp, H_const = row_sum(gp, _gram_part(
                            Xb, Xb * (w / sw[:, None])[..., None]))
                    else:
                        gp, = row_sum(gp)
                    H = H_const + ridge
                else:
                    s = w * fisher / sw[:, None]
                    gp, Hp = row_sum(gp, _gram_part(Xb, Xb * s[..., None]))
                    H = Hp + ridge
                g = gp / sw[:, None] + l2c * mask * beta
                beta = beta - _damp(_solve_pos(H, g))
    return beta


def _log_mean_start(Xb, w, yp) -> torch.Tensor:
    """Zeros with the intercept at the log weighted mean of y."""
    G, _, d = Xb.shape
    sw = _sum_w(w)
    b0 = torch.log(torch.clamp(row_sum((w * yp).sum(1))[0] / sw, min=1e-6))
    return torch.cat([torch.zeros((G, d - 1), dtype=Xb.dtype,
                                  device=Xb.device), b0[:, None]], dim=1)


def fit_poisson(X, y, w, l2: Hyper, iters: int = 30) -> torch.Tensor:
    Xb = add_intercept(X)
    G, _, d = Xb.shape
    beta0 = torch.zeros((G, d), dtype=Xb.dtype, device=Xb.device)
    return _irls(Xb, w, l2, beta0, iters, lambda mu: (mu - y, mu))


def fit_gamma(X, y, w, l2: Hyper, iters: int = 30) -> torch.Tensor:
    """Gamma GLM with log link by Fisher scoring: the Fisher weights are
    constant (var(mu) = mu^2 cancels (dmu/deta)^2), so the expected
    Hessian is X^T diag(w) X throughout; the score is X^T (w (1 - y/mu))."""
    Xb = add_intercept(X)
    yp = torch.clamp(y, min=1e-6)           # gamma support is y > 0
    return _irls(Xb, w, l2, _log_mean_start(Xb, w, yp), iters,
                 lambda mu: (1.0 - yp / mu, None))


def fit_tweedie(X, y, w, l2: Hyper, var_power: Hyper,
                iters: int = 30) -> torch.Tensor:
    """Tweedie GLM with log link, variance power p (var(mu) = mu^p):
    score X^T (w (mu - y) mu^(1-p)), Fisher weights w mu^(2-p). p=1 is
    poisson, p=2 gamma."""
    Xb = add_intercept(X)
    yp = torch.clamp(y, min=0.0)
    p = _col(var_power, 2)
    return _irls(Xb, w, l2, _log_mean_start(Xb, w, yp), iters,
                 lambda mu: ((mu - yp) * mu ** (1.0 - p), mu ** (2.0 - p)))


def _glm_predict(link, eta):
    return torch.where(link > 0.5, torch.exp(torch.clamp(eta, -30.0, 30.0)),
                       eta)


class GLMFamily(_LinearFamily):
    name = "GeneralizedLinearRegression"
    problem_types = ("regression",)
    # familyLink: 0=gaussian(identity), 1=poisson(log), 2=gamma(log),
    # 3=tweedie(log, variancePower)
    default_hyper = {"regParam": 0.01, "familyLink": 0.0,
                     "variancePower": 1.5}
    default_grid = {"regParam": [0.01, 0.1]}
    #: a static link runs only its family's solver; a traced one runs
    #: the gaussian and the log-link solver and selects per item
    static_hyper_keys = ("familyLink", "variancePower")

    def fit_batch(self, X, y, w, hyper, n_classes):
        # poisson and gamma are tweedie at p=1 / p=2 (fit_poisson and
        # fit_gamma stay as independent oracles for the tests), so ONE
        # tweedie fit with a link-selected variance power covers every
        # log-link family
        G = X.shape[0]
        reg = hyper["regParam"]
        link = hyper.get("familyLink", 0.0)
        vp = hyper.get("variancePower", 1.5)
        if not isinstance(link, torch.Tensor):
            link = float(link)
            if link <= 0.5:
                beta = fit_ridge(X, y, w, reg)
            else:
                vp_eff = (1.0 if link <= 1.5 else 2.0 if link <= 2.5
                          else vp)
                beta = fit_tweedie(X, y, w, reg, vp_eff)
            return {"beta": beta,
                    "familyLink": torch.full((G,), link, dtype=torch.float32,
                                             device=X.device)}
        vp_t = (vp if isinstance(vp, torch.Tensor)
                else torch.full_like(link, float(vp)))
        vp_eff = torch.where(
            link > 2.5, vp_t, torch.where(link > 1.5,
                                          torch.full_like(link, 2.0),
                                          torch.ones_like(link)))
        gauss = fit_ridge(X, y, w, reg)
        loglink = fit_tweedie(X, y, w, reg, vp_eff)
        beta = torch.where(link[:, None] > 0.5, loglink, gauss)
        return {"beta": beta, "familyLink": link}

    def predict_kernel(self, params, X, n_classes):
        eta = affine(X, params["beta"])
        return _glm_predict(params["familyLink"], eta)[:, None]

