"""The binary linear families, written from their published solvers:
damped Newton for L2 logistic regression (15 iterations, steps capped at
norm 10, a 1e-5 ridge jitter, the intercept unpenalised), a Newton warm
start then 200 FISTA iterations for the elastic net (step 1/(L/4 + l2)
from 12 power iterations), 200 Nesterov iterations (momentum 0.9, step
1/(2L + l2)) on the squared hinge for the SVC, and Gaussian naive Bayes
in closed form. Losses are weight-averaged over max(sum w, 1).

``prec`` is "f64" (the reference), "f32", or "tf32": every product with
the design matrix reads TF32-rounded operands and sums in f32 (the
control: what TF32 matmuls would give)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .precision import round_tf32

NEWTON_ITERS, FISTA_ITERS, SVC_ITERS, POWER_ITERS = 15, 200, 200, 12
JITTER = 1e-5


class Design:
    """The design matrix [X, 1] with its products in one precision."""

    def __init__(self, X: torch.Tensor, prec: str):
        self.prec = prec
        self.dtype = torch.float64 if prec == "f64" else torch.float32
        Xb = torch.cat([X.to(self.dtype),
                        torch.ones((X.shape[0], 1), dtype=self.dtype,
                                   device=X.device)], 1)
        self.Xb = round_tf32(Xb) if prec == "tf32" else Xb
        self.p = self.Xb.shape[1]

    def _op(self, v):
        return round_tf32(v) if self.prec == "tf32" else v.to(self.dtype)

    def mv(self, beta):                       # X beta
        return self.Xb @ self._op(beta)

    def mtv(self, r):                         # X^T r
        return self.Xb.T @ self._op(r)

    def gram(self, s):                        # X^T diag(s) X
        return self.Xb.T @ self._op(self.Xb * s[:, None])


def _mask(p, dev, dtype):
    m = torch.ones(p, dtype=dtype, device=dev)
    m[-1] = 0.0
    return m


def _damp(delta):
    return delta * torch.clamp(10.0 / torch.clamp(torch.linalg.vector_norm(
        delta), min=1e-12), max=1.0)


def newton_logistic(D: Design, y, w, l2: float, iters=NEWTON_ITERS):
    dev, dt = D.Xb.device, D.dtype
    mask = _mask(D.p, dev, dt)
    sw = torch.clamp(w.sum(), min=1.0)
    ridge = torch.diag(l2 * mask + JITTER)
    beta = torch.zeros(D.p, dtype=dt, device=dev)
    for _ in range(iters):
        p = torch.sigmoid(D.mv(beta))
        s = w * torch.clamp(p * (1 - p), min=1e-6) / sw
        g = D.mtv(w * (p - y)) / sw + l2 * mask * beta
        H = D.gram(s) + ridge
        beta = beta - _damp(torch.linalg.solve(H, g))
    return beta


def power_lipschitz(D: Design, w, iters=POWER_ITERS):
    """Largest eigenvalue of (sqrt(w/sw) X)^T (sqrt(w/sw) X)."""
    sw = torch.clamp(w.sum(), min=1.0)
    s = w / sw
    v = torch.full((D.p,), 1.0 / np.sqrt(D.p), dtype=D.dtype,
                   device=D.Xb.device)

    def op(v):
        return D.mtv(s * D.mv(v))
    for _ in range(iters):
        u = op(v)
        v = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-12)
    return torch.clamp((v * op(v)).sum(), min=1e-8)


def _soft(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def logistic(D: Design, y, w, reg: float, alpha: float):
    l1, l2 = reg * alpha, reg * (1 - alpha)
    beta0 = newton_logistic(D, y, w, l2)
    if alpha == 0.0:
        return beta0
    sw = torch.clamp(w.sum(), min=1.0)
    mask = _mask(D.p, D.Xb.device, D.dtype)
    lr = 1.0 / (0.25 * power_lipschitz(D, w) + l2 + 1e-6)

    def grad(b):
        p = torch.sigmoid(D.mv(b))
        return D.mtv(w * (p - y)) / sw + l2 * mask * b

    keep = mask > 0
    x_prev, z, t = beta0, beta0, 1.0
    for _ in range(FISTA_ITERS):
        v = z - lr * grad(z)
        x = torch.where(keep, _soft(v, lr * l1), v)
        t_new = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        z = x + ((t - 1) / t_new) * (x - x_prev)
        x_prev, t = x, t_new
    return x_prev


def svc(D: Design, y, w, reg: float):
    sw = torch.clamp(w.sum(), min=1.0)
    mask = _mask(D.p, D.Xb.device, D.dtype)
    ys = 2 * y - 1
    lr = 1.0 / (2 * power_lipschitz(D, w) + reg + 1e-6)

    def grad(b):
        viol = torch.clamp(1 - ys * D.mv(b), min=0.0)
        return -D.mtv(w * ys * viol) * 2 / sw + reg * mask * b

    beta = torch.zeros(D.p, dtype=D.dtype, device=D.Xb.device)
    mom = torch.zeros_like(beta)
    for _ in range(SVC_ITERS):
        v = beta + 0.9 * mom
        new = v - lr * grad(v)
        mom = new - beta
        beta = new
    return beta


def gnb(D: Design, y, w, smoothing: float) -> Dict[str, torch.Tensor]:
    X = D.Xb[:, :-1]
    oh = torch.stack([(1 - y) * w, y * w], 1)            # (n, 2)
    cnt = torch.clamp(oh.sum(0), min=1e-6)
    mean = (oh.T @ X) / cnt[:, None]
    sq = (oh.T @ (X * X)) / cnt[:, None]
    var = torch.clamp(sq - mean ** 2, min=1e-6) + smoothing
    return {"mean": mean, "var": var,
            "logprior": torch.log(cnt / cnt.sum())}


def fit(family: str, hyper, X, y, w, prec: str = "f64"):
    """One fit of a binary linear ``family`` at ``hyper``: its params in
    the program's layout ({"beta"} or the naive Bayes moments)."""
    D = Design(X, prec)
    y = y.to(D.dtype)
    w = w.to(D.dtype)
    if family == "LogisticRegression":
        return {"beta": logistic(D, y, w, float(hyper["regParam"]),
                                 float(hyper.get("elasticNetParam", 0.0)))}
    if family == "LinearSVC":
        return {"beta": svc(D, y, w, float(hyper["regParam"]))}
    if family == "NaiveBayes":
        return gnb(D, y, w, float(hyper.get("smoothing", 1.0)))
    raise KeyError(f"no reference for linear family {family!r}")


def score(family: str, params, X) -> torch.Tensor:
    """P(label 1) of each row."""
    X = X.to(torch.float64)
    if family == "NaiveBayes":
        mean = params["mean"].to(torch.float64)
        var = params["var"].to(torch.float64)
        ll = (-0.5 * (((X[:, None, :] - mean[None]) ** 2 / var[None])
                      + torch.log(var)[None]).sum(2)
              + params["logprior"].to(torch.float64)[None])
        return torch.softmax(ll, 1)[:, 1]
    beta = params["beta"].to(torch.float64)
    return torch.sigmoid(X @ beta[:-1] + beta[-1])


FAMILIES = ("LogisticRegression", "LinearSVC", "NaiveBayes")
