"""Predict functions of the stackable linear families.

Counterparts of the ``predict_kernel`` methods in
``transmogrifai_tpu/models/linear.py``: binary and multinomial
LogisticRegression, LinearRegression and LinearSVC — each one affine
map plus a fixed activation, the set the fused serving kernel can
stack. Each family is registered in ``MODEL_FAMILIES`` with its
predict kernel only: fitting them (the vmapped Newton/FISTA sweep) is
not ported yet, so ``fit_kernel`` raises and the selector refuses them
as candidates. Each predict takes the family's fitted params (tensors
on the scoring device), the (n, d) f32 feature matrix and the class
count, and returns (n, k) probabilities or (n, 1) predictions.

Every op here is row-independent to the bit: a row scores the same
alone or inside any padded, coalesced batch, which is what lets the
engine's exact mode promise that a fused launch scores each row
bitwise like its own model's scorer. Two torch idioms would break
that, so they are avoided: a GEMM chooses its blocking by shape (the
affine map ``add_intercept(X) @ w`` is an elementwise product and a sum
over features instead, :func:`affine`), and the CPU's elementwise
``sigmoid`` takes a SIMD path for whole vector blocks and a scalar path
for the tail, which round differently (the binary head is a two-way
softmax over ``[0, z]`` instead, :func:`sigmoid_pair`, computed per
row).
"""
from __future__ import annotations

from typing import Dict

import torch

from .base import ModelFamily


def add_intercept(X: torch.Tensor) -> torch.Tensor:
    return torch.cat(
        [X, torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)],
        dim=1)


def affine(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``add_intercept(X) @ w`` for w of shape (d+1,) or (d+1, k), as a
    row-independent product-and-sum (see the module docstring)."""
    Xb = add_intercept(X)
    if w.dim() == 1:
        return (Xb * w).sum(dim=1)
    return (Xb[:, :, None] * w[None]).sum(dim=1)


def sigmoid_pair(z: torch.Tensor) -> torch.Tensor:
    """(n,) scores -> (n, 2) ``[1 - sigmoid(z), sigmoid(z)]``, as the
    row-wise softmax of ``[0, z]`` (see the module docstring)."""
    return torch.softmax(torch.stack([torch.zeros_like(z), z], dim=1),
                         dim=1)


def predict_logistic_binary(beta: torch.Tensor,
                            X: torch.Tensor) -> torch.Tensor:
    return sigmoid_pair(affine(X, beta))


def predict_softmax(theta: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return torch.softmax(affine(X, theta), dim=1)


def predict_logistic(params: Dict[str, torch.Tensor], X: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    if n_classes == 2:
        return predict_logistic_binary(params["beta"], X)
    return predict_softmax(params["theta"], X)


def predict_linear_regression(params: Dict[str, torch.Tensor],
                              X: torch.Tensor,
                              n_classes: int) -> torch.Tensor:
    return affine(X, params["beta"])[:, None]


def predict_linear_svc(params: Dict[str, torch.Tensor], X: torch.Tensor,
                       n_classes: int) -> torch.Tensor:
    # platt-less squashing for Prediction parity
    return sigmoid_pair(affine(X, params["beta"]))


class LogisticRegressionFamily(ModelFamily):
    name = "LogisticRegression"
    problem_types = ("binary", "multiclass")

    def predict_kernel(self, params, X, n_classes):
        return predict_logistic(params, X, n_classes)


class LinearRegressionFamily(ModelFamily):
    name = "LinearRegression"
    problem_types = ("regression",)

    def predict_kernel(self, params, X, n_classes):
        return predict_linear_regression(params, X, n_classes)


class LinearSVCFamily(ModelFamily):
    name = "LinearSVC"
    problem_types = ("binary",)

    def predict_kernel(self, params, X, n_classes):
        return predict_linear_svc(params, X, n_classes)
