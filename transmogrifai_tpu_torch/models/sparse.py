"""Sparse CTR models: hashed-feature logistic regression, FTRL, a
factorization machine and softmax regression (the port's counterpart of
``transmogrifai_tpu/models/sparse.py``).

Reference: the reference's Criteo-class path is OPCollectionHashingVector
izer -> OpLogisticRegression, i.e. mllib LBFGS over Spark sparse vectors
with per-iteration gradient treeAggregate across executors (SURVEY §3.1
hot loop). The JAX package replaces it with minibatch Adagrad (and
FTRL-Proximal, a hashed FM, multiclass softmax) under one ``lax.scan``
per chunk, the hyper grid vmapped over the weight-table axis, and data
larger than device memory streamed through in chunks (io/stream.py).

The port runs the same update rules, step for step, in eager torch:

* **The instance axis is explicit.** Every step works on tables with a
  leading instance axis I — ``table (I, B)``, ``emb (I, B, k)``,
  ``dense (I, d)``, ``bias (I,)`` — and a per-instance row weight
  ``w (I, b)``. A single fit is I = 1 (views of the JAX-shaped state);
  the grid sweep is I = G·F, every (hyper, fold) instance sharing the
  batch's indices and differing only in its fold weights and hypers,
  as the ROADMAP rule "batching is explicit" asks.
* **``lax.scan`` is a Python loop over minibatches** that cuts exactly
  the reference's batches (w = 0 padding rows and whole padded batches
  included: with ``l2 > 0`` a padded batch still decays ``dense``). The
  state is updated in place (the JAX package donates it). Nothing in
  the loop reads a tensor on the host: hypers are Python floats or
  per-instance tensors uploaded once, so a chunk's steps queue on the
  card without a sync.
* **Deterministic accumulation.** Each step's table gradient is a
  scatter-add over the batch's ``b·K`` hashed indices. It is done with
  ``index_put_(accumulate=True)``, which on CUDA sorts the indices and
  sums each bucket's contributions in a fixed order (unlike
  ``index_add_``'s atomics), so two identical sweeps pick the same
  winner and a refit reproduces bit for bit on the card.
* **Full-table updates.** As in the reference, every step updates every
  bucket from a full-size gradient; a bucket the batch does not touch
  has ``g = 0`` exactly, so its Adagrad (``acc + 0``, ``p - lr·0``) and
  FTRL (``sigma = 0``) updates leave it unchanged bit for bit.
* **Gradients are written by hand.** The FM and softmax gradients are
  the chain ``jax.grad`` takes (the clipped logloss through the logistic,
  the FM term's ``∂inter/∂e_k = s - e_k``, softmax cross-entropy through
  ``log_softmax``), scattered into the tables; no autograd graph.
* **FM draws.** ``init_sparse_fm`` draws ``emb`` from a CPU
  ``torch.Generator`` seeded by ``seed`` (the same draws on the card and
  on the CPU), not ``jax.random``; every FM entry point takes an
  optional initial ``emb`` so a caller can start from the JAX package's
  draws.
* **Row-independent predicts.** The logit's dense part is a
  product-and-sum and the binary head a two-way softmax
  (``linear.sigmoid_pair``), so a row scores the same alone, in a batch,
  in a stream or behind the serving engine.

The mesh-sharded fits (``fit_sparse_*_sharded``) split each
minibatch's rows over the ranks of a data mesh and keep every rank's
parameters a replica: one cross-rank sum a step (``_fit_sharded``).
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..dataset import Dataset
from ..features import types as ft
from ..stages.base import TernaryEstimator, TernaryTransformer
from ..telemetry.spans import TRACER
from .base import (_params_device, params_from_numpy, params_on,
                   params_to_numpy, prediction_column)
from .linear import sigmoid_pair

Hyper = Any     # a Python float (one value) or an (I,) f32 tensor


# ---------------------------------------------------------------------------
# Building blocks on the instance axis
# ---------------------------------------------------------------------------

def _per_instance(h: Hyper, like: torch.Tensor) -> Hyper:
    """A hyper broadcast against a per-instance tensor ``like`` (I, ...):
    a float stays a float, an (I,) tensor becomes (I, 1, ...)."""
    if isinstance(h, torch.Tensor):
        return h.reshape((-1,) + (1,) * (like.dim() - 1))
    return h


def _gather_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(I, B[, C]) table, (b, K) indices -> (I, b[, C]): each row's sum
    of its K buckets."""
    return table[:, idx].sum(dim=2)


def _dense_dot(X: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """(b, d) rows against (I, d) or (I, d, C) weights -> (I, b[, C]) as a
    product and a sum (row-independent, see the module docstring)."""
    if dense.dim() == 2:
        return (X[None] * dense[:, None, :]).sum(dim=-1)
    return (X[None, :, :, None] * dense[:, None, :, :]).sum(dim=2)


def _linear_logits(P: Dict[str, torch.Tensor], idx: torch.Tensor,
                   X: torch.Tensor) -> torch.Tensor:
    """logit = sum_k table[idx_k] + X·dense + bias, per instance."""
    bias = P["bias"]
    return (_gather_sum(P["table"], idx) + _dense_dot(X, P["dense"])
            + (bias[:, None] if bias.dim() == 1 else bias[:, None, :]))


def _fm_parts(P, idx, X):
    """(logit, s, e) of the FM: the linear logit plus
    0.5·sum_f[(sum_k e_kf)² - sum_k e_kf²]; e (I, b, K, k), s (I, b, k)."""
    e = P["emb"][:, idx]
    s = e.sum(dim=2)
    inter = 0.5 * (s * s - (e * e).sum(dim=2)).sum(dim=-1)
    return _linear_logits(P, idx, X) + inter, s, e


def _fm_logits(P, idx, X):
    return _fm_parts(P, idx, X)[0]


class _ScatterPlan:
    """Where one minibatch's table gradient lands: the flattened
    (instance, bucket) index of each of its ``b·K`` entries, for every
    instance. A row no instance weighs (``w = 0`` throughout: a padded
    row) adds exact zeros, so its entries are sent to spread-out buckets
    instead of its padded bucket 0: a padded tail batch would otherwise
    pile ~``b·K`` entries onto one bucket, which the sorted accumulation
    sums one after another."""

    def __init__(self, I: int, B: int, b: int, K: int, device):
        self.I, self.B = I, B
        self.off = (torch.arange(I, device=device, dtype=torch.int64)
                    * B)[:, None]
        self.spread = torch.arange(b * K, device=device,
                                   dtype=torch.int64).reshape(b, K) % B

    def flat(self, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        live = (w != 0).any(dim=0)
        sidx = torch.where(live[:, None], idx, self.spread[:idx.shape[0]])
        return (self.off + sidx.reshape(1, -1)).reshape(-1)


def _scatter(plan: _ScatterPlan, flat: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """Full-size gradient of a hashed table: row r's value ``vals[i, r]``
    (a scalar, or a trailing (C,) / (k,) slice; (I, b, K, k) for values
    that differ per field) added at each of its K buckets ``flat`` of
    instance i -> (I, B, ...). Deterministic: ``index_put_`` with
    ``accumulate=True`` sums each bucket's contributions in index order
    (sorted on CUDA), never by atomics."""
    I, B, b = plan.I, plan.B, vals.shape[1]
    K = flat.numel() // (I * b)
    tail = tuple(vals.shape[3:] if vals.dim() == 4 else vals.shape[2:])
    if vals.dim() == 4:                                          # per field
        v = vals.reshape((I * b * K,) + tail)
    else:                                  # one value a row, K times over
        v = vals[:, :, None].expand((I, b, K) + tail).reshape(
            (I * b * K,) + tail)
    g = torch.zeros((I * B,) + tail, dtype=vals.dtype, device=vals.device)
    g.index_put_((flat,), v, accumulate=True)
    return g.reshape((I, B) + tail)


def _touched(plan, flat, w) -> torch.Tensor:
    """(I, B) bool: the buckets a row of positive weight hit this batch
    (the lazy-L2 mask; w = 0 padding rows never mark a bucket)."""
    return _scatter(plan, flat, (w > 0).to(torch.float32)) > 0


# per-bucket table-shaped params that take LAZY L2 (decay only on
# touched rows); "dense" always takes decoupled L2; "bias" none
_LAZY_L2_KEYS = ("table", "emb")


def _any_positive(h: Hyper) -> bool:
    """Whether a hyper may be nonzero, decided on the host: a float by
    value, a tensor always (its values are not read back)."""
    return isinstance(h, torch.Tensor) or h != 0.0


def _adagrad_apply(P, A, g, touched: Callable[[], torch.Tensor],
                   lr: Hyper, l2: Hyper) -> None:
    """The shared Adagrad update, in place (``_adagrad_scan``'s step):
    lazy L2 on the hashed tables (``touched()``: the (I, B) bool mask of
    the buckets this batch hit), decoupled L2 on ``dense``, none on
    ``bias``; acc += g², p -= lr·g/√acc. With l2 a float 0.0 the L2
    terms add exactly zero, so they are skipped."""
    if _any_positive(l2):
        touched = touched()
        for k in g:
            if k in _LAZY_L2_KEYS:
                mask = touched.reshape(touched.shape
                                       + (1,) * (P[k].dim() - 2))
                g[k] = g[k] + _per_instance(l2, P[k]) * torch.where(
                    mask, P[k], torch.zeros((), dtype=P[k].dtype,
                                            device=P[k].device))
            elif k == "dense":
                g[k] = g[k] + _per_instance(l2, P[k]) * P[k]
    for k, gk in g.items():
        A[k].add_(gk * gk)
        P[k].sub_(_per_instance(lr, P[k]) * gk / torch.sqrt(A[k]))


def _row_share(w: torch.Tensor, mean: bool) -> torch.Tensor:
    """Each row's share of the batch loss: w/Σw (the weighted mean), or
    the raw w when ``mean`` is False (a sharded step divides the reduced
    sum by the global batch Σw instead)."""
    if not mean:
        return w
    return w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-9)


def _lr_grads(P, idx, X, y, w, plan, flat, mean: bool = True):
    """Per-minibatch gradient of the weighted mean logloss (the
    reference's ``_batch_grads``): dz = w·(p - y)/Σw, scattered into the
    table (``mean=False``: dz = w·(p - y))."""
    z = _linear_logits(P, idx, X)
    p = torch.sigmoid(z)
    if mean:
        sw = torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-9)
        dz = w * (p - y) / sw                                     # (I, b)
    else:
        dz = w * (p - y)
    return {"table": _scatter(plan, flat, dz), "dense": dz @ X,
            "bias": dz.sum(dim=1)}


def _fm_grads(P, idx, X, y, w, plan, flat, mean: bool = True):
    """The gradient ``jax.grad`` takes of the FM's weighted mean clipped
    logloss, by hand: through log, the clip (zero where the probability
    is clipped) and the logistic, then ∂z/∂e_k = s - e_k per field."""
    z, s, e = _fm_parts(P, idx, X)
    p = torch.sigmoid(z)
    p1 = torch.clamp(p, 1e-7, 1 - 1e-7)
    ct = _row_share(w, mean)
    ct_p1 = (-ct * y) / p1 - (-ct * (1 - y)) / (1 - p1)
    inside = (p > 1e-7) & (p < 1 - 1e-7)
    dz = torch.where(inside, ct_p1, torch.zeros((), device=p.device)) \
        * (p * (1 - p))                                           # (I, b)
    de = dz[:, :, None, None] * (s[:, :, None, :] - e)           # (I,b,K,k)
    return {"table": _scatter(plan, flat, dz), "dense": dz @ X,
            "bias": dz.sum(dim=1), "emb": _scatter(plan, flat, de)}


def _softmax_grads(P, idx, X, y, w, plan, flat, mean: bool = True):
    """The gradient of the weighted mean softmax cross-entropy (y holds
    class ids), as ``log_softmax``'s backward gives it:
    g - softmax·Σg with g = -w/Σw at the label's class."""
    C = P["table"].shape[2]
    z = _linear_logits(P, idx, X)                                 # (I,b,C)
    ct = _row_share(w, mean)
    onehot = torch.nn.functional.one_hot(y.to(torch.int64), C).to(z.dtype)
    g = -ct[:, :, None] * onehot[None]
    dz = g - torch.softmax(z, dim=-1) * g.sum(dim=-1, keepdim=True)
    return {"table": _scatter(plan, flat, dz),
            "dense": torch.einsum("ibc,bd->idc", dz, X),
            "bias": dz.sum(dim=1)}


def _ftrl_w(z, nn, alpha, beta, l1, l2):
    """FTRL-Proximal's closed-form weight from (z, n): 0 where |z| <= l1."""
    a, bt, r1, r2 = (_per_instance(h, z) for h in (alpha, beta, l1, l2))
    active = torch.abs(z) > r1
    denom = (bt + torch.sqrt(nn)) / a + r2
    return torch.where(active, -(z - torch.sign(z) * r1) / denom,
                       torch.zeros((), dtype=z.dtype, device=z.device))


def _ftrl_weights_b(S, alpha, beta, l1, l2) -> Dict[str, torch.Tensor]:
    return {k: _ftrl_w(S["z"][k], S["n"][k], alpha, beta, l1, l2)
            for k in S["z"]}


def _ftrl_step(S, idx, X, y, w, alpha, beta, l1, l2, plan) -> None:
    """One FTRL-Proximal minibatch, in place (the reference's scan
    body): per-row SUM gradients (not the batch mean), then per
    coordinate sigma = (√(n + g²) - √n)/alpha, z += g - sigma·w,
    n += g²."""
    W = _ftrl_weights_b(S, alpha, beta, l1, l2)
    z = _linear_logits(W, idx, X)
    dz = w * (torch.sigmoid(z) - y)                               # (I, b)
    g = {"table": _scatter(plan, plan.flat(idx, w), dz), "dense": dz @ X,
         "bias": dz.sum(dim=1)}
    for k, gk in g.items():
        zk, nk = S["z"][k], S["n"][k]
        g2 = gk * gk
        sigma = (torch.sqrt(nk + g2) - torch.sqrt(nk)) \
            / _per_instance(alpha, nk)
        zk.copy_(zk + gk - sigma * W[k])
        nk.add_(g2)


def _batches(n: int, batch_size: int):
    if n % batch_size:
        raise ValueError(f"{n} rows are not a multiple of batch_size "
                         f"{batch_size}: pad with w=0 rows (_pad_chunk)")
    for s in range(0, n, batch_size):
        yield slice(s, s + batch_size)


def _rows(idx, Xnum, device):
    """Rows' (idx int64, X f32) tensors on ``device``."""
    return (torch.as_tensor(idx, device=device).to(torch.int64),
            torch.as_tensor(Xnum, device=device).to(torch.float32))


def _chunk_tensors(idx, Xnum, y, device):
    """One chunk's (idx int64, X f32, y f32) tensors on ``device``."""
    return _rows(idx, Xnum, device) + (
        torch.as_tensor(y, device=device).to(torch.float32),)


def _adagrad_epoch_b(grad_fn, P, A, idx, X, y, w, lr, l2,
                     batch_size: int) -> None:
    """One Adagrad pass over a chunk on the instance axis: idx (n, K),
    X (n, d), y (n,) shared, w (I, n) per instance; in place."""
    I, B = P["table"].shape[:2]
    plan = _ScatterPlan(I, B, min(batch_size, idx.shape[0]), idx.shape[1],
                        idx.device)
    with torch.no_grad():
        for sl in _batches(idx.shape[0], batch_size):
            with TRACER.region("sparse.step"):
                bidx, bw = idx[sl], w[:, sl]
                flat = plan.flat(bidx, bw)
                g = grad_fn(P, bidx, X[sl], y[sl], bw, plan, flat)
                _adagrad_apply(P, A, g,
                               lambda: _touched(plan, flat, bw), lr, l2)


def _ftrl_epoch_b(S, idx, X, y, w, alpha, beta, l1, l2,
                  batch_size: int) -> None:
    I, B = S["z"]["table"].shape
    plan = _ScatterPlan(I, B, min(batch_size, idx.shape[0]), idx.shape[1],
                        idx.device)
    with torch.no_grad():
        for sl in _batches(idx.shape[0], batch_size):
            with TRACER.region("sparse.step"):
                _ftrl_step(S, idx[sl], X[sl], y[sl], w[:, sl], alpha, beta,
                           l1, l2, plan)


def _one(tree):
    """Views of a JAX-shaped (unbatched) state with an instance axis of
    one: updates through them land in the state itself."""
    if isinstance(tree, dict):
        return {k: _one(v) for k, v in tree.items()}
    return tree.unsqueeze(0)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Adagrad-LR (the reference's sparse_lr family)
# ---------------------------------------------------------------------------

def sparse_logits(params: Dict[str, torch.Tensor], idx: torch.Tensor,
                  Xnum: torch.Tensor) -> torch.Tensor:
    """logit = sum_k table[idx_k] + Xnum·dense + bias (one model: table
    (B,), dense (d,), bias ()); (n,) logits, row-independent."""
    return (params["table"][idx].sum(dim=1)
            + (Xnum * params["dense"]).sum(dim=1) + params["bias"])


def sparse_fm_logits(params, idx: torch.Tensor, Xnum: torch.Tensor
                     ) -> torch.Tensor:
    """The FM's (n,) logits for one model (``emb`` (B, k))."""
    e = params["emb"][idx]                                  # (n, K, k)
    s = e.sum(dim=1)
    inter = 0.5 * (s * s - (e * e).sum(dim=1)).sum(dim=1)
    return sparse_logits(params, idx, Xnum) + inter


def init_sparse_lr(n_buckets: int, d_num: int, device=None
                   ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {"table": torch.zeros(n_buckets, device=dev),
            "dense": torch.zeros(d_num, device=dev),
            "bias": torch.zeros((), device=dev)}


def _zero_like_acc(params):
    return {k: torch.full_like(v, 1e-6) for k, v in params.items()}


def sparse_lr_epoch(params, acc, idx, Xnum, y, w, lr, l2,
                    batch_size: int):
    """One Adagrad pass over device-resident data (n a multiple of
    batch_size — pad with w=0 rows), updating ``params`` and ``acc`` in
    place; returns them."""
    idx, X, y = _chunk_tensors(idx, Xnum, y, params["table"].device)
    w = torch.as_tensor(w, device=X.device).to(torch.float32)
    _adagrad_epoch_b(_lr_grads, _one(params), _one(acc), idx, X, y,
                     w[None], lr, l2, batch_size)
    return params, acc


def fit_sparse_lr(idx: np.ndarray, Xnum: np.ndarray, y: np.ndarray,
                  w: np.ndarray, n_buckets: int, lr: float = 0.05,
                  l2: float = 0.0, epochs: int = 2,
                  batch_size: int = 8192, device=None
                  ) -> Dict[str, np.ndarray]:
    """Fit on device-resident data (streaming variant below) on
    ``device`` (None: CUDA, raising without a card)."""
    c = _pad_chunk({"idx": idx, "num": Xnum, "y": y, "w": w}, batch_size)
    params = init_sparse_lr(n_buckets, np.shape(c["num"])[1], device)
    acc = _zero_like_acc(params)
    dev = params["table"].device
    it, Xt, yt = _chunk_tensors(c["idx"], c["num"], c["y"], dev)
    wt = torch.as_tensor(c["w"], device=dev).to(torch.float32)
    for _ in range(epochs):
        sparse_lr_epoch(params, acc, it, Xt, yt, wt, float(lr), float(l2),
                        batch_size)
    return _numpy(params)


def _pad_chunk(chunk: Dict[str, Any], batch_size: int) -> Dict[str, Any]:
    """Pad a chunk's rows to a batch_size multiple with w=0 rows (zero
    weight => zero gradient, so padding never changes the fit).
    Chunks already on the device must come padded (they pass through)."""
    n = len(chunk["y"])
    pad = (-n) % batch_size
    if pad == 0:
        return chunk
    z = lambda a: np.concatenate(
        [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    return {k: z(np.asarray(v)) for k, v in chunk.items()}


def _uniform_chunks(chunks: Iterable[Dict[str, Any]]
                    ) -> Iterable[Dict[str, Any]]:
    """Pad SMALLER (tail) chunks up to the first chunk's row count, as
    the reference does so every chunk step of a stream has one shape
    (w=0 padding rows are inert, same contract as _pad_chunk); the port
    pads exactly as the reference so it steps through the same
    minibatches, padded ones included. A chunk LARGER than the first
    keeps its size."""
    target = 0
    for c in chunks:
        n = len(c["y"])
        target = target or n
        if n < target:
            pad = target - n
            c = {k: np.concatenate(
                [np.asarray(v),
                 np.zeros((pad,) + np.asarray(v).shape[1:],
                          np.asarray(v).dtype)])
                 for k, v in c.items()}
        yield c


def _run_streaming_fit(state, epoch_step, chunk_factory, epochs: int,
                       batch_size: int, buffer_size: int, device,
                       checkpoint_dir=None, checkpoint_every: int = 8,
                       checkpoint_token: str = ""):
    """Shared streaming-fit scaffold for every sparse family: pad each
    chunk to a batch_size multiple (w=0 rows) and unify tail-chunk
    shapes, double-buffer the copies (io/stream.fit_streaming), carry
    the optimizer state across chunks and epochs; ``checkpoint_dir``
    enables mid-stream checkpoint/resume in the JAX package's file
    format."""
    from ..io import stream as iostream

    def padded():
        return _uniform_chunks(_pad_chunk(c, batch_size)
                               for c in chunk_factory())

    return iostream.fit_streaming(
        epoch_step, state, padded(), epochs=epochs,
        buffer_size=buffer_size, reiterable=padded,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        checkpoint_token=checkpoint_token, device=device)


def _adagrad_stream_step(grad_fn, lr, l2, batch_size):
    def step(state, chunk):
        params, acc = state
        idx, X, y = _chunk_tensors(chunk["idx"], chunk["num"], chunk["y"],
                                   params["table"].device)
        w = chunk["w"].to(torch.float32)
        _adagrad_epoch_b(grad_fn, _one(params), _one(acc), idx, X, y,
                         w[None], float(lr), float(l2), batch_size)
        return params, acc
    return step


def fit_sparse_lr_streaming(chunk_factory, n_buckets: int, d_num: int,
                            lr: float = 0.05, l2: float = 0.0,
                            epochs: int = 1, batch_size: int = 8192,
                            buffer_size: int = 2,
                            checkpoint_dir: Optional[str] = None,
                            checkpoint_every: int = 8, device=None
                            ) -> Dict[str, np.ndarray]:
    """Streaming fit for data larger than device memory.

    chunk_factory() -> iterator of dict chunks {"idx": (c, K) int32,
    "num": (c, d) float32, "y": (c,), "w": (c,)} as host arrays (copied
    through pinned memory on a side stream while the previous chunk's
    steps run) or as tensors already on ``device`` (padded to a
    batch_size multiple; used as they are)."""
    dev = resolve_device(device)
    params = init_sparse_lr(n_buckets, d_num, dev)
    acc = _zero_like_acc(params)
    params, acc = _run_streaming_fit(
        (params, acc), _adagrad_stream_step(_lr_grads, lr, l2, batch_size),
        chunk_factory, epochs, batch_size, buffer_size, dev,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        checkpoint_token=f"lr|B={n_buckets},d={d_num},lr={lr},l2={l2},"
                         f"bs={batch_size},ep={epochs}")
    return _numpy(params)


def _rank_parts(grad_fn, P, idx, X, y, w, plan, lazy_l2: bool
                ) -> torch.Tensor:
    """One rank's share of a sharded step, packed into one f32 buffer
    for one cross-rank sum: [Σw, the raw (unnormalised) gradient of
    each param in key order, the (B,) count of its rows of positive
    weight at each bucket (only under L2)]. Σw rides with the raw
    gradient so the reduced sum divides by the global batch Σw, and the
    counts reduce before they are compared with 0, so the lazy-L2 mask
    is the union over ranks."""
    flat = plan.flat(idx, w)
    g = grad_fn(P, idx, X, y, w, plan, flat, mean=False)
    parts = [w.sum().reshape(1)] + [g[k].reshape(-1) for k in sorted(g)]
    if lazy_l2:
        parts.append(_scatter(plan, flat, (w > 0).to(torch.float32))
                     .reshape(-1))
    return torch.cat(parts)


def _unpack_step(buf: torch.Tensor, P, lazy_l2: bool):
    """The reduced buffer of :func:`_rank_parts` -> (gradients divided by
    the global Σw, the touched mask)."""
    sw = torch.clamp_min(buf[0], 1e-9)
    g, off = {}, 1
    for k in sorted(P):
        n = P[k].numel()
        g[k] = buf[off:off + n].reshape(P[k].shape) / sw
        off += n
    touched = None
    if lazy_l2:
        touched = buf[off:off + P["table"].shape[1]].reshape(
            1, P["table"].shape[1]) > 0
    return g, touched


def _fit_sharded(init_params: Callable, grad_fn, idx, Xnum, y, w, mesh,
                 lr: float, l2: float, epochs: int, batch_size: int
                 ) -> Dict[str, np.ndarray]:
    """Mesh-data-parallel Adagrad fit shared by every sparse family (the
    JAX package's ``_fit_sharded``): each minibatch's rows split over
    the data mesh's ranks (contiguous, ``torch.tensor_split`` sizes), the
    parameters and Adagrad accumulators replicated on every rank
    (``init_params(device)``). Each step every rank scatters its rows'
    raw gradient into a full-size table (:func:`_rank_parts`), the parts
    reduce in ONE ``allreduce_data`` call (the CUDA ring, or its plain
    version under TM_MESH_RDMA_RING=0, resolved once), and every rank
    divides by the global Σw and applies ``_adagrad_apply`` to its own
    replica, so the replicas stay bitwise equal. Padding (``_pad_chunk``'s
    w = 0 rows, ``_ScatterPlan``'s spread) is the single-device fit's.
    Nothing is read on the host between two steps. Returns rank 0's
    parameters. On a 2-D or hybrid mesh the rows ride its ``"data"``
    axis (``Mesh2D.data_mesh``: this process's first row; the other rows
    replicate it), as in the JAX package."""
    from ..parallel.data_parallel import data_mesh
    from ..parallel.mesh import Mesh2D
    from .kernels import allreduce_data, ring_reduce_enabled
    mesh = mesh or data_mesh()
    if isinstance(mesh, Mesh2D):
        mesh = mesh.data_mesh()
    c = _pad_chunk({"idx": idx, "num": Xnum, "y": y, "w": w}, batch_size)
    steps = len(c["y"]) // batch_size
    ndev = mesh.size
    sizes = [len(a) for a in np.array_split(np.arange(batch_size), ndev)]
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    use_ring = ring_reduce_enabled(mesh.devices[0])
    lazy_l2 = float(l2) != 0.0
    ranks = []
    for r, dev in enumerate(mesh.devices):
        def rows(a, r=r):
            a = np.asarray(a)
            a = a.reshape((steps, batch_size) + a.shape[1:])
            return np.ascontiguousarray(
                a[:, bounds[r]:bounds[r + 1]]).reshape(
                (steps * sizes[r],) + a.shape[2:])
        it, Xt, yt = _chunk_tensors(rows(c["idx"]), rows(c["num"]),
                                    rows(c["y"]), dev)
        params = init_params(dev)
        ranks.append({
            "idx": it, "X": Xt, "y": yt,
            "w": torch.as_tensor(rows(c["w"]), device=dev).to(
                torch.float32),
            "params": params, "acc": _zero_like_acc(params),
            "plan": _ScatterPlan(1, params["table"].shape[0], sizes[r],
                                 it.shape[1], dev)})
    mesh.fork()
    with torch.no_grad():
        for _ in range(epochs):
            for t in range(steps):
                with TRACER.region("sparse.step"):
                    parts = []
                    for r, rk in enumerate(ranks):
                        with mesh.rank(r):
                            sl = slice(t * sizes[r], (t + 1) * sizes[r])
                            parts.append(_rank_parts(
                                grad_fn, _one(rk["params"]), rk["idx"][sl],
                                rk["X"][sl], rk["y"][sl],
                                rk["w"][None, sl], rk["plan"], lazy_l2))
                    red = allreduce_data(parts, mesh, use_ring)
                    for r, rk in enumerate(ranks):
                        with mesh.rank(r):
                            P, A = _one(rk["params"]), _one(rk["acc"])
                            g, touched = _unpack_step(red[r], P, lazy_l2)
                            _adagrad_apply(P, A, g, lambda t=touched: t,
                                           float(lr), float(l2))
    mesh.join(*(v for rk in ranks for v in rk["params"].values()))
    return _numpy(ranks[0]["params"])


def fit_sparse_lr_sharded(idx: np.ndarray, Xnum: np.ndarray, y: np.ndarray,
                          w: np.ndarray, n_buckets: int, mesh=None,
                          lr: float = 0.05, l2: float = 0.0,
                          epochs: int = 2, batch_size: int = 8192
                          ) -> Dict[str, np.ndarray]:
    """Mesh-data-parallel sparse LR (see :func:`_fit_sharded`); ``mesh``
    a data mesh (None: ``parallel.data_mesh()``, every configured card)."""
    d = np.shape(Xnum)[1]
    return _fit_sharded(lambda dev: init_sparse_lr(n_buckets, d, dev),
                        _lr_grads, idx, Xnum, y, w, mesh, lr, l2, epochs,
                        batch_size)


def fit_sparse_fm_sharded(idx: np.ndarray, Xnum: np.ndarray, y: np.ndarray,
                          w: np.ndarray, n_buckets: int, mesh=None,
                          k: int = 8, lr: float = 0.05, l2: float = 0.0,
                          epochs: int = 2, batch_size: int = 8192,
                          seed: int = 0, emb=None) -> Dict[str, np.ndarray]:
    """Mesh-data-parallel hashed FM (see :func:`_fit_sharded`); ``emb``
    drawn as :func:`fit_sparse_fm` draws it (or the caller's), the same
    on every rank."""
    d = np.shape(Xnum)[1]
    return _fit_sharded(
        lambda dev: init_sparse_fm(n_buckets, d, k, seed, emb=emb,
                                   device=dev),
        _fm_grads, idx, Xnum, y, w, mesh, lr, l2, epochs, batch_size)


def fit_sparse_softmax_sharded(idx: np.ndarray, Xnum: np.ndarray,
                               y: np.ndarray, w: np.ndarray,
                               n_buckets: int, n_classes: int, mesh=None,
                               lr: float = 0.05, l2: float = 0.0,
                               epochs: int = 2, batch_size: int = 8192
                               ) -> Dict[str, np.ndarray]:
    """Mesh-data-parallel multiclass softmax (see :func:`_fit_sharded`;
    y = class ids)."""
    _check_class_ids(y, n_classes)
    d = np.shape(Xnum)[1]
    return _fit_sharded(
        lambda dev: init_sparse_softmax(n_buckets, d, n_classes, dev),
        _softmax_grads, idx, Xnum, y, w, mesh, lr, l2, epochs, batch_size)


# ---------------------------------------------------------------------------
# Hashed Factorization Machine (Rendle 2010)
# ---------------------------------------------------------------------------

def init_sparse_fm(n_buckets: int, d_num: int, k: int = 8,
                   seed: int = 0, init_scale: float = 0.01, emb=None,
                   device=None) -> Dict[str, torch.Tensor]:
    """Zero linear part plus ``emb`` (B, k): the given initial ``emb``,
    else ``init_scale`` times normal draws from a CPU
    ``torch.Generator`` seeded by ``seed`` (the same on every device)."""
    dev = resolve_device(device)
    if emb is None:
        gen = torch.Generator().manual_seed(int(seed))
        emb = init_scale * torch.randn((n_buckets, k), generator=gen)
    if not isinstance(emb, torch.Tensor):
        emb = torch.from_numpy(np.array(emb, np.float32))
    if tuple(emb.shape) != (n_buckets, k):
        raise ValueError(f"initial emb has shape {tuple(emb.shape)}, "
                         f"expected {(n_buckets, k)}")
    return dict(init_sparse_lr(n_buckets, d_num, dev),
                emb=emb.to(device=dev, dtype=torch.float32).clone())


def fm_epoch(params, acc, idx, Xnum, y, w, lr, l2, batch_size: int):
    """One Adagrad pass of the FM (same contract and update rule as
    sparse_lr_epoch; lazy L2 on both hashed tables)."""
    idx, X, y = _chunk_tensors(idx, Xnum, y, params["table"].device)
    w = torch.as_tensor(w, device=X.device).to(torch.float32)
    _adagrad_epoch_b(_fm_grads, _one(params), _one(acc), idx, X, y,
                     w[None], lr, l2, batch_size)
    return params, acc


def fit_sparse_fm(idx: np.ndarray, Xnum: np.ndarray, y: np.ndarray,
                  w: np.ndarray, n_buckets: int, k: int = 8,
                  lr: float = 0.05, l2: float = 0.0, epochs: int = 2,
                  batch_size: int = 8192, seed: int = 0, emb=None,
                  device=None) -> Dict[str, np.ndarray]:
    c = _pad_chunk({"idx": idx, "num": Xnum, "y": y, "w": w}, batch_size)
    params = init_sparse_fm(n_buckets, np.shape(c["num"])[1], k, seed,
                            emb=emb, device=device)
    acc = _zero_like_acc(params)
    dev = params["table"].device
    it, Xt, yt = _chunk_tensors(c["idx"], c["num"], c["y"], dev)
    wt = torch.as_tensor(c["w"], device=dev).to(torch.float32)
    for _ in range(epochs):
        fm_epoch(params, acc, it, Xt, yt, wt, float(lr), float(l2),
                 batch_size)
    return _numpy(params)


def fit_sparse_fm_streaming(chunk_factory, n_buckets: int, d_num: int,
                            k: int = 8, lr: float = 0.05, l2: float = 0.0,
                            epochs: int = 1, batch_size: int = 8192,
                            buffer_size: int = 2, seed: int = 0,
                            checkpoint_dir: Optional[str] = None,
                            checkpoint_every: int = 8, emb=None,
                            device=None) -> Dict[str, np.ndarray]:
    """Streaming FM fit (same chunk contract as fit_sparse_lr_streaming)."""
    dev = resolve_device(device)
    params = init_sparse_fm(n_buckets, d_num, k, seed, emb=emb, device=dev)
    acc = _zero_like_acc(params)
    params, acc = _run_streaming_fit(
        (params, acc), _adagrad_stream_step(_fm_grads, lr, l2, batch_size),
        chunk_factory, epochs, batch_size, buffer_size, dev,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        checkpoint_token=f"fm|B={n_buckets},d={d_num},k={k},lr={lr},"
                         f"l2={l2},bs={batch_size},ep={epochs},"
                         f"seed={seed}")
    return _numpy(params)


# ---------------------------------------------------------------------------
# Multiclass: softmax regression over the same hashed space
# ---------------------------------------------------------------------------

def init_sparse_softmax(n_buckets: int, d_num: int, n_classes: int,
                        device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {"table": torch.zeros((n_buckets, n_classes), device=dev),
            "dense": torch.zeros((d_num, n_classes), device=dev),
            "bias": torch.zeros((n_classes,), device=dev)}


def sparse_softmax_logits(params, idx: torch.Tensor, Xnum: torch.Tensor
                          ) -> torch.Tensor:
    """(n, C) logits: per-class table gather-sum + dense product-and-sum."""
    return (params["table"][idx].sum(dim=1)
            + (Xnum[:, :, None] * params["dense"][None]).sum(dim=1)
            + params["bias"])


def softmax_epoch(params, acc, idx, Xnum, y, w, lr, l2,
                  batch_size: int):
    """One Adagrad pass of softmax regression (the shared update and
    lazy-L2 policy; the (B, C) table takes the touched mask over its
    class axis)."""
    idx, X, y = _chunk_tensors(idx, Xnum, y, params["table"].device)
    w = torch.as_tensor(w, device=X.device).to(torch.float32)
    _adagrad_epoch_b(_softmax_grads, _one(params), _one(acc), idx, X, y,
                     w[None], lr, l2, batch_size)
    return params, acc


def fit_sparse_softmax(idx: np.ndarray, Xnum: np.ndarray, y: np.ndarray,
                       w: np.ndarray, n_buckets: int, n_classes: int,
                       lr: float = 0.05, l2: float = 0.0, epochs: int = 2,
                       batch_size: int = 8192, device=None
                       ) -> Dict[str, np.ndarray]:
    """Fit multiclass softmax on device-resident data (y = class ids)."""
    _check_class_ids(y, n_classes)
    c = _pad_chunk({"idx": idx, "num": Xnum, "y": y, "w": w}, batch_size)
    params = init_sparse_softmax(n_buckets, np.shape(c["num"])[1],
                                 n_classes, device)
    acc = _zero_like_acc(params)
    dev = params["table"].device
    it, Xt, yt = _chunk_tensors(c["idx"], c["num"], c["y"], dev)
    wt = torch.as_tensor(c["w"], device=dev).to(torch.float32)
    for _ in range(epochs):
        softmax_epoch(params, acc, it, Xt, yt, wt, float(lr), float(l2),
                      batch_size)
    return _numpy(params)


def fit_sparse_softmax_streaming(chunk_factory, n_buckets: int,
                                 d_num: int, n_classes: int,
                                 lr: float = 0.05, l2: float = 0.0,
                                 epochs: int = 1, batch_size: int = 8192,
                                 buffer_size: int = 2,
                                 checkpoint_dir: Optional[str] = None,
                                 checkpoint_every: int = 8, device=None
                                 ) -> Dict[str, np.ndarray]:
    """Streaming softmax fit (chunk "y" carries class ids, validated per
    chunk before transfer)."""
    chunk_factory = _checked_class_chunks(chunk_factory, n_classes)
    dev = resolve_device(device)
    params = init_sparse_softmax(n_buckets, d_num, n_classes, dev)
    acc = _zero_like_acc(params)
    params, acc = _run_streaming_fit(
        (params, acc),
        _adagrad_stream_step(_softmax_grads, lr, l2, batch_size),
        chunk_factory, epochs, batch_size, buffer_size, dev,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        checkpoint_token=f"softmax|B={n_buckets},d={d_num},C={n_classes},"
                         f"lr={lr},l2={l2},bs={batch_size},ep={epochs}")
    return _numpy(params)


def _predict_device(params, device) -> Tuple[Dict[str, torch.Tensor],
                                             torch.device]:
    """The parameter pytree as tensors on its scoring device: tensors
    stay where they are (``device`` moves them), numpy pytrees go to
    ``device`` (None: CUDA, raising without a card)."""
    if any(isinstance(v, torch.Tensor) for v in params.values()):
        dev = (torch.device(device) if device is not None
               else _params_device(params))
        return params_on(params, dev), dev
    dev = resolve_device(device)
    return params_from_numpy(params, dev), dev


def predict_sparse_softmax(params, idx: np.ndarray, Xnum: np.ndarray,
                           device=None) -> np.ndarray:
    p, dev = _predict_device(params, device)
    it, Xt = _rows(idx, Xnum, dev)
    with torch.inference_mode():
        return torch.softmax(sparse_softmax_logits(p, it, Xt),
                             dim=1).cpu().numpy()


# ---------------------------------------------------------------------------
# FTRL-Proximal (McMahan et al. 2013)
# ---------------------------------------------------------------------------

def init_sparse_ftrl(n_buckets: int, d_num: int, device=None
                     ) -> Dict[str, Any]:
    zero = init_sparse_lr(n_buckets, d_num, device)
    return {"z": zero, "n": {k: torch.zeros_like(v)
                             for k, v in zero.items()}}


def ftrl_weights(state, alpha, beta, l1, l2) -> Dict[str, torch.Tensor]:
    """Materialize one model's weights from (z, n): w = 0 where
    |z| <= l1, else the closed-form FTRL-Proximal minimizer."""
    return {k: _ftrl_w(state["z"][k], state["n"][k], alpha, beta, l1, l2)
            for k in state["z"]}


def ftrl_epoch(state, idx, Xnum, y, w, alpha, beta, l1, l2,
               batch_size: int):
    """One FTRL-Proximal pass over device-resident data, in place."""
    idx, X, y = _chunk_tensors(idx, Xnum, y,
                               state["z"]["table"].device)
    w = torch.as_tensor(w, device=X.device).to(torch.float32)
    _ftrl_epoch_b(_one(state), idx, X, y, w[None], alpha, beta, l1, l2,
                  batch_size)
    return state


def fit_sparse_ftrl(idx: np.ndarray, Xnum: np.ndarray, y: np.ndarray,
                    w: np.ndarray, n_buckets: int, alpha: float = 0.1,
                    beta: float = 1.0, l1: float = 0.0, l2: float = 0.0,
                    epochs: int = 2, batch_size: int = 8192, device=None
                    ) -> Dict[str, np.ndarray]:
    """Fit FTRL; returns MATERIALIZED weights in the {table, dense, bias}
    shape of fit_sparse_lr, so prediction is family-agnostic."""
    c = _pad_chunk({"idx": idx, "num": Xnum, "y": y, "w": w}, batch_size)
    state = init_sparse_ftrl(n_buckets, np.shape(c["num"])[1], device)
    dev = state["z"]["table"].device
    it, Xt, yt = _chunk_tensors(c["idx"], c["num"], c["y"], dev)
    wt = torch.as_tensor(c["w"], device=dev).to(torch.float32)
    hy = tuple(float(v) for v in (alpha, beta, l1, l2))
    for _ in range(epochs):
        ftrl_epoch(state, it, Xt, yt, wt, *hy, batch_size)
    return _numpy(ftrl_weights(state, *hy))


def fit_sparse_ftrl_streaming(chunk_factory, n_buckets: int, d_num: int,
                              alpha: float = 0.1, beta: float = 1.0,
                              l1: float = 0.0, l2: float = 0.0,
                              epochs: int = 1, batch_size: int = 8192,
                              buffer_size: int = 2,
                              checkpoint_dir: Optional[str] = None,
                              checkpoint_every: int = 8, device=None
                              ) -> Dict[str, np.ndarray]:
    """Streaming FTRL fit (same chunk contract as
    fit_sparse_lr_streaming)."""
    dev = resolve_device(device)
    state = init_sparse_ftrl(n_buckets, d_num, dev)
    hy = tuple(float(v) for v in (alpha, beta, l1, l2))

    def step(state, chunk):
        idx, X, y = _chunk_tensors(chunk["idx"], chunk["num"], chunk["y"],
                                   dev)
        w = chunk["w"].to(torch.float32)
        _ftrl_epoch_b(_one(state), idx, X, y, w[None], *hy, batch_size)
        return state

    state = _run_streaming_fit(
        state, step, chunk_factory, epochs, batch_size, buffer_size, dev,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        checkpoint_token=f"ftrl|B={n_buckets},d={d_num},a={alpha},"
                         f"b={beta},l1={l1},l2={l2},bs={batch_size},"
                         f"ep={epochs}")
    return _numpy(ftrl_weights(state, *hy))


# ---------------------------------------------------------------------------
# Prediction: one row-independent head for every binary family
# ---------------------------------------------------------------------------

def sparse_binary_probs(params: Dict[str, torch.Tensor], idx: torch.Tensor,
                        Xnum: torch.Tensor) -> torch.Tensor:
    """(n, 2) probabilities of one fitted binary model (LR, FTRL's
    materialized weights, or an FM when ``emb`` is present), as a
    two-way softmax of the logit: the same bits for a row alone or in
    any batch."""
    logit_fn = sparse_fm_logits if "emb" in params else sparse_logits
    return sigmoid_pair(logit_fn(params, idx.to(torch.int64),
                                 Xnum.to(torch.float32)))


def predict_sparse_lr(params, idx: np.ndarray, Xnum: np.ndarray,
                      device=None) -> np.ndarray:
    """Family-agnostic sparse prediction -> (n, 2) host probabilities,
    scored on the parameters' device (numpy parameters: ``device``)."""
    p, dev = _predict_device(params, device)
    it, Xt = _rows(idx, Xnum, dev)
    with torch.inference_mode():
        return sparse_binary_probs(p, it, Xt).cpu().numpy()


def predict_sparse_lr_chunked(params, idx: np.ndarray, Xnum: np.ndarray,
                              chunk_rows: int = 1_000_000,
                              device=None) -> np.ndarray:
    """Chunked prediction: device residency bounded by chunk_rows, so
    the selector's evaluation passes honor the same device budget as
    its sweep and refit (probabilities accumulate on the host)."""
    p, dev = _predict_device(params, device)
    step = max(int(chunk_rows), 1)
    outs = [predict_sparse_lr(p, idx[s:s + step], Xnum[s:s + step])
            for s in range(0, len(idx), step)]
    return outs[0] if len(outs) == 1 else np.concatenate(outs)


# ---------------------------------------------------------------------------
# Stage integration: (label, SparseIndices, OPVector numerics) -> Prediction
# ---------------------------------------------------------------------------

class SparseLogisticModel(TernaryTransformer):
    """A fitted binary sparse model (LR, FTRL or FM weights) ->
    Prediction, its tensors on the model's device."""
    in_types = (ft.RealNN, ft.SparseIndices, ft.OPVector)
    out_type = ft.Prediction
    operation_name = "sparseLR"
    #: the device fn's probability head: "binary" or "multiclass"
    _problem = "binary"

    def __init__(self, model_params: Optional[Dict[str, Any]] = None,
                 uid=None, **kw):
        super().__init__(uid=uid, **kw)
        mp = model_params or {}
        if any(not isinstance(v, torch.Tensor) for v in mp.values()):
            mp = params_from_numpy(mp, "cpu")
        self.model_params = dict(mp)

    @property
    def device(self) -> torch.device:
        return _params_device(self.model_params)

    def to(self, device) -> "SparseLogisticModel":
        self.model_params = params_on(self.model_params,
                                      torch.device(device))
        return self

    def extra_state_json(self):
        return {"model_params": params_to_numpy(self.model_params)}

    def load_extra_state(self, d):
        self.model_params = params_from_numpy(d.get("model_params", {}),
                                              "cpu")

    def _probs(self, idx: torch.Tensor, Xnum: torch.Tensor) -> torch.Tensor:
        return sparse_binary_probs(self.model_params, idx, Xnum)

    def predict_probs(self, idx: np.ndarray, Xnum: np.ndarray) -> np.ndarray:
        it, Xt = _rows(idx, Xnum, self.device)
        with torch.inference_mode():
            return self._probs(it, Xt).cpu().numpy()

    def _transform_columns(self, ds: Dataset):
        idx = ds.column(self.input_names[1])
        Xn = ds.column(self.input_names[2]).astype(np.float32)
        return (prediction_column(self.predict_probs(idx, Xn),
                                  self._problem), ft.Prediction, None)

    def make_device_fn(self):
        """Scorer tail: fn(label, idx, Xnum) -> (n, k) probabilities (the
        label input is a response placeholder, ignored at score time)."""
        def fn(label, idx, Xnum):
            return self._probs(idx.to(torch.int64), Xnum.to(torch.float32))
        return fn

    def portable_spec(self):
        return {"op": "sparse_predict",
                "arrays": {"params": params_to_numpy(self.model_params)}}

    def transform_value(self, label, sidx: ft.SparseIndices,
                        vec: ft.OPVector):
        idx = np.asarray([sidx.value], np.int32)
        Xn = np.asarray([vec.value], np.float32)
        return ft.Prediction(prediction_column(self.predict_probs(idx, Xn),
                                               self._problem)[0])


class _SparseInputs:
    """Mixin of the sparse estimators: (label, SparseIndices, OPVector)
    inputs, fitted on ``device`` (a transient attribute, never
    persisted; None: CUDA, raising without a card;
    ``Workflow.train(device=...)`` sets it). Not a stage itself, so the
    stage registry holds only the estimators, as the JAX one does."""
    in_types = (ft.RealNN, ft.SparseIndices, ft.OPVector)
    out_type = ft.Prediction

    def _inputs(self, ds: Dataset):
        y = ds.column(self.input_names[0]).astype(np.float32)
        idx = ds.column(self.input_names[1])
        Xn = ds.column(self.input_names[2]).astype(np.float32)
        return y, idx, Xn

    def _make_model(self, model_args):
        mp = model_args.pop("model_params")
        extra = {k: model_args.pop(k) for k in ("summary", "wall_seconds")
                 if k in model_args}
        model = super()._make_model(model_args)
        model.model_params = params_from_numpy(
            mp, resolve_device(self.device))
        for k, v in extra.items():
            setattr(model, k, v)
        return model


class SparseLogisticRegression(_SparseInputs, TernaryEstimator):
    """Hashed-feature LR estimator for the selector-free CTR flow (one
    configuration; sweeps run through validate_sparse_grid)."""
    operation_name = "sparseLR"
    model_cls = SparseLogisticModel

    def __init__(self, num_buckets: int = 1 << 20, lr: float = 0.05,
                 l2: float = 0.0, epochs: int = 2, batch_size: int = 8192,
                 uid=None, device=None, **kw):
        super().__init__(uid=uid, num_buckets=int(num_buckets), lr=lr,
                         l2=l2, epochs=int(epochs),
                         batch_size=int(batch_size), **kw)
        self.device = device

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        y, idx, Xn = self._inputs(ds)
        p = self.params
        params = fit_sparse_lr(idx, Xn, y, np.ones_like(y),
                               p["num_buckets"], p["lr"], p["l2"],
                               p["epochs"], p["batch_size"],
                               device=self.device)
        return {"model_params": params}


class SparseSoftmaxModel(SparseLogisticModel):
    """Fitted multiclass softmax over hashed features -> Prediction."""
    operation_name = "sparseSoftmax"
    _problem = "multiclass"

    def _probs(self, idx, Xnum):
        return torch.softmax(sparse_softmax_logits(
            self.model_params, idx, Xnum), dim=1)

    def portable_spec(self):
        return {"op": "sparse_softmax",
                "arrays": {"params": params_to_numpy(self.model_params)}}


class SparseSoftmaxRegression(_SparseInputs, TernaryEstimator):
    """Multiclass softmax estimator over hashed features; n_classes=0
    infers the class count from the labels at fit time."""
    operation_name = "sparseSoftmax"
    model_cls = SparseSoftmaxModel

    def __init__(self, num_buckets: int = 1 << 20, n_classes: int = 0,
                 lr: float = 0.05, l2: float = 0.0, epochs: int = 2,
                 batch_size: int = 8192, uid=None, device=None, **kw):
        super().__init__(uid=uid, num_buckets=int(num_buckets),
                         n_classes=int(n_classes), lr=lr, l2=l2,
                         epochs=int(epochs), batch_size=int(batch_size),
                         **kw)
        self.device = device

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        y, idx, Xn = self._inputs(ds)
        p = self.params
        n_classes = p["n_classes"] or int(y.max()) + 1
        params = fit_sparse_softmax(idx, Xn, y, np.ones_like(y),
                                    p["num_buckets"], n_classes, p["lr"],
                                    p["l2"], p["epochs"], p["batch_size"],
                                    device=self.device)
        return {"model_params": params}


class SparseSelectedModel(SparseLogisticModel):
    """Fitted sparse selector output; carries the ModelSelectorSummary-
    shaped report like the dense SelectedModel does."""

    operation_name = "sparseModelSelected"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.summary: Dict[str, Any] = {}
        #: host-clock walls of the fit that made this model (transient:
        #: a loaded model has none)
        self.wall_seconds: Dict[str, Any] = {}

    def extra_state_json(self):
        d = super().extra_state_json()
        d["summary"] = self.summary
        return d

    def load_extra_state(self, d):
        super().load_extra_state(d)
        self.summary = d.get("summary", {})


class SparseModelSelector(_SparseInputs, TernaryEstimator):
    """Criteo-scale AutoML front door: (label, SparseIndices, OPVector)
    -> Prediction with model selection over the hashed-family grid.

    The whole (family x fold x hyper) sweep is one instance-axis state
    per family, and both the sweep and the winner's multi-epoch refit
    read the SAME chunk iterator, so device residency is bounded by
    one chunk of ``chunk_rows`` rows plus the sweep's states. Training
    rows longer than one chunk stream through the double-buffered
    host->device prefetch (io/stream) at every pass. Training rows that
    fit in one chunk (the default splitter's 1M rows at the default
    ``chunk_rows``) are built and copied to the device once and held
    for the fit: every family's passes and the refit's epochs read that
    chunk. ``SparseModelSelector.chunks_built`` counts the training
    chunks built on the host, ``SparseModelSelector.held_passes`` the
    passes fed from a held chunk. Families: Adagrad hashed-LR,
    FTRL-Proximal and a second-order hashed FM (fm_dim embedding width);
    the summary has the JAX package's shape (validationResults /
    bestModel / trainEvaluation / holdoutEvaluation /
    fieldContributions); the fitted model carries ``wall_seconds`` (each
    family's sweep and the refit, host clock) beside it, transient, as
    the dense selector's does."""

    operation_name = "sparseModelSelected"
    model_cls = SparseSelectedModel
    #: training chunks built on the host, and passes (sweep epochs,
    #: evaluation passes, refit epochs) fed from a held chunk
    chunks_built = 0
    held_passes = 0

    def __init__(self, num_buckets: int = 1 << 20,
                 grid: Optional[Iterable[Dict[str, float]]] = None,
                 n_folds: int = 2, epochs: int = 1, refit_epochs: int = 2,
                 batch_size: int = 8192, chunk_rows: int = 1_000_000,
                 reserve_fraction: float = 0.1, seed: int = 42,
                 fm_dim: int = 8,
                 splitter: Optional[Dict[str, Any]] = None,
                 checkpoint_dir: Optional[str] = None,
                 uid=None, device=None, **kw):
        grid = list(grid) if grid is not None else (
            [{"family": "adagrad", "lr": lr, "l2": l2}
             for lr in (0.02, 0.05, 0.1) for l2 in (0.0, 1e-6)]
            + [{"family": "ftrl", "alpha": a, "l1": l1}
               for a in (0.1, 0.3) for l1 in (0.0, 1e-3)]
            + [{"family": "fm", "lr": 0.05, "l2": 0.0}])
        if int(n_folds) < 2:   # fail at the API boundary, not mid-sweep
            raise ValueError("n_folds must be >= 2: with one fold the "
                             "train mask (fold != f) would be empty")
        super().__init__(uid=uid, num_buckets=int(num_buckets), grid=grid,
                         n_folds=int(n_folds), epochs=int(epochs),
                         refit_epochs=int(refit_epochs),
                         batch_size=int(batch_size),
                         chunk_rows=int(chunk_rows),
                         reserve_fraction=float(reserve_fraction),
                         seed=int(seed), fm_dim=int(fm_dim),
                         splitter=dict(splitter or {}),
                         checkpoint_dir=checkpoint_dir, **kw)
        self.device = device

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        with TRACER.region("selector.fit", root="fit"):
            return self._fit(ds)

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        from .tuning import make_splitter

        p = self.params
        dev = resolve_device(self.device)
        with TRACER.region("selector.split"):
            y, idx, Xn = self._inputs(ds)
            idx = idx.astype(np.int32)
            if any(g.get("family") == "softmax" for g in p["grid"]):
                raise ValueError(
                    "SparseModelSelector is the binary CTR front door; for "
                    "multiclass fit SparseSoftmaxRegression directly "
                    "(hyper sweeps via validate_sparse_grid with "
                    "family='softmax')")
            spec = dict(p.get("splitter") or {})
            spec.setdefault("reserve_fraction", p["reserve_fraction"])
            splitter = make_splitter(spec, p["seed"])
            train_i, hold_i = splitter.split(len(y))
            base_w, splitter_summary = splitter.prepare(y[train_i])

        # ONE chunk iterator serves both the validation sweep and the
        # winner's refit: device residency is bounded by chunk_rows for
        # the whole fit
        def chunks():
            for s in range(0, len(train_i), p["chunk_rows"]):
                sl = train_i[s:s + p["chunk_rows"]]
                SparseModelSelector.chunks_built += 1
                yield {"idx": idx[sl], "num": Xn[sl], "y": y[sl],
                       "w": base_w[s:s + p["chunk_rows"]]}

        # a one-chunk stream is the same bytes at every pass: prepare
        # and copy it once, and every pass of the fit reads it
        held = (_device_chunks(chunks, p["n_folds"], p["seed"],
                               p["batch_size"], dev)
                if len(train_i) <= p["chunk_rows"] else None)

        def passes_of(device_chunks):
            def passes():
                SparseModelSelector.held_passes += 1
                return iter(device_chunks)
            return passes

        report = validate_sparse_grid_streaming(
            chunks, p["grid"], p["num_buckets"], Xn.shape[1],
            n_folds=p["n_folds"], epochs=p["epochs"],
            batch_size=p["batch_size"], seed=p["seed"],
            fm_dim=p["fm_dim"], device=dev,
            prepared=None if held is None else passes_of(held))
        best = report["best_hyper"]
        best_family = best.pop("family", "adagrad")
        # the refit is the selector's long-running stream: mid-stream
        # checkpoint/resume in a per-family subdir
        ck = p.get("checkpoint_dir")
        ck = os.path.join(ck, f"refit_{best_family}") if ck else None

        with TRACER.region("selector.refit", family=best_family):
            t0 = time.perf_counter()
            params = self._refit(
                chunks if held is None else passes_of(
                    [{k: v for k, v in c.items() if k != "fold"}
                     for c in held]),
                best_family, best, Xn.shape[1], ck, dev)
            refit_s = time.perf_counter() - t0
            held = None     # its memory is free for the evaluation
            train_eval, holdout_eval, field_contrib = self._evaluate(
                params, idx, Xn, y, train_i, hold_i, dev)

        summary = {
            "problem": "binary",
            "fieldContributions": field_contrib,
            "validationType": {"type": "crossValidation",
                               "folds": p["n_folds"], "metric": "logloss"},
            "splitterSummary": splitter_summary.to_json(),
            "validationResults": [
                {"family": SPARSE_FAMILY_LABELS[g.get("family", "adagrad")],
                 "hyper": {k: v for k, v in g.items() if k != "family"},
                 "logloss": report["logloss"][i]}
                for i, g in enumerate(report["grid"])],
            "bestModel": {"family": SPARSE_FAMILY_LABELS[best_family],
                          "hyper": dict(best),
                          "validationMetric": {
                              "logloss":
                                  report["logloss"][report["best_index"]]}},
            "trainEvaluation": train_eval,
            "holdoutEvaluation": holdout_eval,
            "dataCounts": {"train": int(len(train_i)),
                           "holdout": int(len(hold_i)),
                           "buckets": int(p["num_buckets"])},
        }
        return {"model_params": params, "summary": summary,
                "wall_seconds": {"families": report["wall_seconds"],
                                 "refit": refit_s}}

    def _refit(self, chunks, best_family: str, best: Dict[str, Any],
               d_num: int, ck: Optional[str], dev) -> Dict[str, np.ndarray]:
        """The winner's streamed refit on every training chunk."""
        p = self.params
        with TRACER.region("sparse.refit", family=best_family):
            if best_family == "fm":
                hy = dict(_FM_DEFAULTS, **best)
                return fit_sparse_fm_streaming(
                    chunks, p["num_buckets"], d_num, k=p["fm_dim"],
                    lr=hy["lr"], l2=hy["l2"], epochs=p["refit_epochs"],
                    batch_size=p["batch_size"], seed=p["seed"],
                    checkpoint_dir=ck, device=dev)
            if best_family == "ftrl":
                hy = dict(_FTRL_DEFAULTS, **best)
                return fit_sparse_ftrl_streaming(
                    chunks, p["num_buckets"], d_num,
                    alpha=hy["alpha"], beta=hy["beta"], l1=hy["l1"],
                    l2=hy["l2"], epochs=p["refit_epochs"],
                    batch_size=p["batch_size"], checkpoint_dir=ck,
                    device=dev)
            return fit_sparse_lr_streaming(
                chunks, p["num_buckets"], d_num, lr=best["lr"],
                l2=best["l2"], epochs=p["refit_epochs"],
                batch_size=p["batch_size"], checkpoint_dir=ck, device=dev)

    def _evaluate(self, params, idx, Xn, y, train_i, hold_i, dev):
        """(train metrics, holdout metrics, per-field contributions) of
        the refit model."""
        from .selector import _full_metrics
        p = self.params

        def metrics(rows):
            probs = predict_sparse_lr_chunked(
                params, idx[rows], Xn[rows], p["chunk_rows"], device=dev)
            return _full_metrics(
                "binary", torch.as_tensor(probs, device=dev),
                torch.as_tensor(y[rows], device=dev))

        train_eval = metrics(train_i)
        holdout_eval = metrics(hold_i) if len(hold_i) else {}

        # per-FIELD contribution: mean |table weight| (plus mean emb row
        # norm for FM winners) over each index column's observed buckets,
        # on a seeded random sample (CTR logs are time-ordered, so a
        # prefix would see the earliest traffic only)
        if len(train_i) > 200_000:
            sample = np.random.default_rng(p["seed"]).choice(
                train_i, 200_000, replace=False)
        else:
            sample = train_i
        tbl = np.abs(np.asarray(params["table"]))
        field_contrib = [float(np.mean(tbl[idx[sample, k]]))
                         for k in range(idx.shape[1])]
        if "emb" in params:
            en = np.linalg.norm(np.asarray(params["emb"]), axis=1)
            field_contrib = [c + float(np.mean(en[idx[sample, k]]))
                             for k, c in enumerate(field_contrib)]
        return train_eval, holdout_eval, field_contrib


# ---------------------------------------------------------------------------
# Grid validation — chunk-streamed; folds from a deterministic hash of
# the GLOBAL row index (splitmix64), so streamed chunks agree across
# epochs and the validation pass without a permutation of n rows.
# ---------------------------------------------------------------------------

SPARSE_FAMILY_LABELS = {"adagrad": "SparseLogisticRegression",
                        "ftrl": "SparseFTRL",
                        "fm": "SparseFactorizationMachine",
                        "softmax": "SparseSoftmaxRegression"}
_FTRL_DEFAULTS = {"alpha": 0.1, "beta": 1.0, "l1": 0.0, "l2": 0.0}
_FM_DEFAULTS = {"lr": 0.05, "l2": 0.0}
_SOFTMAX_DEFAULTS = {"lr": 0.05, "l2": 0.0}


def _checked_class_chunks(chunk_factory, n_classes: int):
    """Wrap a chunk factory so every chunk's class ids validate BEFORE
    transfer — shared by every streamed softmax consumer."""
    def factory():
        for c in chunk_factory():
            _check_class_ids(c["y"], n_classes)
            yield c

    return factory


def _check_class_ids(y, n_classes: int) -> None:
    """Class-id labels must be INTEGER values in [0, n_classes)."""
    y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
    if not len(y):
        return
    lo, hi = float(np.min(y)), float(np.max(y))
    if not (0 <= lo and hi < n_classes):
        raise ValueError(f"label ids must lie in [0, {n_classes}); got "
                         f"range [{lo}, {hi}]")
    if not np.all(y == np.floor(y)):
        raise ValueError("label ids must be integer-valued class ids; "
                         "got fractional labels")


def _fold_ids(start: int, n: int, n_folds: int, seed: int) -> np.ndarray:
    """fold id per global row index in [start, start+n) via splitmix64
    (the JAX package's function, bit for bit)."""
    x = np.arange(start, start + n, dtype=np.uint64)
    x = (x + np.uint64(seed) * np.uint64(0x9E3779B9) + np.uint64(1)) \
        * np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(31)
    return (x % np.uint64(max(n_folds, 1))).astype(np.int32)


def _prepared_chunks(chunk_factory, n_folds: int, seed: int,
                     batch_size: int):
    """chunk_factory chunks + a 'fold' column from the global row offset,
    padded to a batch_size multiple and tail-unified (w=0 padding: no
    gradient, no fold weight)."""
    def with_folds():
        offset = 0
        for c in chunk_factory():
            n = len(c["y"])
            c = dict(c)
            c["fold"] = _fold_ids(offset, n, n_folds, seed)
            offset += n
            yield _pad_chunk(c, batch_size)

    return _uniform_chunks(with_folds())


def _device_chunks(chunk_factory, n_folds: int, seed: int,
                   batch_size: int, device) -> list:
    """The prepared chunks (:func:`_prepared_chunks`), copied to
    ``device`` once through the prefetch and kept, for a caller that
    reads them at every pass."""
    from ..io.stream import prefetch_to_device

    return list(prefetch_to_device(
        _prepared_chunks(chunk_factory, n_folds, seed, batch_size),
        device=device))


def _binary_row_loss(W, idx, X, y, logit_fn):
    p1 = torch.clamp(torch.sigmoid(logit_fn(W, idx, X)), 1e-6, 1 - 1e-6)
    return -(y * torch.log(p1) + (1 - y) * torch.log(1 - p1))


def _family_sweep_def(family: str, fm_dim: int, n_classes: int):
    """(hyper keys, init_state(n_buckets, d_num, seed, emb, device) ->
    one JAX-shaped state, advance(state_b, hyper_b, idx, X, y, w_tr,
    batch_size), weights(state_b, hyper_b), row_loss(W_b, idx, X, y))
    for one sparse family on the instance axis."""

    def row_loss(W, idx, X, y):            # default: binary logloss
        return _binary_row_loss(W, idx, X, y, _linear_logits)

    if family in ("adagrad", "fm", "softmax"):
        keys = ("lr", "l2")
        grad_fn = {"adagrad": _lr_grads, "fm": _fm_grads,
                   "softmax": _softmax_grads}[family]

        def advance(state, hyper, idx, X, y, w, batch_size):
            _adagrad_epoch_b(grad_fn, state[0], state[1], idx, X, y, w,
                             hyper[0], hyper[1], batch_size)

        def weights(state, hyper):
            return state[0]

        if family == "adagrad":
            def init_state(n_buckets, d_num, seed, emb, device):
                zero = init_sparse_lr(n_buckets, d_num, device)
                return (zero, _zero_like_acc(zero))
        elif family == "fm":
            def init_state(n_buckets, d_num, seed, emb, device):
                zero = init_sparse_fm(n_buckets, d_num, fm_dim, seed,
                                      emb=emb, device=device)
                return (zero, _zero_like_acc(zero))

            def row_loss(W, idx, X, y):
                return _binary_row_loss(W, idx, X, y, _fm_logits)
        else:
            # multiclass sweep: per-class tables, CE validation loss
            if n_classes < 2:
                raise ValueError("softmax sweeps need n_classes >= 2")

            def init_state(n_buckets, d_num, seed, emb, device):
                zero = init_sparse_softmax(n_buckets, d_num, n_classes,
                                           device)
                return (zero, _zero_like_acc(zero))

            def row_loss(W, idx, X, y):
                logp = torch.log_softmax(_linear_logits(W, idx, X), dim=-1)
                lab = y.to(torch.int64)[None, :, None].expand(
                    logp.shape[0], -1, 1)
                return -torch.gather(logp, 2, lab)[..., 0]
    elif family == "ftrl":
        keys = ("alpha", "beta", "l1", "l2")

        def init_state(n_buckets, d_num, seed, emb, device):
            return init_sparse_ftrl(n_buckets, d_num, device)

        def advance(state, hyper, idx, X, y, w, batch_size):
            _ftrl_epoch_b(state, idx, X, y, w, *hyper, batch_size)

        def weights(state, hyper):
            return _ftrl_weights_b(state, *hyper)
    else:
        raise ValueError(f"unknown sparse family {family!r}; "
                         f"one of {sorted(SPARSE_FAMILY_LABELS)}")
    return keys, init_state, advance, weights, row_loss


def _broadcast_state(tree, I: int):
    """A JAX-shaped state copied to every one of I instances."""
    if isinstance(tree, dict):
        return {k: _broadcast_state(v, I) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_broadcast_state(v, I) for v in tree)
    return tree.unsqueeze(0).expand((I,) + tuple(tree.shape)).contiguous()


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without a sync (pinned copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _sweep_family_streaming(family: str, chunk_factory, hypers,
                            n_buckets: int, d_num: int, n_folds: int,
                            epochs: int, batch_size: int, seed: int,
                            buffer_size: int = 2,
                            fm_dim: int = 8, n_classes: int = 0,
                            device=None, fm_emb=None,
                            prepared=None) -> np.ndarray:
    """Mean validation logloss per hyper for ONE family, streamed.

    The (fold x hyper) grid is the leading instance axis of the
    optimizer state (instance i = fold * G + g); each chunk advances ALL
    instances with that instance's train weights (fold != its fold id),
    then one more streaming pass accumulates per-instance (sum logloss,
    sum weight) over the held-out rows. The per-chunk sums stay on the
    device until the family ends (one host read a family). Every pass
    reads ``prepared()`` where given (chunks the caller prepared on the
    device), else ``chunk_factory``'s chunks, prepared and copied anew."""
    from ..io.stream import prefetch_to_device

    dev = resolve_device(device)
    G, F = len(hypers), n_folds
    GF = G * F
    keys, init_state, advance, weights, row_loss = _family_sweep_def(
        family, fm_dim, n_classes)
    if family == "softmax" and prepared is None:
        chunk_factory = _checked_class_chunks(chunk_factory, n_classes)
    state_b = _broadcast_state(
        init_state(n_buckets, d_num, seed, fm_emb, dev), GF)
    hyper_b = tuple(
        _upload(np.tile(np.asarray([float(h[k]) for h in hypers],
                                   np.float32), F), dev) for k in keys)
    fold_b = _upload(np.repeat(np.arange(F, dtype=np.int32), G), dev)

    if prepared is not None:
        passes = prepared
    else:
        passes = lambda: prefetch_to_device(
            _prepared_chunks(chunk_factory, n_folds, seed, batch_size),
            buffer_size, device=dev)

    def split(chunk):
        idx, X, y = _chunk_tensors(chunk["idx"], chunk["num"], chunk["y"],
                                   dev)
        return idx, X, y, chunk["w"].to(torch.float32), chunk["fold"]

    with torch.no_grad():
        for _ in range(epochs):
            for chunk in passes():
                idx, X, y, w, fold = split(chunk)
                w_tr = w[None] * (fold[None] != fold_b[:, None])
                advance(state_b, hyper_b, idx, X, y, w_tr, batch_size)

        with TRACER.region("sparse.eval", family=family):
            sums = []
            for chunk in passes():
                idx, X, y, w, fold = split(chunk)
                ll = row_loss(weights(state_b, hyper_b), idx, X, y)
                w_val = w[None] * (fold[None] == fold_b[:, None])
                sums.append(torch.stack([(w_val * ll).sum(dim=1),
                                         w_val.sum(dim=1)]))
            per_chunk = torch.stack(sums).cpu().numpy().astype(np.float64)
    ll_sum = np.zeros(GF)
    w_sum = np.zeros(GF)
    for s, w in per_chunk:         # f32 chunk sums, accumulated in f64
        ll_sum += s
        w_sum += w
    per_instance = ll_sum / np.maximum(w_sum, 1e-9)
    return per_instance.reshape(F, G).mean(axis=0)


def validate_sparse_grid_streaming(chunk_factory, grid, n_buckets: int,
                                   d_num: int, n_folds: int = 2,
                                   epochs: int = 1, batch_size: int = 8192,
                                   seed: int = 42, buffer_size: int = 2,
                                   fm_dim: int = 8,
                                   n_classes: int = 0, device=None,
                                   fm_emb=None, prepared=None
                                   ) -> Dict[str, Any]:
    """Chunk-streamed (fold x hyper x FAMILY) sweep on ``device`` (None:
    CUDA, raising without a card): device residency bounded by one chunk
    + the instance-axis optimizer states, never the dataset. Grid
    entries may carry "family" ("adagrad" default, "ftrl", "fm", or
    "softmax", which needs n_classes >= 2, integer class ids in chunk
    "y" and a grid of ONLY softmax entries); each family sweeps as its
    own homogeneous instance batch and losses merge on the host.
    ``fm_emb`` is an optional initial FM embedding (default: the
    seeded draws). ``prepared`` is an optional factory of passes over
    chunks the caller already prepared on ``device`` (the ``fold``
    column, padded to a batch_size multiple, class ids checked): every
    family's passes read them, and ``chunk_factory`` is not read. The
    report adds ``wall_seconds`` per family (host clock, each family's
    losses read back before its clock stops)."""
    if n_folds < 2:
        raise ValueError("n_folds must be >= 2: with one fold the "
                         "train mask (fold != f) would be empty")
    fams = {g.get("family", "adagrad") for g in grid}
    if "softmax" in fams and fams != {"softmax"}:
        raise ValueError("a grid mixing 'softmax' with binary families "
                         "cannot be ranked on one metric — sweep them "
                         "separately")
    groups: Dict[str, list] = {}
    for i, g in enumerate(grid):
        groups.setdefault(g.get("family", "adagrad"), []).append(i)
    losses = [float("nan")] * len(grid)
    walls: Dict[str, float] = {}
    for fam, idxs in groups.items():
        hypers = [{k: v for k, v in grid[i].items() if k != "family"}
                  for i in idxs]
        if fam == "ftrl":
            hypers = [dict(_FTRL_DEFAULTS, **h) for h in hypers]
        elif fam == "fm":
            hypers = [dict(_FM_DEFAULTS, **h) for h in hypers]
        elif fam == "softmax":
            hypers = [dict(_SOFTMAX_DEFAULTS, **h) for h in hypers]
        t0 = time.perf_counter()
        with TRACER.region("sparse.family", family=fam, items=len(idxs)):
            ll = _sweep_family_streaming(
                fam, chunk_factory, hypers, n_buckets, d_num, n_folds,
                epochs, batch_size, seed, buffer_size, fm_dim, n_classes,
                device=device, fm_emb=fm_emb, prepared=prepared)
        walls[fam] = time.perf_counter() - t0
        for i, l in zip(idxs, ll):
            losses[i] = float(l)
    best = int(np.nanargmin(losses))
    return {"grid": [dict(g) for g in grid], "logloss": losses,
            "best_index": best, "best_hyper": dict(grid[best]),
            "wall_seconds": walls}


def validate_sparse_grid(idx: np.ndarray, Xnum: np.ndarray, y: np.ndarray,
                         grid, n_buckets: int, n_folds: int = 2,
                         epochs: int = 1, batch_size: int = 8192,
                         seed: int = 42,
                         max_device_rows: Optional[int] = None,
                         fm_dim: int = 8,
                         n_classes: int = 0, device=None,
                         fm_emb=None) -> Dict[str, Any]:
    """In-memory front end of the streamed sweep: the arrays are cut into
    max_device_rows chunks and fed through validate_sparse_grid_streaming
    (one code path, one fold assignment). By default they are one chunk,
    prepared and copied to the device once for every pass."""
    n = len(y)
    if n_classes >= 2 and any(g.get("family") == "softmax" for g in grid):
        _check_class_ids(y, n_classes)
    step = int(max_device_rows) if max_device_rows else max(n, 1)
    w = np.ones(n, np.float32)

    def chunks():
        for s in range(0, n, step):
            sl = slice(s, s + step)
            yield {"idx": idx[sl], "num": Xnum[sl], "y": y[sl], "w": w[sl]}

    # no explicit device budget => the data fits; copy it once
    held = (_device_chunks(chunks, n_folds, seed, batch_size, device)
            if max_device_rows is None else None)
    return validate_sparse_grid_streaming(
        chunks, grid, n_buckets, Xnum.shape[1], n_folds=n_folds,
        epochs=epochs, batch_size=batch_size, seed=seed, fm_dim=fm_dim,
        n_classes=n_classes, device=device, fm_emb=fm_emb,
        prepared=None if held is None else lambda: iter(held))
