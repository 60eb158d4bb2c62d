"""The hashed sparse families of the CTR selector, written from their
published update rules, over the selector's own stream of rows.

The stream: the training rows (a seeded split, at most 1,000,000 kept,
10% held out) in chunks of ``chunk_rows``, each padded with zero-weight
rows to a multiple of the batch and to the first chunk's length; each row's
fold is splitmix64 of its index in the stream. A model's logit is the sum of
its K hashed table weights, a dense product and a bias (the FM adds
0.5 * sum_f[(sum_k e_kf)^2 - sum_k e_kf^2]).

* Adagrad (LR and FM): per minibatch the gradient of the weighted mean
  log loss, dz = w (p - y) / sum w (the FM's zero where p is clipped to
  [1e-7, 1 - 1e-7]), scattered to each row's K buckets; lazy L2 on the
  table (and the FM's embeddings) over the buckets a weighted row hit,
  plain L2 on the dense weights, none on the bias; acc (from 1e-6) += g^2,
  p -= lr g / sqrt(acc).
* FTRL-Proximal: weights w = -(z - sign(z) l1) / ((beta + sqrt(n)) / alpha
  + l2) where |z| > l1, else 0; per minibatch the SUM gradient
  g = w_row (p - y); sigma = (sqrt(n + g^2) - sqrt(n)) / alpha;
  z += g - sigma w; n += g^2.
* The sweep: every (fold, grid point) instance steps over every batch of
  every epoch with its rows outside its fold; its validation loss is the
  weighted mean clipped log loss ([1e-6, 1 - 1e-6]) of its fold's rows;
  a grid point's is the mean over folds. The FM's embeddings start at
  0.01 times normal draws from a CPU ``torch.Generator`` seeded with the
  selector's seed. The refit: the winner's family and hypers, 2 epochs
  over the whole stream.

``state_round`` rounds every optimizer state to a lower precision after
each step (the control: state stored in bf16).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

FTRL_DEFAULTS = {"alpha": 0.1, "beta": 1.0, "l1": 0.0, "l2": 0.0}
FM_DEFAULTS = {"lr": 0.05, "l2": 0.0}


def fold_ids(start: int, n: int, n_folds: int, seed: int) -> np.ndarray:
    """splitmix64 of each row's index in the stream, modulo the folds."""
    x = np.arange(start, start + n, dtype=np.uint64)
    x = (x + np.uint64(seed) * np.uint64(0x9E3779B9) + np.uint64(1)) \
        * np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(31)
    return (x % np.uint64(n_folds)).astype(np.int64)


def stream(idx, num, y, w, chunk_rows: int, batch: int, n_folds: int,
           seed: int):
    """The padded chunks: (idx, num, y, w, fold) arrays each."""
    out, offset, target = [], 0, 0
    for s in range(0, len(y), chunk_rows):
        sl = slice(s, s + chunk_rows)
        n = len(y[sl])
        c = [idx[sl], num[sl], y[sl], w[sl],
             fold_ids(offset, n, n_folds, seed)]
        offset += n
        pad = (-n) % batch
        target = target or n + pad
        pad += max(target - (n + pad), 0)
        if pad:
            c = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                 for a in c]
        out.append(c)
    return out


class Model:
    """Instances' parameters (I leading) and their optimizer state."""

    def __init__(self, family, I, B, d, k, seed, dtype, device,
                 round_: Optional[Callable] = None):
        self.family, self.dtype, self.round = family, dtype, round_
        z = {"table": torch.zeros((I, B), dtype=dtype, device=device),
             "dense": torch.zeros((I, d), dtype=dtype, device=device),
             "bias": torch.zeros(I, dtype=dtype, device=device)}
        if family == "fm":
            gen = torch.Generator().manual_seed(int(seed))
            emb = 0.01 * torch.randn((B, k), generator=gen)
            z["emb"] = emb.to(device=device, dtype=dtype)[None].repeat(
                I, 1, 1)
        if family == "ftrl":
            self.z = z
            self.n = {key: torch.zeros_like(v) for key, v in z.items()}
        else:
            self.P = z
            self.A = {key: torch.full_like(v, 1e-6) for key, v in z.items()}

    def weights(self, h) -> Dict[str, torch.Tensor]:
        if self.family != "ftrl":
            return self.P
        out = {}
        for key, z in self.z.items():
            col = (-1,) + (1,) * (z.dim() - 1)
            a, b = h["alpha"].reshape(col), h["beta"].reshape(col)
            l1, l2 = h["l1"].reshape(col), h["l2"].reshape(col)
            den = (b + torch.sqrt(self.n[key])) / a + l2
            out[key] = torch.where(z.abs() > l1,
                                   -(z - torch.sign(z) * l1) / den,
                                   torch.zeros((), dtype=z.dtype,
                                               device=z.device))
        return out


def logits(W, idx, X):
    """(I, b) logits; with the FM, also its sums s and gathered e."""
    z = (W["table"][:, idx].sum(2)
         + (X[None] * W["dense"][:, None, :]).sum(-1) + W["bias"][:, None])
    if "emb" not in W:
        return z, None, None
    e = W["emb"][:, idx]                                  # (I, b, K, k)
    s = e.sum(2)
    return z + 0.5 * (s * s - (e * e).sum(2)).sum(-1), s, e


def _scatter(I, B, idx, vals, tail=()):
    """(I, B, *tail) sums of ``vals`` (I, b[, K], *tail) at each row's K
    buckets."""
    b, K = idx.shape
    if vals.dim() == 2 + len(tail):
        vals = vals[:, :, None].expand((I, b, K) + tail)
    flat = (torch.arange(I, device=idx.device)[:, None] * B
            + idx.reshape(1, -1)).reshape(-1)
    g = torch.zeros((I * B,) + tail, dtype=vals.dtype, device=vals.device)
    g.index_add_(0, flat, vals.reshape((-1,) + tail))
    return g.reshape((I, B) + tail)


def step(m: Model, h, idx, X, y, w):
    """One minibatch of every instance (w (I, b) each one's row weights)."""
    I, B = (m.P if m.family != "ftrl" else m.z)["table"].shape
    W = m.weights(h)
    z, s, e = logits(W, idx, X)
    p = torch.sigmoid(z)
    if m.family == "ftrl":
        dz = w * (p - y)
    else:
        dz = w * (p - y) / torch.clamp_min(w.sum(1, keepdim=True), 1e-9)
        if m.family == "fm":
            dz = torch.where((p > 1e-7) & (p < 1 - 1e-7), dz,
                             torch.zeros((), dtype=dz.dtype,
                                         device=dz.device))
    g = {"table": _scatter(I, B, idx, dz),
         "dense": torch.einsum("ib,bd->id", dz, X), "bias": dz.sum(1)}
    if e is not None:
        de = dz[:, :, None, None] * (s[:, :, None, :] - e)
        g["emb"] = _scatter(I, B, idx, de, (e.shape[-1],))
    if m.family == "ftrl":
        a = h["alpha"]
        for key, gk in g.items():
            col = (-1,) + (1,) * (gk.dim() - 1)
            nk = m.n[key]
            sigma = (torch.sqrt(nk + gk * gk) - torch.sqrt(nk)) \
                / a.reshape(col)
            m.z[key] = m.z[key] + gk - sigma * W[key]
            m.n[key] = nk + gk * gk
            if m.round is not None:
                m.z[key], m.n[key] = m.round(m.z[key]), m.round(m.n[key])
        return
    l2, lr = h["l2"], h["lr"]
    hit = _scatter(I, B, idx, (w > 0).to(dz.dtype)) > 0
    for key in ("table", "emb"):
        if key in g:
            mask = hit.reshape(hit.shape + (1,) * (g[key].dim() - 2))
            col = (-1,) + (1,) * (g[key].dim() - 1)
            g[key] = g[key] + l2.reshape(col) * torch.where(
                mask, m.P[key], torch.zeros((), dtype=dz.dtype,
                                            device=dz.device))
    g["dense"] = g["dense"] + l2[:, None] * m.P["dense"]
    for key, gk in g.items():
        col = (-1,) + (1,) * (gk.dim() - 1)
        m.A[key] = m.A[key] + gk * gk
        m.P[key] = m.P[key] - lr.reshape(col) * gk / torch.sqrt(m.A[key])
        if m.round is not None:
            m.P[key], m.A[key] = m.round(m.P[key]), m.round(m.A[key])


def _hyper(family, hypers: List[Mapping], folds: int, dtype, device):
    base = FTRL_DEFAULTS if family == "ftrl" else FM_DEFAULTS
    keys = ("alpha", "beta", "l1", "l2") if family == "ftrl" else ("lr", "l2")
    return {k: torch.tensor(np.tile([float(dict(base, **hp).get(k, 0.0))
                                     for hp in hypers], folds),
                            dtype=dtype, device=device) for k in keys}


def _tensors(c, dtype, device):
    idx, num, y, w, fold = c
    return (torch.as_tensor(idx, device=device).to(torch.int64),
            torch.as_tensor(num, device=device).to(dtype),
            torch.as_tensor(y, device=device).to(dtype),
            torch.as_tensor(w, device=device).to(dtype),
            torch.as_tensor(fold, device=device))


def sweep(family, hypers, chunks, B, d, k, folds, epochs, batch, seed,
          dtype=torch.float64, device="cpu", round_=None) -> List[float]:
    """Mean validation log loss of each grid point of one family."""
    G = len(hypers)
    I = G * folds
    m = Model(family, I, B, d, k, seed, dtype, device, round_)
    h = _hyper(family, hypers, folds, dtype, device)
    fold_i = torch.arange(folds, device=device).repeat_interleave(G)
    for _ in range(epochs):
        for c in chunks:
            idx, X, y, w, fold = _tensors(c, dtype, device)
            wtr = w[None] * (fold[None] != fold_i[:, None])
            for s in range(0, len(y), batch):
                sl = slice(s, s + batch)
                step(m, h, idx[sl], X[sl], y[sl], wtr[:, sl])
    ll = torch.zeros(I, dtype=torch.float64, device=device)
    ws = torch.zeros(I, dtype=torch.float64, device=device)
    W = m.weights(h)
    for c in chunks:
        idx, X, y, w, fold = _tensors(c, dtype, device)
        for s in range(0, len(y), batch):
            sl = slice(s, s + batch)
            z, _, _ = logits(W, idx[sl], X[sl])
            p = torch.clamp(torch.sigmoid(z), 1e-6, 1 - 1e-6)
            loss = -(y[sl] * torch.log(p) + (1 - y[sl]) * torch.log(1 - p))
            wv = w[sl][None] * (fold[sl][None] == fold_i[:, None])
            ll += (wv * loss).sum(1).to(torch.float64)
            ws += wv.sum(1).to(torch.float64)
    per = (ll / torch.clamp_min(ws, 1e-9)).cpu().numpy().reshape(folds, G)
    return [float(v) for v in per.mean(0)]


def refit(family, hyper, chunks, B, d, k, epochs, batch, seed,
          dtype=torch.float64, device="cpu", round_=None):
    """The winner's weights after ``epochs`` over the whole stream."""
    m = Model(family, 1, B, d, k, seed, dtype, device, round_)
    h = _hyper(family, [hyper], 1, dtype, device)
    for _ in range(epochs):
        for c in chunks:
            idx, X, y, w, _ = _tensors(c, dtype, device)
            for s in range(0, len(y), batch):
                sl = slice(s, s + batch)
                step(m, h, idx[sl], X[sl], y[sl], w[None, sl])
    return {key: v[0] for key, v in m.weights(h).items()}


def score(W, idx, num) -> torch.Tensor:
    """P(label 1) of each row, float64."""
    W = {key: v.to(torch.float64)[None] for key, v in W.items()}
    idx = torch.as_tensor(idx, device=W["table"].device).to(torch.int64)
    X = torch.as_tensor(num, device=W["table"].device).to(torch.float64)
    out = []
    for s in range(0, len(idx), 65536):
        z, _, _ = logits(W, idx[s:s + 65536], X[s:s + 65536])
        out.append(torch.sigmoid(z[0]))
    return torch.cat(out)
