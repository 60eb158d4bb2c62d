"""FT-Transformer: a transformer model family for tabular data.

Counterpart of ``transmogrifai_tpu/models/ft_transformer.py``. Each
numeric feature is tokenized by its own affine map into ``d_model``, a
CLS token is prepended, ``n_layers`` pre-norm transformer blocks run
over the (d+1)-token sequence, and the head reads the CLS
representation (Gorishniy et al., 2021).

The fit is full-batch AdamW for a static ``n_steps``, on an explicit
leading grid axis: every tensor of :meth:`FTTransformerFamily.fit_batch`
holds G instances (folds as weight vectors, ``learningRate`` and
``weightDecay`` as (G,) tensors). Gradients come from
``torch.autograd.grad`` of the sum of the instances' losses (their
parameters are disjoint, so each instance gets its own gradient), and
the optimizer is written out on one flat (G, P) parameter buffer, so a
step's update is a handful of launches whatever the number of parameter
tensors. The steps are a Python loop that reads nothing back to the
host. The fit opens ``torch.inference_mode(False)`` and
``torch.enable_grad()`` itself, so it runs inside the validator's
inference-mode sweep, and returns detached parameters.

Numerics as the reference's: GELU is the tanh approximation
(``jax.nn.gelu``'s default), layer norms use the population variance in
f32 and cast back, the attention logits and softmax are f32, the final
norm and the head stay f32, and Q, K and V come from one (D, 3D)
projection. Attention is written out as batched products (the sequence
is d+1 tokens, too short for a fused attention kernel to pay, and the
f32-softmax contract is explicit this way). The compute dtype
(:func:`ft_dtype`) is ``TM_FT_BF16``'s policy — bf16 on CUDA, f32 on
the CPU — with ``TM_KERNEL_EXACT=1`` pinning f32. Only the tokenizer,
CLS and each layer's projection and feed-forward weights are cast, with
the features.

The reference draws its initial parameters from ``jax.random.PRNGKey(0)``
(one draw for every fold and grid point). The port draws the same
shapes and scales from a CPU ``torch.Generator`` seeded 0, or takes the
draw as ``init`` (a numpy pytree in the reference's layout, as
``_init_params`` returns it), which is how a fit reproduces the JAX
package's. The architecture sizes are class attributes read at fit
time, so a caller (or a test) may set them on the family object.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .base import ModelFamily, ModelStage, tree_leaves, tree_map
from .kernels import env_dtype, kernel_exact

__all__ = ["FTTransformerFamily", "FTTransformerClassifierFamily",
           "FTTransformerRegressorFamily", "OpFTTransformerClassifier",
           "OpFTTransformerRegressor", "ft_dtype"]

#: AdamW constants of the reference (``ft_transformer.py:185``)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: the weights cast to the compute dtype in each layer (the reference's
#: cast list); layer norms and the head never enter a low-precision op
_MM_KEYS = ("wq", "wk", "wv", "wo", "ff1", "ff1_b", "ff2", "ff2_b")


def ft_dtype(device) -> torch.dtype:
    """Compute dtype of the forward's matrix products: f32 under
    ``TM_KERNEL_EXACT=1``, else ``TM_FT_BF16``'s policy ("1" bf16, "0"
    f32, unset: bf16 exactly on CUDA)."""
    if kernel_exact():
        return torch.float32
    return env_dtype("TM_FT_BF16", device)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_params(d: int, d_model: int, n_layers: int, d_ff: int,
                 k_out: int, seed: int = 0) -> Dict[str, Any]:
    """One instance's initial parameters, the reference's shapes,
    scales and key order, drawn from a CPU ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen) * scale

    ones, zeros = torch.ones(d_model), torch.zeros(d_model)
    p: Dict[str, Any] = {
        "tok_w": normal((d, d_model), 0.1),
        "tok_b": normal((d, d_model), 0.02),
        "cls": normal((d_model,), 0.02),
        "head_w": normal((d_model, k_out), 0.02),
        "head_b": torch.zeros(k_out),
        "final_ln": {"g": ones.clone(), "b": zeros.clone()},
        "layers": [],
    }
    s_attn = 1.0 / math.sqrt(d_model)
    for _ in range(n_layers):
        p["layers"].append({
            "wq": normal((d_model, d_model), s_attn),
            "wk": normal((d_model, d_model), s_attn),
            "wv": normal((d_model, d_model), s_attn),
            "wo": normal((d_model, d_model), s_attn),
            "ff1": normal((d_model, d_ff), s_attn),
            "ff1_b": torch.zeros(d_ff),
            "ff2": normal((d_ff, d_model), 1.0 / math.sqrt(d_ff)),
            "ff2_b": zeros.clone(),
            "ln1": {"g": ones.clone(), "b": zeros.clone()},
            "ln2": {"g": ones.clone(), "b": zeros.clone()},
        })
    return p


def _like(template: Any, src: Any, path: str = "init") -> Any:
    """``src`` (a numpy or tensor pytree, any key order) rebuilt in
    ``template``'s structure as f32 CPU tensors; raises when a leaf is
    missing or its shape differs."""
    if isinstance(template, dict):
        return {k: _like(v, src[k], f"{path}[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, list):
        if len(src) != len(template):
            raise ValueError(f"{path}: {len(src)} entries, the family "
                             f"has {len(template)}")
        return [_like(v, s, f"{path}[{i}]")
                for i, (v, s) in enumerate(zip(template, src))]
    t = torch.as_tensor(np.array(src, np.float32))
    if tuple(t.shape) != tuple(template.shape):
        raise ValueError(f"{path}: shape {tuple(t.shape)}, the family "
                         f"needs {tuple(template.shape)}")
    return t


def _per_item(v, G: int, device) -> torch.Tensor:
    """A hyper (float, 0-d or (G,) tensor) -> a (G,) f32 tensor of
    its own (a clone: an inference-mode input cannot enter autograd)."""
    t = torch.as_tensor(v, dtype=torch.float32).to(device).reshape(-1)
    return t.expand(G).clone()


# ---------------------------------------------------------------------------
# forward, on a leading instance axis
# ---------------------------------------------------------------------------

def _bcast(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (G, k) parameter shaped to broadcast over x's (G, ..., k)."""
    return p.reshape(p.shape[0], *([1] * (x.dim() - 2)), p.shape[-1])


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, ..., a) @ (G, a, b) -> (G, ..., b) as one batched product."""
    G, a = x.shape[0], x.shape[-1]
    out = torch.bmm(x.reshape(G, -1, a), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _layer_norm(x: torch.Tensor, ln: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Normalised in f32 with the population variance, then cast back to
    x's dtype (the reference's ``_layer_norm``)."""
    x32 = x.to(torch.float32)
    out = F.layer_norm(x32, x32.shape[-1:], eps=1e-5) * _bcast(ln["g"], x) \
        + _bcast(ln["b"], x)
    return out.to(x.dtype)


def _mha(x: torch.Tensor, lp: Dict[str, torch.Tensor],
         n_heads: int) -> torch.Tensor:
    """(G, n, T, D) -> (G, n, T, D) multi-head self-attention: one
    (D, 3D) projection, logits and softmax in f32."""
    G, n, T, D = x.shape
    Dh = D // n_heads
    qkv = _mm(x, torch.cat([lp["wq"], lp["wk"], lp["wv"]], dim=-1))
    # heads: one copy to (3, G, n, heads, T, Dh)
    q, k, v = qkv.reshape(G, n, T, 3, n_heads, Dh) \
        .permute(3, 0, 1, 4, 2, 5).contiguous().unbind(0)
    att = (q @ k.transpose(-1, -2)).to(torch.float32) \
        / float(np.sqrt(np.float32(Dh)))
    att = torch.softmax(att, dim=-1).to(x.dtype)
    out = (att @ v).transpose(2, 3).reshape(G, n, T, D)
    return _mm(out, lp["wo"])


def _forward(net: Dict[str, Any], X: torch.Tensor,
             n_heads: int) -> torch.Tensor:
    """(G, n, d) standardised features -> (G, n, k_out) head output in
    f32, for G instances' parameters (every leaf (G, ...))."""
    cdt = ft_dtype(X.device)
    G, n, _d = X.shape
    if cdt != torch.float32:
        def c(a):
            return a.to(cdt)

        net = dict(net, tok_w=c(net["tok_w"]), tok_b=c(net["tok_b"]),
                   cls=c(net["cls"]),
                   layers=[dict(lp, **{k: c(lp[k]) for k in _MM_KEYS})
                           for lp in net["layers"]])
        X = X.to(cdt)
    tokens = X[..., None] * net["tok_w"][:, None] + net["tok_b"][:, None]
    D = net["cls"].shape[-1]
    cls = net["cls"][:, None, None, :].expand(G, n, 1, D)
    h = torch.cat([cls, tokens], dim=2)                     # (G, n, d+1, D)
    for lp in net["layers"]:
        h = h + _mha(_layer_norm(h, lp["ln1"]), lp, n_heads)   # pre-norm
        ff = F.gelu(_mm(_layer_norm(h, lp["ln2"]), lp["ff1"])
                    + _bcast(lp["ff1_b"], h), approximate="tanh")
        h = h + _mm(ff, lp["ff2"]) + _bcast(lp["ff2_b"], h)
    z = _layer_norm(h[:, :, 0], net["final_ln"]).to(torch.float32)
    return torch.bmm(z, net["head_w"]) + net["head_b"][:, None]


def _loss(net: Dict[str, Any], Xs: torch.Tensor, target: torch.Tensor,
          wn: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The sum over G instances of each one's weighted loss: squared
    error for a float ``target`` (G, n) (regression), the negative
    log-softmax likelihood for an int64 ``target`` (G, n, 1) of class
    ids. ``wn`` (G, n) are the normalised weights."""
    out = _forward(net, Xs, n_heads)
    if target.dtype != torch.int64:
        return (wn * (out[..., 0] - target) ** 2).sum()
    logp = torch.log_softmax(out, dim=-1)
    return -(wn * logp.gather(-1, target)[..., 0]).sum()


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------

class FTTransformerFamily(ModelFamily):
    """Shared kernels; classifier/regressor subclasses register names."""

    in_default_candidates = False   # explicit opt-in selector candidate
    d_model: int = 32
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 64
    n_steps: int = 200
    default_hyper = {"learningRate": 3e-3, "weightDecay": 1e-4}
    default_grid = {"learningRate": [1e-3, 3e-3, 1e-2],
                    "weightDecay": [0.0, 1e-4]}

    def _k_out(self, n_classes: int) -> int:
        return 1 if n_classes <= 1 else n_classes

    def init_params(self, d: int, n_classes: int, init=None
                    ) -> Dict[str, Any]:
        """One instance's initial ``net`` on the CPU: ``init`` (the
        reference's layout) checked against the family's shapes, or the
        port's own seeded draw."""
        drawn = _init_params(d, self.d_model, self.n_layers, self.d_ff,
                             self._k_out(n_classes))
        return drawn if init is None else _like(drawn, init)

    def fit_batch(self, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                  hyper: Dict[str, Any], n_classes: int,
                  init=None) -> Dict[str, Any]:
        """G instances' fits: X (G, n, d), y and w (G, n), each hyper a
        (G,) tensor or a float. Returns {"net", "mu", "sd"} with a
        leading G axis on every leaf, detached."""
        n_heads, n_steps = int(self.n_heads), int(self.n_steps)
        k_out = self._k_out(n_classes)
        with torch.inference_mode(False), torch.enable_grad():
            X = X.to(torch.float32).clone()
            w = w.to(torch.float32).clone()
            G, _n, d = X.shape
            dev = X.device
            lr = _per_item(hyper["learningRate"], G, dev)[:, None]
            wd = _per_item(hyper["weightDecay"], G, dev)[:, None]
            # standardise under the fold weights (zero-weight rows add
            # nothing to the statistics)
            sw = torch.clamp(w.sum(dim=1), min=1e-6)[:, None]      # (G, 1)
            mu = (w[..., None] * X).sum(dim=1) / sw
            sd = torch.sqrt((w[..., None] * (X - mu[:, None]) ** 2)
                            .sum(dim=1) / sw + 1e-6)
            Xs = (X - mu[:, None]) / sd[:, None]
            wn = w / sw
            target = (y.to(torch.float32).clone() if k_out == 1
                      else y.to(torch.int64)[..., None])

            template = self.init_params(d, n_classes, init)
            leaves = tree_leaves(template)
            sizes = [t.numel() for t in leaves]
            flat = torch.cat([t.reshape(1, -1) for t in leaves], dim=1)
            flat = flat.to(dev).expand(G, -1).clone().requires_grad_()

            def unflat(buf):
                parts = iter(buf.split(sizes, dim=1))
                return tree_map(
                    lambda t: next(parts).view(G, *t.shape), template)

            m = torch.zeros_like(flat)
            v = torch.zeros_like(flat)
            b1 = np.float32(ADAM_B1)
            b2 = np.float32(ADAM_B2)
            for t in range(n_steps):
                loss = _loss(unflat(flat), Xs, target, wn, n_heads)
                (g,) = torch.autograd.grad(loss, flat)
                # the bias corrections in f32 at step t + 1, on the host
                tt = np.float32(t + 1)
                c1 = float(np.float32(1.0) - b1 ** tt)
                c2 = float(np.float32(1.0) - b2 ** tt)
                with torch.no_grad():
                    m.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                    v.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                    upd = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS) \
                        + wd * flat
                    flat.sub_(lr * upd)
            net = tree_map(lambda a: a.detach().clone(), unflat(flat))
        return {"net": net, "mu": mu.detach(), "sd": sd.detach()}

    def fit_kernel(self, X, y, w, hyper, n_classes: int, init=None):
        """One fit: :meth:`fit_batch` at G = 1."""
        hb = {k: torch.as_tensor(v, dtype=torch.float32).reshape(1)
              for k, v in hyper.items()}
        params = self.fit_batch(X[None], y[None], w[None], hb, n_classes,
                                init=init)
        return tree_map(lambda a: a[0], params)

    def predict_kernel(self, params, X, n_classes: int):
        """(n, d) -> softmax probabilities (classifiers) or the raw
        (n, 1) output (regression), for one instance's parameters."""
        k_out = self._k_out(n_classes)
        Xs = (X.to(torch.float32) - params["mu"]) / params["sd"]
        net = tree_map(lambda a: a[None], params["net"])
        out = _forward(net, Xs[None], int(self.n_heads))[0]
        if k_out == 1:
            return out
        return torch.softmax(out, dim=-1)


class FTTransformerClassifierFamily(FTTransformerFamily):
    name = "FTTransformerClassifier"
    problem_types = ("binary", "multiclass")


class FTTransformerRegressorFamily(FTTransformerFamily):
    name = "FTTransformerRegressor"
    problem_types = ("regression",)


class OpFTTransformerClassifier(ModelStage):
    """FT-Transformer classifier stage (selector candidate or standalone)."""
    family_name = "FTTransformerClassifier"
    problem = "binary"


class OpFTTransformerRegressor(ModelStage):
    family_name = "FTTransformerRegressor"
    problem = "regression"
