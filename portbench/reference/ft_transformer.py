"""The published FT-Transformer in plain torch, one instance at a time:
Gorishniy, Rubachev, Khrulkov and Babenko, "Revisiting Deep Learning
Models for Tabular Data" (NeurIPS 2021, arXiv:2106.11959), as the
authors' ``rtdl`` package builds it (``FTTransformer.make_default``).

Each numeric feature has its own affine token; a CLS token is appended
last; pre-norm blocks of multi-head self-attention (Q, K, V and the
output projection with biases) and a ReGLU feed-forward, the first block
without its attention norm; the head reads the CLS token through
LayerNorm, ReLU and a linear map. Every block runs over every token, the
last one too (the program computes the last block for the CLS query
alone; the output is the same). Dropout multiplies the attention
probabilities and the ReGLU output (the residual dropout is 0, as
published).

The parameters are a nested dict in the program's layout (``tok_w``,
``tok_b`` (d, D); ``cls`` (D,); ``blocks``: ``attn_ln`` (all but the
first), ``wqkv`` (D, 3, heads, D/heads), ``bqkv`` (3D,), ``wo`` (D, D),
``bo``, ``ffn_ln``, ``w1`` (D, 2F), ``b1``, ``w2`` (F, D), ``b2``;
``head_ln``, ``head_w`` (D, k), ``head_b``); every product is ``x @ w``.
The minibatch order and the dropout masks come from their written rules
(:func:`epoch_order`, :func:`mask_seed`), worked out here again. Products
run in float32 with TF32 off; ``operand`` rounds both operands of every
block's product (a control computes one precision below the program's).
The file stands alone: numpy and torch, nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
LN_EPS = 1e-5
#: leaves out of weight decay besides the norms (rtdl's parameter groups:
#: the feature tokenizer and every bias)
NO_DECAY = ("tok_w", "tok_b", "bqkv", "bo", "b1", "b2", "head_b")
#: a block's dropout sites, in the rule's numbering
SITES = {"attn": 0, "ffn": 1}
_M64 = (1 << 64) - 1


def exact() -> None:
    """float32 products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# the written rules
# ---------------------------------------------------------------------------

def epoch_order(seed: int, fold: int, epoch: int, rows: int) -> np.ndarray:
    """Positions 0..rows-1 of an item's rows (its fold's training rows in
    ascending order; the refit, fold -1: the whole training split) in the
    order an epoch steps through them."""
    return np.random.default_rng(
        [int(seed), int(fold) + 1, int(epoch)]).permutation(int(rows))


def steps_per_epoch(rows: int, batch: int) -> int:
    return -(-int(rows) // int(batch))


def batch_positions(seed: int, fold: int, epoch: int, step: int, rows: int,
                    batch: int) -> np.ndarray:
    """The positions of step ``step``'s batch (the last one short)."""
    return epoch_order(seed, fold, epoch, rows)[step * batch:
                                                (step + 1) * batch]


def _mix(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def mask_seed(seed: int, epoch: int, step: int, block: int,
              site: int) -> int:
    """The generator seed of one dropout mask: splitmix64 folded over
    (seed, epoch, step, block, site), its top 63 bits."""
    x = 0
    for part in (seed, epoch, step, block, site):
        x = _mix(x ^ (int(part) & _M64))
    return x >> 1


def _keep(key: int, shape, p: float, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(key)
    u = torch.rand(shape, generator=gen, device=device)
    return (u >= p).to(torch.float32) / (1.0 - p)


def dropout_masks(cfg: Dict, seed: int, epoch: int, step: int, n: int,
                  T: int, device) -> List[Dict[str, torch.Tensor]]:
    """Each block's dropout multipliers over every token at one step. The
    rule draws the last block's masks for the CLS query alone ((n, heads,
    1, T), (n, 1, F)); they sit on the CLS row here, the other rows kept
    whole (their outputs are not read)."""
    L, H, Fh = cfg["n_blocks"], cfg["n_heads"], cfg["ffn_hidden"]
    rates = {"attn": cfg["attention_dropout"], "ffn": cfg["ffn_dropout"]}
    out = []
    for b in range(L):
        last = b == L - 1
        tq = 1 if last else T
        shapes = {"attn": (n, H, tq, T), "ffn": (n, tq, Fh)}
        full = {"attn": (n, H, T, T), "ffn": (n, T, Fh)}
        m = {}
        for name, p in rates.items():
            if p <= 0:
                continue
            k = _keep(mask_seed(seed, epoch, step, b, SITES[name]),
                      shapes[name], p, device)
            if last:
                whole = torch.ones(full[name], device=device)
                whole[..., -1:, :] = k
                k = whole
            m[name] = k
        out.append(m)
    return out


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def rounding(fn: Callable[[torch.Tensor], torch.Tensor],
             grad_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """An operand rounding: ``fn`` on the operand, and ``grad_fn`` on the
    gradient that flows back through it (None: passed on unchanged)."""
    class _Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return fn(x)

        @staticmethod
        def backward(ctx, g):
            return g if grad_fn is None else grad_fn(g)
    return _Round.apply


def standardize(X: torch.Tensor, w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weighted mean and standard deviation of each feature (the
    program's standardisation, population variance plus 1e-6)."""
    X = X.to(torch.float32)
    w = w.to(torch.float32)
    sw = torch.clamp(w.sum(), min=1e-6)
    mu = (w[:, None] * X).sum(0) / sw
    sd = torch.sqrt((w[:, None] * (X - mu) ** 2).sum(0) / sw + 1e-6)
    return mu, sd


def _norm(x, ln):
    return F.layer_norm(x, x.shape[-1:], ln["g"], ln["b"], eps=LN_EPS)


def forward(net: Dict, Xs: torch.Tensor,
            masks: Optional[List[Dict]] = None,
            operand: Optional[Callable] = None) -> torch.Tensor:
    """(n, d) standardised rows -> (n, k) logits."""
    exact()
    op = operand or (lambda t: t)

    def linear(x, w, b):
        return op(x) @ op(w) + b

    n, d = Xs.shape
    D = net["cls"].shape[0]
    _, _, H, Dh = net["blocks"][0]["wqkv"].shape
    T = d + 1
    x = Xs[:, :, None] * net["tok_w"] + net["tok_b"]
    x = torch.cat([x, net["cls"].expand(n, 1, D)], dim=1)
    for i, blk in enumerate(net["blocks"]):
        m = masks[i] if masks else {}
        r = _norm(x, blk["attn_ln"]) if "attn_ln" in blk else x
        qkv = linear(r, blk["wqkv"].reshape(D, 3 * D), blk["bqkv"])
        q, k, v = (t.reshape(n, T, H, Dh).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        p = torch.softmax(op(q) @ op(k).transpose(-1, -2) / math.sqrt(Dh),
                          dim=-1)
        if "attn" in m:
            p = p * m["attn"]
        a = (op(p) @ op(v)).transpose(1, 2).reshape(n, T, D)
        x = x + linear(a, blk["wo"], blk["bo"])
        u = linear(_norm(x, blk["ffn_ln"]), blk["w1"], blk["b1"])
        half, gate = u.chunk(2, dim=-1)
        f = half * torch.relu(gate)
        if "ffn" in m:
            f = f * m["ffn"]
        x = x + linear(f, blk["w2"], blk["b2"])
    z = torch.relu(_norm(x[:, -1], net["head_ln"]))
    return z @ net["head_w"] + net["head_b"]


def row_losses(net: Dict, Xs: torch.Tensor, y: torch.Tensor,
               w: torch.Tensor, n_classes: int,
               masks: Optional[List[Dict]] = None,
               operand: Optional[Callable] = None) -> torch.Tensor:
    """Each row's term of the batch's weighted mean loss (w * loss over
    the batch's weight; the terms sum to the loss): BCE with logits
    (binary), cross-entropy (multiclass), squared error (regression)."""
    z = forward(net, Xs, masks, operand)
    if n_classes == 2:
        loss = F.binary_cross_entropy_with_logits(z[:, 0], y,
                                                  reduction="none")
    elif n_classes > 2:
        loss = F.cross_entropy(z, y.to(torch.int64), reduction="none")
    else:
        loss = (z[:, 0] - y) ** 2
    return w * loss / torch.clamp(w.sum(), min=1e-12)


def leaves(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, torch.Tensor]]:
    """(path, leaf) of a nested dict or list, depth first in key order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def rebuild(tree, values):
    """``tree``'s structure around ``values`` (an iterator, leaf order)."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, values) for v in tree]
    return next(values)


def loss_and_grad(net: Dict, Xs, y, w, n_classes: int, masks=None,
                  operand=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The batch's loss terms (:func:`row_losses`) and the gradient of
    their sum, the loss, by autograd, leaf by leaf."""
    ps = [t.detach().to(torch.float32).clone().requires_grad_()
          for _, t in leaves(net)]
    rows = row_losses(rebuild(net, iter(ps)), Xs, y, w, n_classes, masks,
                      operand)
    return rows.detach(), list(torch.autograd.grad(rows.sum(), ps))


def decays(path: Tuple) -> bool:
    """rtdl's groups: no decay on the tokenizer, the norms, the biases."""
    return not (path[-1] in NO_DECAY or path[0] in NO_DECAY
                or any(str(p).endswith("_ln") for p in path))


def adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
          v: torch.Tensor, step: int, lr: float, wd: float,
          decay: torch.Tensor):
    """``torch.optim.AdamW``'s step (decoupled decay first, then the
    moments and the bias-corrected update) on flat tensors; ``decay`` 1
    where weight decay applies. Returns (p, m, v)."""
    b1, b2 = ADAM_BETAS
    p = p * (1.0 - lr * wd * decay)
    m = m + (1.0 - b1) * (g - m)
    v = v * b2 + (1.0 - b2) * g * g
    denom = v.sqrt() / math.sqrt(1.0 - b2 ** step) + ADAM_EPS
    p = p - (lr / (1.0 - b1 ** step)) * m / denom
    return p, m, v


@torch.no_grad()
def logits_blocked(net: Dict, mu: torch.Tensor, sd: torch.Tensor,
                   X: torch.Tensor, rows: int = 8192,
                   operand: Optional[Callable] = None) -> torch.Tensor:
    """(n, d) raw rows -> (n, k) logits, ``rows`` at a time."""
    out = [forward(net, (X[s:s + rows].to(torch.float32) - mu) / sd,
                   None, operand)
           for s in range(0, X.shape[0], rows)]
    return torch.cat(out)
