"""The published FT-Transformer: Gorishniy, Rubachev, Khrulkov and
Babenko, "Revisiting Deep Learning Models for Tabular Data" (NeurIPS
2021), as the authors' rtdl package builds it in
``FTTransformer.make_default``, registered as its own family,
``FTTransformerPublishedClassifier`` (binary and multiclass). The toy
family of ``ft_transformer.py`` is left as it is.

The recipe is the family's class attributes (``d_token`` 192,
``n_blocks`` 3, ``n_heads`` 8, ``ffn_hidden`` 256 ReGLU,
``attention_dropout`` 0.2, ``ffn_dropout`` 0.1, ``batch_size`` 1,024,
``epochs``), read at fit time, so a caller or a test may set them on the
family object as on the toy family's sizes; the grid holds
``learningRate`` and ``weightDecay`` alone (rtdl's AdamW 1e-4 / 1e-5).
The model: a per-feature affine tokenizer, the CLS token appended last,
pre-norm blocks (block 0 without its attention norm) of multi-head
self-attention with biased Q, K, V and output projections and a ReGLU
feed-forward, the last block on the CLS query alone; the head LayerNorm,
ReLU, Linear to one logit (binary, BCE with logits) or k logits
(multiclass); dropout on the attention probabilities and after ReGLU;
AdamW with no decay on the tokenizer, the norms and the biases
(:func:`decays`); rtdl's init (:func:`_published_init`).

The fit runs minibatch epochs (the family's ``fit_batch``) by two
written rules, :func:`epoch_order` and :func:`mask_seed`. The sweep runs
a batch's items in as few chunks as memory allows, each on its fold's
gathered rows with a ``base.RowPlan`` (the family's ``sweep_chunk``).
Products take bf16 operands with f32 accumulation on CUDA
(:func:`ft_transformer.ft_dtype`); their outputs, the attention logits
among them, leave the product in bf16, and the biases are added there.
The norms, the softmax, the head, the master weights and Adam's state
are f32. Scoring runs in blocks of ``SCORE_ROWS`` rows.

Departures from rtdl: no residual dropout (rtdl's default is 0); the
features are standardised under the fold's weights (the paper's quantile
transform is left to the caller); a fixed number of epochs, without the
paper's early stopping; a batch's loss is its rows' weighted mean (the
balancing weights; unit weights give rtdl's mean); every item starts
from one draw of a CPU generator seeded 0; the shuffle is numpy's and
the masks a CUDA or CPU generator's, seeded by the rules, a chunk's items
sharing a step's masks; Q, K and V are one (d_token, 3, heads, head dim)
weight, which a fitted model's scoring reads its head count from; a
fitted model is not exported to the JAX package's portable runtime.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spmd
from ..telemetry.spans import TRACER
from .base import ModelFamily, RowPlan, tree_leaves, tree_map
from .ft_transformer import (ADAM_B1, ADAM_B2, ADAM_EPS, _bcast, _like,
                             _per_item, ft_dtype)
from .tuning import RANDOM_SEED, _put

__all__ = ["FTTransformerPublishedClassifierFamily", "Recipe", "epoch_order",
           "mask_seed", "decays"]

#: rows a block of scoring holds (an item's attention maps of one block
#: at 8 heads and 29 tokens: 0.2 GB in f32, under a training step's)
SCORE_ROWS = 8192
#: a block's dropout sites, the last part of :func:`mask_seed`
SITE_ATTN, SITE_FFN = 0, 1
#: a leaf's offset in the flat parameter buffer is a multiple of this many
#: elements (16 bytes of bf16)
LEAF_ALIGN = 8
#: the weights that enter a product in the compute dtype; the tokenizer,
#: the norms, the biases and the head stay f32
_MM_KEYS = ("wqkv", "wo", "w1", "w2")
#: the share of the free memory a sweep chunk's steps may take
CHUNK_MEMORY_SHARE = 0.5
_MASK64 = (1 << 64) - 1


class Recipe(NamedTuple):
    """The published recipe's sizes, dropouts and schedule, as the
    family's attributes of these names give it."""
    d_token: int
    n_blocks: int
    n_heads: int
    ffn_hidden: int
    attention_dropout: float
    ffn_dropout: float
    batch_size: int
    epochs: int


def epoch_order(seed: int, fold: int, epoch: int, rows: int) -> np.ndarray:
    """The written shuffle: the order in which epoch ``epoch`` of an item
    steps through positions 0..rows-1 of its rows, the permutation of
    numpy's ``default_rng([seed, fold + 1, epoch])`` (fold -1: the
    winner's refit). Batch s of the epoch is entries s*B .. s*B+B-1, the
    last batch short."""
    return np.random.default_rng(
        [int(seed), int(fold) + 1, int(epoch)]).permutation(int(rows))


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def mask_seed(seed: int, epoch: int, step: int, block: int,
              site: int) -> int:
    """The written dropout rule: the mask of ``site`` in ``block`` at
    step ``step`` of epoch ``epoch`` is ``torch.rand`` of the site's
    shape on the fit's device from a generator seeded by this number
    (splitmix64 folded over the five parts, 63 bits); an element is kept
    where the draw is at least p, and scaled by 1/(1-p) (in the product
    the site feeds, as that product's alpha, in the program). Shapes: the
    attention probabilities (B, heads, Tq, T) and the ReGLU output (B, Tq,
    ffn), Tq = 1 in the last block (the CLS query), T elsewhere. Every
    item of a batch shares the step's masks."""
    x = 0
    for part in (seed, epoch, step, block, site):
        x = _splitmix64(x ^ (int(part) & _MASK64))
    return x >> 1


def _draw_keep(gen: torch.Generator, key: int, shape, p: float, device,
               dtype) -> Tuple[torch.Tensor, float]:
    """(the 0/1 mask in ``dtype``, its scale 1/(1-p))."""
    gen.manual_seed(key)
    u = torch.rand(shape, generator=gen, device=device)
    return (u >= p).to(dtype), 1.0 / (1.0 - p)


def _step_keeps(rec: Recipe, seed: int, epoch: int, step: int, n: int,
                T: int, device, gen: torch.Generator,
                dtype=torch.float32) -> List[Dict]:
    """Each block's dropout masks at one step (:func:`mask_seed`): site
    name -> (0/1 mask in ``dtype``, scale)."""
    out = []
    for b in range(rec.n_blocks):
        Tq = 1 if b == rec.n_blocks - 1 else T
        k: Dict[str, torch.Tensor] = {}
        sites = (("attn", SITE_ATTN, rec.attention_dropout,
                  (n, rec.n_heads, Tq, T)),
                 ("ffn", SITE_FFN, rec.ffn_dropout,
                  (n, Tq, rec.ffn_hidden)))
        for name, site, p, shape in sites:
            if p > 0:
                k[name] = _draw_keep(gen, mask_seed(seed, epoch, step, b,
                                                    site), shape, p, device,
                                     dtype)
        out.append(k)
    return out


def _published_init(d: int, rec: Recipe, k_out: int,
                    seed: int = 0) -> Dict[str, Any]:
    """One instance's initial ``net`` on the CPU, rtdl's scheme drawn
    from a CPU ``torch.Generator``: the feature tokens and the CLS token
    uniform in +-1/sqrt(d_token) (``initialization="uniform"``); Q, K, V
    and the output projection as ``nn.Linear`` draws them, their biases
    zero (``attention_initialization="kaiming"``); the FFN and the head
    as ``nn.Linear`` (weights and biases uniform in +-1/sqrt(fan_in));
    norms one and zero. Q, K and V are one (d_token, 3, heads, head dim)
    weight, so a fitted model carries its head count in a shape."""
    gen = torch.Generator().manual_seed(seed)
    D, H, Fh = rec.d_token, rec.n_heads, rec.ffn_hidden

    def uni(shape, fan_in):
        return (torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(fan_in)

    def ln():
        return {"g": torch.ones(D), "b": torch.zeros(D)}

    net: Dict[str, Any] = {"tok_w": uni((d, D), D), "tok_b": uni((d, D), D),
                           "cls": uni((D,), D), "blocks": []}
    for i in range(rec.n_blocks):
        blk: Dict[str, Any] = {} if i == 0 else {"attn_ln": ln()}
        blk.update(wqkv=uni((D, 3, H, D // H), D), bqkv=torch.zeros(3 * D),
                   wo=uni((D, D), D), bo=torch.zeros(D), ffn_ln=ln(),
                   w1=uni((D, 2 * Fh), D), b1=uni((2 * Fh,), D),
                   w2=uni((Fh, D), Fh), b2=uni((D,), Fh))
        net["blocks"].append(blk)
    net.update(head_ln=ln(), head_w=uni((D, k_out), D),
               head_b=uni((k_out,), D))
    return net


def _paths(tree: Any, prefix: Tuple = ()) -> List[Tuple]:
    """(path, leaf) of every leaf, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def decays(path: Tuple) -> bool:
    """rtdl's parameter groups: weight decay on every parameter but the
    feature tokenizer's, the norms' and the biases'."""
    return not (path[0] in ("tok_w", "tok_b")
                or any(str(p).endswith("_ln") for p in path)
                or path[-1] in ("bqkv", "bo", "b1", "b2", "head_b"))


class FlatLayout:
    """A parameter pytree laid out on one flat (G, P) buffer: each leaf's
    path and size, ``decay`` (P,) 1 where weight decay applies, and views
    of a buffer in the pytree's shape. Every leaf starts at a multiple of
    ``LEAF_ALIGN`` elements, and P is one, so that a product's weight view
    is aligned for the tensor cores' kernels; the gaps hold zeros, which
    no view reads and the optimiser leaves at zero."""

    def __init__(self, template: Dict[str, Any]):
        self.template = template
        pl = _paths(template)
        self.paths = [p for p, _ in pl]
        self.sizes = [t.numel() for _, t in pl]
        self.spans = [-(-k // LEAF_ALIGN) * LEAF_ALIGN for k in self.sizes]
        self.decay = self.flat({"": [torch.full(t.shape, float(decays(p)))
                                     for p, t in pl]})

    def flat(self, tree: Dict[str, Any]) -> torch.Tensor:
        """(P,) the leaves of ``tree`` (in the template's order) with the
        gaps."""
        return torch.cat([F.pad(t.reshape(-1), (0, span - t.numel()))
                          for t, span in zip(tree_leaves(tree), self.spans)])

    def views(self, buf: torch.Tensor) -> Dict[str, Any]:
        G = buf.shape[0]
        parts = iter(buf.split(self.spans, dim=1))
        return tree_map(lambda t: next(parts)[:, :t.numel()].view(G, *t.shape),
                        self.template)


def _pub_ln(x: torch.Tensor, ln: Dict[str, torch.Tensor]) -> torch.Tensor:
    """LayerNorm of f32 x (G, ..., D), eps 1e-5, per-item (G, D) affine."""
    xn = F.layer_norm(x, x.shape[-1:], eps=1e-5)
    return torch.addcmul(_bcast(ln["b"], x), xn, _bcast(ln["g"], x))


def _cmm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
         cdt: torch.dtype, alpha: float = 1.0) -> torch.Tensor:
    """alpha * (G, ..., a) @ (G, a, c) + (G, c) as one batched product:
    the operands and the bias in the compute dtype, f32 accumulation;
    out in the compute dtype."""
    G, a = x.shape[0], x.shape[-1]
    out = torch.baddbmm(b.to(cdt)[:, None], x.reshape(G, -1, a).to(cdt), w,
                        alpha=alpha)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _pub_attention(x, blk, wc, last: bool, keep, scale: float,
                   cdt) -> torch.Tensor:
    """Multi-head self-attention of normed x (G, n, T, D) f32: the
    queries of every token, or of the CLS token (the last) alone in the
    last block, the keys and values of all; the logits' product scaled by
    1/sqrt(head dim), the softmax in f32; dropout's 0/1 ``keep`` on the
    probabilities, its ``scale`` 1/(1-p) in the output projection's
    product. (G, n, Tq, D) in the compute dtype."""
    G, n, T, D = x.shape
    W = wc["wqkv"]                                   # (G, D, 3, H, Dh)
    H, Dh = W.shape[-2], W.shape[-1]
    bq = blk["bqkv"]
    if not last:
        qkv = _cmm(x, W.reshape(G, D, 3 * D), bq, cdt)
        q, k, v = qkv.view(G, n, T, 3, H, Dh).permute(3, 0, 1, 4, 2, 5) \
            .unbind(0)                               # (G, n, H, T, Dh)
        Tq = T
    else:
        kv = _cmm(x, W[:, :, 1:].reshape(G, D, 2 * D), bq[:, D:], cdt)
        k, v = kv.view(G, n, T, 2, H, Dh).permute(3, 0, 1, 4, 2, 5) \
            .unbind(0)
        q = _cmm(x[:, :, -1:], W[:, :, 0].reshape(G, D, D), bq[:, :D],
                 cdt).view(G, n, 1, H, Dh).transpose(2, 3)
        Tq = 1
    q3 = q.reshape(-1, Tq, Dh)
    att = torch.baddbmm(q3.new_empty((1, 1, 1)), q3,
                        k.reshape(-1, T, Dh).transpose(1, 2), beta=0.0,
                        alpha=1.0 / math.sqrt(Dh))
    att = torch.softmax(att, dim=-1, dtype=torch.float32).to(cdt)
    if keep is not None:
        att = (att.view(G, -1, Tq, T) * keep.view(1, -1, Tq, T)) \
            .view(-1, Tq, T)
    out = torch.bmm(att, v.reshape(-1, T, Dh)).view(G, n, H, Tq, Dh) \
        .transpose(2, 3).reshape(G, n, Tq, D)
    return _cmm(out, wc["wo"], blk["bo"], cdt, alpha=scale)


def _reglu(u: torch.Tensor) -> torch.Tensor:
    """rtdl's ReGLU: the first half of the last axis gated by the ReLU of
    the second."""
    a, g = u.chunk(2, dim=-1)
    return a * torch.relu(g)


def _pub_forward(net: Dict[str, Any], wc: Dict[str, Any], Xs: torch.Tensor,
                 keeps: Optional[List[Dict]], cdt) -> torch.Tensor:
    """(G, n, d) standardised features -> (G, n, k_out) f32 logits of the
    published model, for G instances' parameters (every leaf (G, ...));
    ``wc`` holds each block's product weights in the compute dtype,
    ``keeps`` each block's dropout masks (None: eval, no dropout). The
    residual stream is f32; each branch adds its product's output.
    The CLS token is the last; block 0 has no attention norm; the last
    block runs its queries, output projection and FFN on the CLS token
    alone (``last_layer_query_idx=[-1]``)."""
    G, n, d = Xs.shape
    D = net["cls"].shape[-1]
    tokens = torch.addcmul(net["tok_b"][:, None], Xs[..., None],
                           net["tok_w"][:, None])            # (G, n, d, D)
    h = torch.cat([tokens, net["cls"][:, None, None].expand(G, n, 1, D)],
                  dim=2)
    L = len(net["blocks"])
    for i, (blk, bc) in enumerate(zip(net["blocks"], wc["blocks"])):
        last = i == L - 1
        kp = keeps[i] if keeps else {}
        x = _pub_ln(h, blk["attn_ln"]) if "attn_ln" in blk else h
        keep, scale = kp.get("attn", (None, 1.0))
        a = _pub_attention(x, blk, bc, last, keep, scale, cdt)
        h = (h[:, :, -1:] if last else h) + a
        f = _reglu(_cmm(_pub_ln(h, blk["ffn_ln"]), bc["w1"], blk["b1"],
                        cdt))
        keep, scale = kp.get("ffn", (None, 1.0))
        if keep is not None:
            f = f * keep
        h = h + _cmm(f, bc["w2"], blk["b2"], cdt, alpha=scale)
    z = torch.relu(_pub_ln(h[:, :, -1], net["head_ln"]))      # (G, n, D)
    return torch.baddbmm(net["head_b"][:, None], z, net["head_w"])


def _compute_weights(net: Dict[str, Any], cdt) -> Dict[str, Any]:
    """Each block's product weights cast to the compute dtype."""
    return {"blocks": [{k: blk[k].to(cdt) for k in _MM_KEYS}
                       for blk in net["blocks"]]}


def _pub_loss(z: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              n_classes: int) -> torch.Tensor:
    """(G, B) each row's term of its item's weighted mean loss over the
    batch (w * loss / the batch's weight; the terms sum to the item's
    loss): BCE with logits (binary, one logit), cross-entropy
    (multiclass), squared error (regression)."""
    if n_classes == 2:
        loss = F.binary_cross_entropy_with_logits(z[..., 0], y,
                                                  reduction="none")
    elif n_classes > 2:
        loss = -torch.log_softmax(z, dim=-1).gather(
            -1, y.to(torch.int64)[..., None])[..., 0]
    else:
        loss = (z[..., 0] - y) ** 2
    return w * loss / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)


class StepAt(NamedTuple):
    """One optimiser step of a chunk: the rule's seed, epoch and step,
    each item's fold, its batch positions ``pos`` (G, B) into its rows and
    their validity ``ok`` (G, B), whether it steps (an item whose epoch
    has fewer batches sits the chunk's last steps out), its step number
    ``t`` (from 1), its bias corrections and whether it steps ``bc`` (G, 3)
    on the device (:func:`_epoch_rows`), and
    the chunk's ``real`` (unpadded) items."""
    seed: int
    epoch: int
    step: int
    folds: Tuple[int, ...]
    pos: torch.Tensor
    ok: torch.Tensor
    active: Tuple[bool, ...]
    t: Tuple[int, ...]
    bc: torch.Tensor
    real: int


def _epoch_rows(plan: RowPlan, epoch: int, B: int, device):
    """An epoch's batches for every item by :func:`epoch_order`: (pos
    (G, S*B) int64, ok (G, S*B) f32, each item's batch count, the chunk's
    S, each step's bias corrections (S, G, 3) f32: 1 - beta1^t and
    sqrt(1 - beta2^t) at the item's step t, and 1 where it steps)."""
    steps = [-(-r // B) for r in plan.rows]
    S = max(steps)
    pos = np.zeros((len(steps), S * B), np.int64)
    ok = np.zeros((len(steps), S * B), np.float32)
    made: Dict[Tuple[int, int], np.ndarray] = {}
    for j, (f, r) in enumerate(zip(plan.folds, plan.rows)):
        if (f, r) not in made:
            made[(f, r)] = epoch_order(plan.seed, f, epoch, r)
        pos[j, :r] = made[(f, r)]
        ok[j, :r] = 1.0
    t = (epoch * np.asarray(steps)[None, :]
         + np.arange(1, S + 1)[:, None]).astype(np.float64)
    act = np.arange(S)[:, None] < np.asarray(steps)[None, :]
    bc = np.stack([1.0 - ADAM_B1 ** t, np.sqrt(1.0 - ADAM_B2 ** t), act],
                  -1)
    device = torch.device(device)
    return (_put(pos, device, torch.int64), _put(ok, device), steps, S,
            _put(bc, device))


def _train_loss_grad(flat: torch.Tensor, layout: FlatLayout,
                     Xs: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     at: StepAt, rec: Recipe, n_classes: int, cdt,
                     gen: torch.Generator):
    """One step's loss terms (G, B) (:func:`_pub_loss`) and the gradient
    (G, P) of each item's loss at the flat parameters, over each item's
    batch ``at.pos`` of its standardised rows Xs (G, n, d), with the
    step's dropout masks."""
    G, B = at.pos.shape
    d = Xs.shape[-1]
    Xb = torch.gather(Xs, 1, at.pos[..., None].expand(G, B, d))
    yb = torch.gather(y, 1, at.pos)
    wb = torch.gather(w, 1, at.pos) * at.ok
    keeps = _step_keeps(rec, at.seed, at.epoch, at.step, B, d + 1,
                        Xs.device, gen, cdt)
    net = layout.views(flat)
    wc = net if cdt == torch.float32 else layout.views(flat.to(cdt))
    loss = _pub_loss(_pub_forward(net, wc, Xb, keeps, cdt), yb, wb,
                     n_classes)
    (g,) = torch.autograd.grad(loss.sum(), flat)
    return loss.detach(), g


def _adamw_step(flat: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, lr: torch.Tensor, wd: torch.Tensor,
                decay: torch.Tensor, at: StepAt) -> None:
    """``torch.optim.AdamW``'s update of every stepping item, in place:
    the decoupled decay p *= 1 - lr*wd (where ``decay`` is 1), the
    moments, then p -= lr/bc1 * m / (sqrt(v)/bc2 + eps); an item that
    sits the step out keeps its parameters and moments."""
    with torch.no_grad():
        keep = None if all(at.active) else (
            flat.clone(), m.clone(), v.clone(), at.bc[:, 2:] > 0)
        bc1, bc2 = at.bc[:, :1], at.bc[:, 1:2]
        flat.mul_(1.0 - lr * wd * decay)
        m.lerp_(g, 1.0 - ADAM_B1)
        v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        denom = (v.sqrt() / bc2).add_(ADAM_EPS)
        flat.addcdiv_(m * (-lr / bc1), denom)
        if keep is not None:
            p0, m0, v0, act = keep
            for new, old in ((flat, p0), (m, m0), (v, v0)):
                new.copy_(torch.where(act, new, old))


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------

def step_bytes(rec: Recipe, tokens: int) -> int:
    """About what one item's step keeps for its backward: per row-token
    of a block some 42 bytes a width (the f32 residual and norms, the
    bf16 products' operands, outputs and head-split copies), 12 a head a
    token (the bf16 logits and probabilities, the f32 softmax, the
    masked maps) and 12 a ReGLU unit (the bf16 projection, gate, output
    and mask)."""
    per = (42 * rec.d_token + 12 * rec.n_heads * tokens
           + 12 * rec.ffn_hidden)
    return rec.n_blocks * rec.batch_size * tokens * per


def _free_bytes(device: torch.device) -> int:
    """The memory free on ``device`` now: the card's, or the host's."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class FTTransformerPublishedClassifierFamily(ModelFamily):
    """The published FT-Transformer's minibatch fit (the module's
    docstring)."""
    name = "FTTransformerPublishedClassifier"
    problem_types = ("binary", "multiclass")
    in_default_candidates = False   # explicit opt-in selector candidate
    #: the published recipe (rtdl ``FTTransformer.make_default``)
    d_token: int = 192
    n_blocks: int = 3
    n_heads: int = 8
    ffn_hidden: int = 256
    attention_dropout: float = 0.2
    ffn_dropout: float = 0.1
    batch_size: int = 1024
    epochs: int = 1
    default_hyper = {"learningRate": 1e-4, "weightDecay": 1e-5}
    default_grid = {"learningRate": [1e-4, 3e-4], "weightDecay": [1e-5]}
    #: the fit takes its items' rows' plan (``base.RowPlan``)
    takes_row_plan = True
    #: counters, summed over every fit of the process: optimiser steps of
    #: a chunk (one ``ft.step`` region each), item-steps (a step of one
    #: real item), rows stepped (real items' rows) and padded items (a
    #: sweep chunk's copies)
    chunk_steps: int = 0
    item_steps: int = 0
    rows_stepped: int = 0
    padded_items: int = 0

    def recipe(self) -> Recipe:
        """The recipe the family's attributes give."""
        return Recipe(*(getattr(self, k) for k in Recipe._fields))

    def sweep_chunk(self, hyper_b: Dict[str, np.ndarray],
                    X: torch.Tensor) -> int:
        """The sweep's chunk for a batch of items (``hyper_b``'s length)
        over rows X (n, d): all of them at once where half the free
        memory holds their steps (:func:`step_bytes`), else as few chunks
        as it allows, of equal size, so that at most one item a chunk is
        a padded copy."""
        items = len(next(iter(hyper_b.values())))
        room = CHUNK_MEMORY_SHARE * _free_bytes(X.device)
        cap = max(1, int(room // step_bytes(self.recipe(), X.shape[1] + 1)))
        return -(-items // -(-items // cap))

    def published_params(self, d: int, n_classes: int,
                         init=None) -> Dict[str, Any]:
        """One instance's initial ``net`` on the CPU: ``init`` checked
        against its shapes, or the seeded draw."""
        drawn = _published_init(d, self.recipe(),
                                1 if n_classes <= 2 else n_classes)
        return drawn if init is None else _like(drawn, init)

    def fit_kernel(self, X, y, w, hyper, n_classes: int, init=None,
                   plan: Optional[RowPlan] = None):
        """One fit: :meth:`fit_batch` at G = 1."""
        hb = {k: torch.as_tensor(v, dtype=torch.float32).reshape(1)
              for k, v in hyper.items()}
        params = self.fit_batch(X[None], y[None], w[None], hb, n_classes,
                                init=init, plan=plan)
        return tree_map(lambda a: a[0], params)

    def fit_batch(self, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                  hyper: Dict[str, Any], n_classes: int, init=None,
                  plan: Optional[RowPlan] = None) -> Dict[str, Any]:
        """G items' fits in minibatch epochs: X (G, n, d), y and w (G, n),
        ``learningRate`` and ``weightDecay`` each a (G,) tensor or a
        float. Item j's rows are the first ``plan.rows[j]`` of X[j] (no
        plan: all of them, fold -1, the selector's seed), standardised
        under w; each epoch steps through them in the order of
        :func:`epoch_order`, ``batch_size`` rows a step (the last batch
        short), the chunk's items in lockstep, an item with fewer batches
        sitting the last steps out. A step (one ``ft.step`` region) is
        the forward with the masks of :func:`mask_seed`, the gradient of
        each item's weighted mean loss, and AdamW on the flat parameters,
        with no decay on the tokenizer, the norms and the biases
        (:func:`decays`). Nothing is read back to the host. Returns
        {"net", "mu", "sd"} with a leading G axis on every leaf,
        detached."""
        if spmd.current() is not None:
            raise NotImplementedError(
                f"{self.name} steps through each item's rows on one "
                f"device; it cannot fit with its rows sharded over a data "
                f"mesh")
        rec = self.recipe()
        G, n, d = X.shape
        plan = plan or RowPlan(RANDOM_SEED, (-1,) * G, (n,) * G)
        if len(plan.rows) != G or max(plan.rows) > n:
            raise ValueError(f"row plan of {len(plan.rows)} items over "
                             f"{max(plan.rows)} rows for X {tuple(X.shape)}")
        dev = X.device
        cdt = ft_dtype(dev)
        B = rec.batch_size
        with torch.inference_mode(False), torch.enable_grad():
            X = X.to(torch.float32).clone()
            w = w.to(torch.float32).clone()
            y = y.to(torch.float32).clone()
            lr = _per_item(hyper["learningRate"], G, dev)[:, None]
            wd = _per_item(hyper["weightDecay"], G, dev)[:, None]
            sw = torch.clamp(w.sum(dim=1), min=1e-6)[:, None]
            mu = (w[..., None] * X).sum(dim=1) / sw
            sd = torch.sqrt((w[..., None] * (X - mu[:, None]) ** 2)
                            .sum(dim=1) / sw + 1e-6)
            Xs = (X - mu[:, None]) / sd[:, None]
            layout = FlatLayout(self.published_params(d, n_classes, init))
            flat = layout.flat(layout.template).to(dev).expand(G, -1) \
                .clone().requires_grad_()
            decay = layout.decay.to(dev)[None]
            m = torch.zeros_like(flat)
            v = torch.zeros_like(flat)
            gen = torch.Generator(device=dev)
            real = G - plan.padded
            self.padded_items += plan.padded
            for epoch in range(rec.epochs):
                pos, ok, steps, S, bc = _epoch_rows(plan, epoch, B, dev)
                for s in range(S):
                    active = tuple(s < k for k in steps)
                    at = StepAt(plan.seed, epoch, s, plan.folds,
                                pos[:, s * B:(s + 1) * B],
                                ok[:, s * B:(s + 1) * B], active,
                                tuple(epoch * k + s + 1 for k in steps),
                                bc[s], real)
                    with TRACER.region("ft.step"):
                        _, g = _train_loss_grad(flat, layout, Xs, y, w, at,
                                                rec, n_classes, cdt, gen)
                        _adamw_step(flat, g, m, v, lr, wd, decay, at)
                    self.chunk_steps += 1
                    self.item_steps += sum(active[:real])
                    self.rows_stepped += sum(
                        min(B, r - s * B) for r, a in
                        zip(plan.rows[:real], active[:real]) if a)
            net = tree_map(lambda a: a.detach().clone(), layout.views(flat))
        return {"net": net, "mu": mu.detach(), "sd": sd.detach()}

    def logits(self, params, X) -> torch.Tensor:
        """(n, d) -> (n, k_out) f32 logits of one instance's parameters,
        in blocks of ``SCORE_ROWS`` rows (one ``ft.score`` region each),
        no dropout."""
        cdt = ft_dtype(X.device)
        net = tree_map(lambda a: a[None], params["net"])
        wc = _compute_weights(net, cdt)
        out = []
        for s in range(0, X.shape[0], SCORE_ROWS):
            with TRACER.region("ft.score"):
                Xs = (X[s:s + SCORE_ROWS].to(torch.float32) - params["mu"]) \
                    / params["sd"]
                out.append(_pub_forward(net, wc, Xs[None], None, cdt)[0])
        return torch.cat(out)

    def predict_kernel(self, params, X, n_classes: int):
        """(n, d) -> class probabilities: the binary model's one logit
        through the sigmoid, the multiclass logits' softmax."""
        z = self.logits(params, X)
        if n_classes == 2:
            p = torch.sigmoid(z[:, 0])
            return torch.stack([1.0 - p, p], dim=1)
        return torch.softmax(z, dim=-1)

