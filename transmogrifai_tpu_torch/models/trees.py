"""Histogram tree engine + tree model families (DT / RF / GBT / XGBoost).

Counterpart of ``transmogrifai_tpu/models/trees.py`` (reference:
Op{DecisionTree,RandomForest,GBT,XGBoost}{Classifier,Regressor}). The
engine is the same, with shapes static and hyperparameters applied as
masks against static caps:

* features are quantile-binned once per fit (``bins[i, j] in [0, B)``)
  over the base weights — one global sketch shared by every fold (the
  grid-folded path) — or, on the per-instance path
  (``TM_TREE_GRID_FOLD=0``: :meth:`_TreeFamily.fit_batch`, the JAX
  package's vmapped ``fit_single_tree`` / ``fit_forest`` /
  ``fit_boosted``), once per item over the item's own training
  weights;
* a tree of depth cap D grows level by level; each level's node x
  feature x bin histograms for ALL instances of a (fold x hyper [x
  tree]) batch are ONE launch of the hand-written CUDA kernel
  (``kernels.histogram_grid``; the plain PyTorch version on the CPU);
* split gain sum_c GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam), masked
  by min-instance and column-subsample constraints, argmax over the
  flat (d*(B-1)) axis; a node that does not split stores threshold +inf
  (every row routes left), so a tree is a perfect binary tree of depth
  D and prediction is D gathers.

There is ONE grower, :func:`grow_tree_grid` (the JAX package's
``grow_tree`` is its Gb=1 case, the equivalence its tests pin), over
shared bins or over one binned matrix per item (``bins`` (Gbins, n, d),
``edges`` (Gbins, d, B-1); the per-instance path: still one histogram
launch per level for the whole batch). The single-fit entry points
(``fit_single_tree``, ``fit_forest``, ``fit_boosted``) are the grid
fitters on a batch of one.

Randomness. The JAX package draws from ``jax.random`` (per-node column
subsets, Poisson bootstrap, row subsample, per-tree column mask); the
port draws from a ``torch.Generator`` seeded from each instance's
``seed`` hyper, once per distinct seed, so an instance's draws do not
depend on the batch it rides in. The two cannot give the same bits:
the fitters also take every draw as a tensor (``boot``,
``subset_draws``, ``draws``), so a test can hand both packages the same
numbers. With default hypers DT, GBT and XGBoost draw nothing that
matters (``uniform < 1.0`` always holds); only RF depends on its draws.

Deterministic reductions: the leaf sums (``segment_sum`` in the JAX
package) are one-hot matrix products per instance — ``index_add_`` on
CUDA floats is atomic and its order varies run to run.

Rows sharded over a data mesh (a 2-D grid x data sweep: the fitters run
inside ``parallel.spmd.run_ranks``, each rank on its own rows): the
quantile sketch gathers every rank's rows first, so its edges are the
unsharded call's bit for bit; each level's histograms and the leaf sums
are summed over the ranks (``spmd.row_sum``, the CUDA ring on the card);
draws over rows are made over every row and cut to the rank's own; the
validation scores are gathered in origin order before the metric. The
JAX package gets the same from GSPMD.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..parallel import spmd
from .base import ModelFamily, ModelStage
from .kernels import allreduce_data, histogram_grid, ring_reduce_enabled

_INF = float("inf")


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def _quantile_levels(n_bins: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n_bins + 1)[1:-1]`` bit for bit: XLA
    computes the f32 iota times the f32 reciprocal of n_bins (a plain
    f32 division, or torch.linspace, differs in the last bit for most
    bin counts that are not powers of two)."""
    recip = torch.tensor(1.0, dtype=torch.float32) / float(n_bins)
    return (torch.arange(1, n_bins, dtype=torch.float32) * recip).to(device)


def quantile_bin_edges(X: torch.Tensor, n_bins: int,
                       w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-feature interior quantile edges -> (d, n_bins-1).

    With ``w``, rows of zero weight do not influence the edges (a full
    stable sort per feature, NaNs last, then the first sorted value
    whose cumulative weight reaches q*total); NaN values carry zero
    weight and never become edges. Without ``w``: ``torch.nanquantile``
    (linear interpolation, as ``jnp.nanquantile``). Inside
    ``spmd.run_ranks`` the rows of X (and w) are this rank's: every
    rank's are gathered in origin order first, so the edges are those of
    the unsharded call. The weighted sketch is
    :func:`quantile_bin_edges_items` of one item."""
    if w is not None:
        return quantile_bin_edges_items(X, n_bins, w[None])[0]
    Xf = X.to(torch.float32)
    if spmd.current() is not None:
        Xf, = spmd.gather_rows((Xf, 0))
    edges = torch.nanquantile(Xf, _quantile_levels(n_bins, Xf.device),
                              dim=0).T
    return torch.nan_to_num(edges, nan=_INF, posinf=_INF, neginf=-_INF)


def quantile_bin_edges_items(X: torch.Tensor, n_bins: int,
                             w: torch.Tensor) -> torch.Tensor:
    """Each item's weighted quantile edges -> (b, d, n_bins-1), item j's
    those of (X_j, w[j]) whatever the batch: a full stable sort per
    feature, NaNs last, then the first sorted value whose cumulative
    weight reaches q*total (rows of zero weight do not influence the
    edges; NaN values carry zero weight and never become edges). ``X``
    is (b, n, d), or (n, d) shared by every item (each column sorted
    once, each item's cumulative weights taken in that order); ``w`` is
    (b, n). Inside ``spmd.run_ranks`` the rows are the rank's shard: X
    and every item's weights are gathered in one exchange."""
    Xf = X.to(torch.float32)
    wf = w.to(torch.float32)
    shared = Xf.dim() == 2
    if spmd.current() is not None:
        Xf, wf = spmd.gather_rows((Xf, 0 if shared else 1), (wf, 1))
    qs = _quantile_levels(n_bins, Xf.device)
    Xs, order = torch.sort(Xf, dim=-2, stable=True)      # NaNs last
    n, d = Xs.shape[-2:]
    if shared:
        wsel = wf[:, order]                               # (b, n, d)
    else:
        wsel = torch.gather(wf[:, :, None].expand(-1, -1, d), 1, order)
    ws = torch.where(torch.isnan(Xs), torch.zeros((), device=Xf.device),
                     wsel)
    # scanned along the contiguous axis: CUDA's scan over a leading axis
    # runs one thread per column, 28 threads over 180k rows
    cw = torch.cumsum(ws.transpose(1, 2).contiguous(), dim=2)  # (b, d, n)
    total = torch.clamp(cw[..., -1], min=1e-12)               # (b, d)
    targets = (qs[None, None, :] * total[..., None]).contiguous()
    idx = torch.searchsorted(cw, targets, side="left")
    idx = torch.clamp(idx, 0, n - 1)
    XsT = Xs.transpose(-1, -2)
    if shared:
        XsT = XsT.expand(wf.shape[0], d, n)
    edges = torch.gather(XsT, 2, idx)                         # (b, d, q)
    return torch.nan_to_num(edges, nan=_INF, posinf=_INF, neginf=-_INF)


def bin_data(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Map raw values to bin ids in [0, B): bins = #edges strictly below
    x, so routing on bins and on raw values agree. NaN compares False
    everywhere -> bin 0 -> routes left, as at predict time."""
    return (X[:, :, None] > edges[None, :, :]).sum(dim=2).to(torch.int32)


def _prep(X: torch.Tensor, n_bins: int, w: Optional[torch.Tensor] = None):
    Xf = X.to(torch.float32)
    edges = quantile_bin_edges(Xf, n_bins, w)
    return bin_data(Xf, edges).contiguous(), edges


def _prep_items(X: torch.Tensor, n_bins: int, w: torch.Tensor):
    """Per-item sketch and bins: X (b, n, d) or shared (n, d), w (b, n)
    -> bins (b, n, d) int32, edges (b, d, n_bins-1)."""
    Xf = X.to(torch.float32)
    edges = quantile_bin_edges_items(Xf, n_bins, w)
    bins = torch.stack([bin_data(Xf if Xf.dim() == 2 else Xf[j], edges[j])
                        for j in range(edges.shape[0])])
    return bins.contiguous(), edges


# ---------------------------------------------------------------------------
# Core: grow Gb trees at once over shared (or per-item) bins
# ---------------------------------------------------------------------------

def grow_tree_grid(bins,                         # (n, d) or (Gbins, n, d)
                   gw,                           # (Gb, n, C)
                   hw,                           # (Gb, n, C)
                   w,                            # (Gb, n)
                   edges: torch.Tensor,          # (d, B-1) or (Gbins, ...)
                   feat_mask: torch.Tensor,      # (Gb, d)
                   lam: torch.Tensor,            # (Gb,)
                   gamma: torch.Tensor,          # (Gb,)
                   min_instances: torch.Tensor,  # (Gb,)
                   depth_limit: torch.Tensor,    # (Gb,)
                   subset_draws: Optional[Sequence[torch.Tensor]] = None,
                   subset_rate: Optional[torch.Tensor] = None,
                   *, max_depth: int, mesh=None,
                   data_ring: Optional[bool] = None):
    """Grow one tree for each of Gb instances over SHARED bins, or over
    per-item bins: ``bins`` (Gbins, n, d) and ``edges`` (Gbins, d, B-1)
    with Gbins dividing Gb, instance g reading slot g // (Gb // Gbins)
    (a forest's T trees of one item share the item's slot).

    Each level's histograms are ONE ``histogram_grid`` launch over all
    instances (inside ``spmd.run_ranks``: over this rank's rows, summed
    over the ranks with the leaf sums). ``subset_draws`` (with
    ``subset_rate`` (Gb,)) is the per-node column-subset path (mllib's
    featureSubsetStrategy, XGBoost's colsample_bynode): level l's entry
    is a (Gb, 2^l, d) tensor of uniform [0, 1) draws; a node keeps
    column j when its draw is below the rate, ANDed with ``feat_mask``,
    falling back to the full feat_mask when that leaves no column. Rate
    1.0 is the unsubsetted tree exactly.

    Returns (feat (Gb, I) int64, thr (Gb, I), leaf (Gb, L, C),
    gains (Gb, I), pos (Gb, n)) with I = 2^D - 1, L = 2^D.

    ``mesh`` (a ``parallel.data_mesh``) is the row-partitioned mode, the
    JAX package's ``data_axis``: ``bins``, ``gw``, ``hw`` and ``w`` are
    lists of per-rank row shards (``parallel.shard_rows``; zero-padded
    rows carry zero stats), the other arguments are replicated. Each
    level launches one histogram per rank on its stream, reduces the
    partials with ``kernels.allreduce_data`` and runs the split search
    on every rank, as SPMD does; the leaf gradient/hessian sums reduce
    the same way. Returns one result tuple per rank (``pos`` of its own
    rows); every rank scans the same bits, so the trees are identical.
    ``data_ring`` is the ring-vs-plain policy (None:
    ``kernels.ring_reduce_enabled``), resolved once for the whole grow.
    """
    if mesh is None:
        return _grow_ranks([bins], [gw], [hw], [w], edges, feat_mask, lam,
                           gamma, min_instances, depth_limit, subset_draws,
                           subset_rate, max_depth, None, False)[0]
    if data_ring is None:
        data_ring = ring_reduce_enabled(mesh.devices[0])
    mesh.fork()
    out = _grow_ranks(list(bins), list(gw), list(hw), list(w), edges,
                      feat_mask, lam, gamma, min_instances, depth_limit,
                      subset_draws, subset_rate, max_depth, mesh,
                      bool(data_ring))
    mesh.join(*(t for res in out for t in res))
    return out


def _grow_ranks(bins, gw, hw, w, edges, feat_mask, lam, gamma,
                min_instances, depth_limit, subset_draws, subset_rate,
                max_depth: int, mesh, data_ring: bool):
    """The grower over ranks: bins/gw/hw/w are per-rank lists (one entry
    and no mesh for the single-device grow); replicated arguments are
    copied to each rank's device once."""
    ndev = len(bins)

    def on(r):      # rank r's stream
        return contextlib.nullcontext() if mesh is None else mesh.rank(r)

    def reduce(parts):
        if mesh is not None:
            return allreduce_data(parts, mesh, use_ring=data_ring)
        return list(spmd.row_sum(*parts))
    Gb, _, C = gw[0].shape
    d = bins[0].shape[-1]
    B = edges.shape[-1] + 1
    S = 2 * C + 1
    # instances a bins slot serves (per-item bins), or None (shared)
    per = Gb // bins[0].shape[0] if bins[0].dim() == 3 else None
    ranks = []
    for r in range(ndev):
        with on(r):
            dev = bins[r].device
            rep = {k: v.to(dev) for k, v in (
                ("edges", edges), ("feat_mask", feat_mask), ("lam", lam),
                ("gamma", gamma), ("min_instances", min_instances),
                ("depth_limit", depth_limit))}
            if subset_draws is not None:
                rep["subset_draws"] = [t.to(dev) for t in subset_draws]
                rep["subset_rate"] = subset_rate.to(dev)
            ranks.append({
                "dev": dev, "rep": rep, "bins": bins[r], "per": per,
                # (d, n) or (Gbins, d, n) for routing
                "bins_t": bins[r].transpose(-1, -2).contiguous(),
                "stats": torch.cat([gw[r], hw[r], w[r][..., None]],
                                   dim=2).contiguous(),
                "pos": torch.zeros((Gb, bins[r].shape[-2]),
                                   dtype=torch.int32, device=dev),
                "feats": [], "thrs": [], "gains": []})
    for level in range(max_depth):
        m = 1 << level
        hists = []
        for r, rk in enumerate(ranks):
            with on(r):
                hists.append(histogram_grid(rk["bins"], rk["stats"],
                                            rk["pos"], m, B))
        hists = reduce(hists)
        for r, rk in enumerate(ranks):
            with on(r):
                _split_level(rk, hists[r].reshape(Gb, m, S, d, B), level,
                             C, B)
    L = 1 << max_depth
    sums = []
    for r, rk in enumerate(ranks):
        with on(r):
            sums.append(_leaf_sums(rk["pos"], gw[r], hw[r], L))
    sums = reduce(sums)
    out = []
    for r, rk in enumerate(ranks):
        with on(r):
            lam_r = rk["rep"]["lam"]
            leaf = sums[r][:, :, :C] / (sums[r][:, :, C:]
                                        + lam_r[:, None, None] + 1e-12)
            out.append((torch.cat(rk["feats"], dim=1),
                        torch.cat(rk["thrs"], dim=1), leaf,
                        torch.cat(rk["gains"], dim=1), rk["pos"]))
    return out


def _split_level(rk: Dict[str, Any], hist: torch.Tensor, level: int,
                 C: int, B: int) -> None:
    """One level's split search on one rank from the full histogram
    (Gb, m, S, d, B): appends the level's feat/thr/gains to ``rk`` and
    routes its rows to the next level's nodes."""
    rep = rk["rep"]
    lam_ = rep["lam"][:, None, None, None, None]
    min_i = rep["min_instances"][:, None, None, None]
    edges = rep["edges"]
    Gb, m, _, d, _ = hist.shape
    inf = torch.full((), _INF, device=rk["dev"])
    cum = torch.cumsum(hist, dim=4)
    GL = cum[:, :, :C, :, :B - 1]                  # (Gb, m, C, d, B-1)
    HL = cum[:, :, C:2 * C, :, :B - 1]
    WL = cum[:, :, 2 * C, :, :B - 1]               # (Gb, m, d, B-1)
    G = cum[:, :, :C, :, -1:]
    H = cum[:, :, C:2 * C, :, -1:]
    GR, HR = G - GL, H - HL
    WR = cum[:, :, 2 * C, :, -1:] - WL

    def score(gs, hs):
        return gs * gs / (hs + lam_ + 1e-12)

    gain = torch.sum(score(GL, HL) + score(GR, HR) - score(G, H), dim=2)
    fm_l = rep["feat_mask"][:, None, :]            # (Gb, 1|m, d)
    if "subset_draws" in rep:
        draw = (rep["subset_draws"][level]
                < rep["subset_rate"][:, None, None]).to(torch.float32)
        comb = fm_l * draw                         # (Gb, m, d)
        fm_l = torch.where(torch.sum(comb, 2, keepdim=True) < 0.5,
                           fm_l, comb)
    valid = ((WL >= min_i) & (WR >= min_i)
             & (fm_l[:, :, :, None] > 0.5))
    gain = torch.where(valid, gain, -inf)          # (Gb, m, d, B-1)

    flat = gain.reshape(Gb, m, d * (B - 1))
    best = torch.argmax(flat, dim=2)               # first max, as jnp
    best_gain = torch.gather(flat, 2, best[:, :, None])[:, :, 0]
    bf = best // (B - 1)                           # (Gb, m) feature
    bb = best % (B - 1)                            # (Gb, m) bin
    do = ((best_gain > rep["gamma"][:, None])
          & (rep["depth_limit"][:, None] > level))

    feat_l = torch.where(do, bf, 0)
    per = rk["per"]
    if per is None:
        thr_l = torch.where(do, edges[bf, bb], inf)
    else:                                          # each instance's slot
        slot = torch.arange(Gb, device=rk["dev"])[:, None] // per
        thr_l = torch.where(do, edges[slot, bf, bb], inf)
    thr_bin = torch.where(do, bb, B - 1)
    rk["feats"].append(feat_l)
    rk["thrs"].append(thr_l)
    rk["gains"].append(torch.where(do, best_gain, 0.0))

    pos = rk["pos"]
    p = pos.to(torch.int64)
    f_i = torch.gather(feat_l, 1, p)                          # (Gb, n)
    t_i = torch.gather(thr_bin, 1, p)
    if per is None:
        b_i = torch.gather(rk["bins_t"], 0, f_i)
    else:                  # (Gbins, d, n) gathered per slot's instances
        bt = rk["bins_t"]
        b_i = torch.gather(bt, 1, f_i.reshape(bt.shape[0], per, -1)
                           ).reshape(Gb, -1)
    rk["pos"] = 2 * pos + (b_i > t_i).to(torch.int32)


def _leaf_sums(pos: torch.Tensor, gw: torch.Tensor, hw: torch.Tensor,
               L: int) -> torch.Tensor:
    """Per-leaf sums of gw and hw, (Gb, L, 2C) with the gw sums first:
    one (L, n) x (n, 2C) one-hot product per instance, so the sums are
    deterministic and an instance's leaves do not depend on the batch
    (``index_add_`` on CUDA floats is atomic and its order varies)."""
    Gb, n, C = gw.shape
    leaves = torch.arange(L, device=pos.device, dtype=torch.int32)
    both = torch.cat([gw, hw], dim=2)
    out = torch.empty((Gb, L, 2 * C), dtype=torch.float32, device=pos.device)
    for g in range(Gb):
        oh = (pos[g][None, :] == leaves[:, None]).to(torch.float32)
        out[g] = oh @ both[g]
    return out


def _importance(feat: torch.Tensor, gains: torch.Tensor,
                d: int) -> torch.Tensor:
    """Gain-based feature importance (..., d), normalized to sum 1."""
    imp = _importance_raw(feat, gains, d)
    return imp / torch.clamp(imp.sum(-1, keepdim=True), min=1e-12)


def _importance_raw(feat: torch.Tensor, gains: torch.Tensor,
                    d: int) -> torch.Tensor:
    """Sum of split gains per feature over the last (node) axis."""
    oh = (feat[..., None] == torch.arange(d, device=feat.device))
    return (oh.to(torch.float32) * gains[..., None]).sum(-2)


def _feature_mask(u: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """Bernoulli column-subsample mask from uniform draws u (Gb, d); a
    mask that drops every column falls back to all ones."""
    fm = (u < rate[:, None]).to(torch.float32)
    return torch.where(fm.sum(1, keepdim=True) < 0.5, torch.ones_like(fm), fm)


def _hget(hyper_b: Dict[str, Any], key: str, default: float,
          Gb: int, device) -> torch.Tensor:
    """A hyper as a (Gb,) f32 tensor: the batch's tensor, or a float
    constant over the batch (a static hyper of the sweep, or the
    default)."""
    v = hyper_b.get(key, default)
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((Gb,), float(v), dtype=torch.float32, device=device)


def _targets(y: torch.Tensor, C: int, classification: bool) -> torch.Tensor:
    """(..., n) labels -> (..., n, C) one-hot classes or the target."""
    if classification:
        return (y.to(torch.int64)[..., None]
                == torch.arange(C, device=y.device)).to(torch.float32)
    return y.to(torch.float32)[..., None]


def _seed_groups(seed: torch.Tensor) -> Tuple[List[int], torch.Tensor]:
    """Distinct seeds of a batch (in order) and each instance's index
    into them: draws are made once per distinct seed, so an instance's
    numbers depend on its seed alone, never on its batch."""
    vals = [int(s) for s in seed.to(torch.int64).tolist()]
    uniq = sorted(set(vals))
    inv = torch.tensor([uniq.index(v) for v in vals], dtype=torch.int64,
                       device=seed.device)
    return uniq, inv


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


# ---------------------------------------------------------------------------
# Grid-folded fitters: the whole (fold x hyper) batch, shared bins
# ---------------------------------------------------------------------------

def fit_single_tree_grid(X, y, w_base, train_b, hyper_b, n_classes, *,
                         max_depth: int, n_bins: int,
                         classification: bool) -> Dict[str, torch.Tensor]:
    """CART trees (variance-reduction splits == Gini on one-hot
    channels) for the whole (fold x hyper) batch over shared
    global-sketch bins. Returns params with a leading Gb axis."""
    bins, edges = _prep(X, n_bins, w_base)
    return fit_single_tree_binned(
        bins, edges, y, w_base[None, :] * train_b, hyper_b, n_classes,
        max_depth=max_depth, classification=classification)


def fit_single_tree_binned(bins, edges, y, w, hyper_b, n_classes, *,
                           max_depth: int, classification: bool
                           ) -> Dict[str, torch.Tensor]:
    """:func:`fit_single_tree_grid` over binned rows: ``bins`` (n, d)
    and ``edges`` (d, B-1) shared by the batch, or one of each an item
    ((Gb, n, d), (Gb, d, B-1)); y (n,) or (Gb, n); w (Gb, n) each
    instance's training weights."""
    Gb = w.shape[0]
    d = bins.shape[-1]
    dev = bins.device
    C = n_classes if classification else 1
    tgt = _targets(y, C, classification)
    gw = tgt * w[..., None]
    hw = w[..., None].expand(gw.shape)
    feat, thr, leaf, gains, _ = grow_tree_grid(
        bins, gw, hw, w, edges, torch.ones((Gb, d), device=dev),
        torch.full((Gb,), 1e-6, device=dev),
        _hget(hyper_b, "minInfoGain", 0.0, Gb, dev),
        _hget(hyper_b, "minInstancesPerNode", 1.0, Gb, dev),
        _hget(hyper_b, "maxDepth", float(max_depth), Gb, dev),
        max_depth=max_depth)
    return {"feat": feat[:, None], "thr": thr[:, None],
            "leaf": leaf[:, None],
            "tree_w": torch.ones((Gb, 1), device=dev),
            "feature_importance": _importance(feat, gains, d)}


def forest_draws(seed: torch.Tensor, n_trees: int, n: int, d: int,
                 max_depth: int):
    """The forest's draws from each instance's seed: Poisson(1)
    bootstrap counts (Gb, T, n) and, per level l, per-node column-subset
    uniforms (Gb*T, 2^l, d)."""
    uniq, inv = _seed_groups(seed)
    dev = seed.device
    boots, levels = [], []
    for s in uniq:
        gen = _generator(s, dev)
        boots.append(torch.poisson(torch.ones((n_trees, n), device=dev),
                                   generator=gen))
        levels.append([torch.rand((n_trees, 1 << lv, d), generator=gen,
                                  device=dev) for lv in range(max_depth)])
    boot = torch.stack(boots)[inv]
    subset = [torch.stack([lv[k] for lv in levels])[inv].reshape(
        -1, 1 << k, d) for k in range(max_depth)]
    return boot, subset


def fit_forest_grid(X, y, w_base, train_b, hyper_b, n_classes, *,
                    max_depth: int, n_bins: int, n_trees: int,
                    classification: bool,
                    boot: Optional[torch.Tensor] = None,
                    subset_draws: Optional[Sequence[torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Random forests folded over BOTH the (fold x hyper) batch AND the
    trees axis: all Gb*T bootstrap fits share one binned matrix, so each
    level is one histogram launch over Gb*T instances. ``boot`` (Gb, T,
    n) and ``subset_draws`` (per level (Gb*T, 2^l, d)) default to
    :func:`forest_draws` of the ``seed`` hyper. Returns params with a
    leading Gb axis."""
    bins, edges = _prep(X, n_bins, w_base)
    return fit_forest_binned(
        bins, edges, y, w_base[None, :] * train_b, hyper_b, n_classes,
        max_depth=max_depth, n_trees=n_trees, classification=classification,
        boot=boot, subset_draws=subset_draws)


def fit_forest_binned(bins, edges, y, w, hyper_b, n_classes, *,
                      max_depth: int, n_trees: int, classification: bool,
                      boot: Optional[torch.Tensor] = None,
                      subset_draws: Optional[Sequence[torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """:func:`fit_forest_grid` over binned rows (the shapes of
    :func:`fit_single_tree_binned`); with one binned matrix an item, the
    item's T trees share it."""
    n, d = bins.shape[-2:]
    Gb = w.shape[0]
    T = n_trees
    dev = bins.device
    C = n_classes if classification else 1
    tgt = _targets(y, C, classification)
    if tgt.dim() == 3:                       # an item's labels, per tree
        tgt = torch.repeat_interleave(tgt, T, dim=0)
    subset = _hget(hyper_b, "featureSubsetRate", 1.0, Gb, dev)
    if boot is None or subset_draws is None:
        seed = _hget(hyper_b, "seed", 0.0, Gb, dev).to(torch.int32)
        b0, s0 = forest_draws(seed, T, spmd.total_rows(n), d, max_depth)
        boot = spmd.own_rows(b0, 2) if boot is None else boot
        subset_draws = s0 if subset_draws is None else subset_draws
    wt = (w[:, None, :] * boot).reshape(Gb * T, n)
    gw = tgt * wt[..., None]
    hw = wt[..., None].expand(gw.shape)

    def rep(a):                              # (Gb,) -> (Gb*T,)
        return torch.repeat_interleave(a, T)

    feat, thr, leaf, gains, _ = grow_tree_grid(
        bins, gw, hw, wt, edges, torch.ones((Gb * T, d), device=dev),
        torch.full((Gb * T,), 1e-6, device=dev),
        rep(_hget(hyper_b, "minInfoGain", 0.0, Gb, dev)),
        rep(_hget(hyper_b, "minInstancesPerNode", 1.0, Gb, dev)),
        rep(_hget(hyper_b, "maxDepth", float(max_depth), Gb, dev)),
        subset_draws=subset_draws, subset_rate=rep(subset),
        max_depth=max_depth)
    I = feat.shape[1]
    L = leaf.shape[1]
    feat = feat.reshape(Gb, T, I)
    thr = thr.reshape(Gb, T, I)
    leaf = leaf.reshape(Gb, T, L, C)
    gains = gains.reshape(Gb, T, I)
    active = (torch.arange(T, device=dev)[None, :]
              < _hget(hyper_b, "numTrees", float(T), Gb, dev)[:, None]
              ).to(torch.float32)                               # (Gb, T)
    imp = _importance(feat, gains, d)                           # (Gb, T, d)
    denom = torch.clamp(active.sum(1), min=1.0)
    return {"feat": feat, "thr": thr, "leaf": leaf,
            "tree_w": active / denom[:, None],
            "feature_importance":
                (imp * active[..., None]).sum(1) / denom[:, None]}


def boost_draws(seed: torch.Tensor, n_rounds: int, n: int, d: int,
                max_depth: int) -> Dict[str, Any]:
    """The boosting draws from each instance's seed, per round r: row
    subsample uniforms ``row`` (R, Gb, n), per-tree column uniforms
    ``col`` (R, Gb, d) and, per level l, per-node column uniforms
    ``node[l]`` (R, Gb, 2^l, d)."""
    uniq, inv = _seed_groups(seed)
    dev = seed.device
    rows, cols, nodes = [], [], []
    for s in uniq:
        gen = _generator(s, dev)
        rows.append(torch.rand((n_rounds, n), generator=gen, device=dev))
        cols.append(torch.rand((n_rounds, d), generator=gen, device=dev))
        nodes.append([torch.rand((n_rounds, 1 << lv, d), generator=gen,
                                 device=dev) for lv in range(max_depth)])
    return {"row": torch.stack(rows, 1)[:, inv],
            "col": torch.stack(cols, 1)[:, inv],
            "node": [torch.stack([nd[k] for nd in nodes], 1)[:, inv]
                     for k in range(max_depth)]}


def fit_boosted_grid(X, y, w_base, train_b, hyper_b, n_classes, *,
                     max_depth: int, n_bins: int, n_rounds: int,
                     objective: str,
                     draws: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Second-order boosting (XGBoost-style) for the whole (fold x
    hyper) batch with shared bins; the JAX package's ``lax.scan`` over
    rounds is a Python loop, each round one tree per instance (one
    histogram launch per level). ``draws`` defaults to
    :func:`boost_draws` of the ``seed`` hyper.
    objective: 'logistic' (binary), 'softmax' (multiclass), 'squared'.
    Returns params with a leading Gb axis."""
    bins, edges = _prep(X, n_bins, w_base)
    return fit_boosted_binned(
        bins, edges, y, w_base[None, :] * train_b, hyper_b, n_classes,
        max_depth=max_depth, n_rounds=n_rounds, objective=objective,
        draws=draws)


def fit_boosted_binned(bins, edges, y, w, hyper_b, n_classes, *,
                       max_depth: int, n_rounds: int, objective: str,
                       draws: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, torch.Tensor]:
    """:func:`fit_boosted_grid` over binned rows (the shapes of
    :func:`fit_single_tree_binned`)."""
    n, d = bins.shape[-2:]
    Gb = w.shape[0]
    dev = bins.device
    C = n_classes if objective == "softmax" else 1
    yf = y.to(torch.float32)                        # (n,) or (Gb, n)
    y_oh = _targets(y, max(C, 2), True)
    lam = _hget(hyper_b, "regLambda", 1.0, Gb, dev)
    gamma = _hget(hyper_b, "minSplitGain", 0.0, Gb, dev)
    min_inst = _hget(hyper_b, "minChildWeight", 1.0, Gb, dev)
    depth_lim = _hget(hyper_b, "maxDepth", float(max_depth), Gb, dev)
    lr = _hget(hyper_b, "stepSize", 0.1, Gb, dev)
    max_iter = _hget(hyper_b, "maxIter", float(n_rounds), Gb, dev)
    subsample = _hget(hyper_b, "subsample", 1.0, Gb, dev)
    colsample = _hget(hyper_b, "colsampleByTree", 1.0, Gb, dev)
    colsample_node = _hget(hyper_b, "colsampleByNode", 1.0, Gb, dev)
    if draws is None:
        seed = _hget(hyper_b, "seed", 0.0, Gb, dev).to(torch.int32)
        draws = boost_draws(seed, n_rounds, spmd.total_rows(n), d, max_depth)
        draws["row"] = spmd.own_rows(draws["row"], 2)

    # per-instance sums (one (n,) reduction each): the same reduction
    # whatever the batch, so an instance's base does not depend on it
    yb = yf.expand(Gb, n)
    sw, wy = spmd.row_sum(torch.stack([w[g].sum() for g in range(Gb)]),
                          torch.stack([(w[g] * yb[g]).sum()
                                       for g in range(Gb)]))
    sw = torch.clamp(sw, min=1e-6)
    if objective == "logistic":
        p0 = torch.clamp(wy / sw, 1e-5, 1 - 1e-5)
        base = torch.log(p0 / (1 - p0))[:, None]                 # (Gb, 1)
    elif objective == "softmax":
        base = torch.zeros((Gb, C), device=dev)
    else:
        base = (wy / sw)[:, None]
    margin = base[:, None, :].expand(Gb, n, C)

    def grad_hess(margin):                                       # (Gb, n, C)
        if objective == "logistic":
            p = torch.sigmoid(margin[..., 0])
            return ((yf - p)[..., None],
                    torch.clamp(p * (1 - p), min=1e-6)[..., None])
        if objective == "softmax":
            p = torch.softmax(margin, dim=2)
            return y_oh[..., :C] - p, torch.clamp(p * (1 - p), min=1e-6)
        return yf[..., None] - margin, torch.ones_like(margin)

    gidx = torch.arange(Gb, device=dev)[:, None]
    feats, thrs, leaves, gains_all = [], [], [], []
    for r in range(n_rounds):
        row = (draws["row"][r] < subsample[:, None]).to(torch.float32)
        fm = _feature_mask(draws["col"][r], colsample)
        g, h = grad_hess(margin)
        wr = w * row                                             # (Gb, n)
        feat, thr, leaf, gains, pos = grow_tree_grid(
            bins, g * wr[..., None], h * wr[..., None], wr, edges, fm,
            lam, gamma, min_inst, depth_lim,
            subset_draws=[nd[r] for nd in draws["node"]],
            subset_rate=colsample_node, max_depth=max_depth)
        active = (max_iter > r).to(torch.float32)                # (Gb,)
        leaf = leaf * (lr * active)[:, None, None]
        margin = margin + leaf[gidx, pos.to(torch.int64)]
        feats.append(feat)
        thrs.append(thr)
        leaves.append(leaf)
        gains_all.append(gains * active[:, None])
    feat = torch.stack(feats, 1)                                 # (Gb, R, I)
    gains = torch.stack(gains_all, 1)
    imp = _importance_raw(feat, gains, d).sum(1)                 # (Gb, d)
    return {"feat": feat, "thr": torch.stack(thrs, 1),
            "leaf": torch.stack(leaves, 1),
            "tree_w": torch.ones((Gb, n_rounds), device=dev), "base": base,
            "feature_importance":
                imp / torch.clamp(imp.sum(1, keepdim=True), min=1e-12)}


# ---------------------------------------------------------------------------
# Single fits: the grid fitters on a batch of one
# ---------------------------------------------------------------------------

def _as_batch_of_one(X, w, hyper):
    train_b = torch.ones((1, X.shape[0]), device=X.device)
    hyper_b = {k: torch.as_tensor(v, dtype=torch.float32,
                                  device=X.device).reshape(1)
               for k, v in hyper.items()}
    return w.to(torch.float32), train_b, hyper_b


def _first(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v[0] for k, v in params.items()}


def fit_single_tree(X, y, w, hyper, n_classes, *, max_depth: int,
                    n_bins: int, classification: bool):
    """One CART tree (reference: OpDecisionTree* -> mllib DecisionTree)."""
    w, train_b, hyper_b = _as_batch_of_one(X, w, hyper)
    return _first(fit_single_tree_grid(
        X, y, w, train_b, hyper_b, n_classes, max_depth=max_depth,
        n_bins=n_bins, classification=classification))


def fit_forest(X, y, w, hyper, n_classes, *, max_depth: int, n_bins: int,
               n_trees: int, classification: bool):
    """One random forest (reference: OpRandomForest* -> mllib
    RandomForest, per-split featureSubsetStrategy)."""
    w, train_b, hyper_b = _as_batch_of_one(X, w, hyper)
    return _first(fit_forest_grid(
        X, y, w, train_b, hyper_b, n_classes, max_depth=max_depth,
        n_bins=n_bins, n_trees=n_trees, classification=classification))


def fit_boosted(X, y, w, hyper, n_classes, *, max_depth: int, n_bins: int,
                n_rounds: int, objective: str):
    """One boosted ensemble (reference: OpGBT* / OpXGBoost*)."""
    w, train_b, hyper_b = _as_batch_of_one(X, w, hyper)
    return _first(fit_boosted_grid(
        X, y, w, train_b, hyper_b, n_classes, max_depth=max_depth,
        n_bins=n_bins, n_rounds=n_rounds, objective=objective))


# ---------------------------------------------------------------------------
# Shared prediction
# ---------------------------------------------------------------------------

def predict_trees(feat: torch.Tensor, thr: torch.Tensor, leaf: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    """Route raw rows through T stored trees at once: feat/thr (T, I),
    leaf (T, L, C), X (n, d) -> (T, n, C) leaf values."""
    T, L, C = leaf.shape
    D = L.bit_length() - 1
    n = X.shape[0]
    Xt = X.to(torch.float32).T.contiguous()                     # (d, n)
    feat = feat.to(torch.int64)
    pos = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    for level in range(D):
        idx = (1 << level) - 1 + pos
        f = torch.gather(feat, 1, idx)
        t = torch.gather(thr, 1, idx)
        x = torch.gather(Xt, 0, f)
        pos = 2 * pos + (x > t).to(torch.int64)
    return leaf[torch.arange(T, device=X.device)[:, None], pos]


def ensemble_raw(params: Dict[str, torch.Tensor],
                 X: torch.Tensor) -> torch.Tensor:
    """Weighted sum of per-tree outputs -> (n, C); params may carry
    leading batch axes (a grid fit's Gb), giving (..., n, C)."""
    feat = params["feat"]
    lead = tuple(feat.shape[:-2])
    T, I = feat.shape[-2:]
    leaf = params["leaf"]
    L, C = leaf.shape[-2:]
    preds = predict_trees(feat.reshape(-1, I), params["thr"].reshape(-1, I),
                          leaf.reshape(-1, L, C), X)
    preds = preds.reshape(*lead, T, X.shape[0], C)
    out = (preds * params["tree_w"][..., None, None]).sum(-3)
    if "base" in params:
        out = out + params["base"][..., None, :]
    return out


def _probs_from_mean(mean: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Averaged one-hot leaf means -> normalized class probabilities."""
    p = torch.clamp(mean, min=0.0)
    s = p.sum(-1, keepdim=True)
    return torch.where(s > 1e-9, p / torch.clamp(s, min=1e-9),
                       torch.full_like(p, 1.0 / n_classes))


# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------

class _TreeFamily(ModelFamily):
    """Shared static caps. Instances are registered singletons, so tests
    can shrink caps by mutating attributes."""
    rows_sharded = True
    n_bins = 32
    max_depth_cap = 5

    def levels_per_fit(self) -> int:
        """Tree levels one fit grows — histogram launches per fit, on
        the grid path and in a refit alike (a forest's trees and a
        grid's instances fold into each launch)."""
        return self.max_depth_cap * getattr(self, "n_rounds_cap", 1)

    def _fit_binned(self, bins, edges, y, w, hyper_b, n_classes):
        """Per-family fit over binned rows (the shapes of
        :func:`fit_single_tree_binned`) -> params with leading Gb
        axis."""
        raise NotImplementedError

    def _fit_grid(self, X, y, w_base, train_b, hyper_b, n_classes):
        """The grid-folded fit: one sketch of (X, w_base) shared by the
        batch, instance g weighted w_base x train_b[g]."""
        bins, edges = _prep(X, self.n_bins, w_base)
        return self._fit_binned(bins, edges, y, w_base[None, :] * train_b,
                                hyper_b, n_classes)

    def fit_batch(self, X, y, w, hyper, n_classes):
        """The per-instance path (``TM_TREE_GRID_FOLD=0``, the sweep's
        items; the JAX package's vmapped fit_kernel): item j fits X[j]
        (b, n, d; an expanded view is one shared matrix, sorted once for
        every item's sketch), labels y[j] and weights w[j], binned on its
        own weighted sketch; every level of the batch is one histogram
        launch over per-item bins. ``hyper`` holds (b,) tensors and, for
        hypers constant over the batch, floats. Returns params with a
        leading b axis for ``predict_kernel``. Inside ``spmd.run_ranks``
        rows past the rank's shard (the sweep's alignment padding, zero
        weight) are dropped first."""
        k = spmd.shard_rows(w.shape[1])
        X, y, w = X[:, :k], y[:, :k], w[:, :k]
        bins, edges = _prep_items(X[0] if X.stride(0) == 0 else X,
                                  self.n_bins, w)
        return self._fit_binned(bins, edges, y, w, hyper, n_classes)

    def fit_eval_grid(self, X, y, w_base, train_b, val_b, hyper_b,
                      n_classes, metric_fn) -> torch.Tensor:
        """The whole (fold x hyper) batch as ONE folded fit: each level
        of every instance's tree is one histogram launch. Returns (Gb,)
        validation metrics (each instance scored on its own, so its
        metric does not depend on the batch). Inside ``spmd.run_ranks``
        each rank scores its own rows and the scores, labels and
        validation weights are gathered in origin order first, so the
        metric sees every row."""
        params = self._fit_grid(X, y, w_base, train_b, hyper_b, n_classes)
        probs = self.predict_kernel(params, X, n_classes)   # (Gb, n, k)
        wv = w_base[None, :] * val_b
        probs, y, wv = spmd.gather_rows((probs, 1), (y.to(torch.float32), 0),
                                        (wv, 1))
        return torch.stack([metric_fn(probs[g], y, wv[g])
                            for g in range(probs.shape[0])])


class DecisionTreeClassifierFamily(_TreeFamily):
    name = "DecisionTreeClassifier"
    problem_types = ("binary", "multiclass")
    default_hyper = {"maxDepth": 5.0, "minInstancesPerNode": 1.0,
                     "minInfoGain": 0.0}
    default_grid = {"maxDepth": [3.0, 5.0]}
    classification = True

    def fit_kernel(self, X, y, w, hyper, n_classes):
        return fit_single_tree(X, y, w, hyper, n_classes,
                               max_depth=self.max_depth_cap,
                               n_bins=self.n_bins,
                               classification=self.classification)

    def predict_kernel(self, params, X, n_classes):
        return _probs_from_mean(ensemble_raw(params, X), n_classes)

    def _fit_binned(self, bins, edges, y, w, hyper_b, n_classes):
        return fit_single_tree_binned(
            bins, edges, y, w, hyper_b, n_classes,
            max_depth=self.max_depth_cap,
            classification=self.classification)


class DecisionTreeRegressorFamily(DecisionTreeClassifierFamily):
    name = "DecisionTreeRegressor"
    problem_types = ("regression",)
    classification = False

    def predict_kernel(self, params, X, n_classes):
        return ensemble_raw(params, X)


class RandomForestClassifierFamily(_TreeFamily):
    name = "RandomForestClassifier"
    problem_types = ("binary", "multiclass")
    n_trees_cap = 32
    default_hyper = {"numTrees": 20.0, "maxDepth": 5.0,
                     "minInstancesPerNode": 1.0, "minInfoGain": 0.0,
                     "featureSubsetRate": 0.6, "seed": 0.0}
    default_grid = {"maxDepth": [3.0, 5.0]}
    classification = True

    def fit_kernel(self, X, y, w, hyper, n_classes):
        return fit_forest(X, y, w, hyper, n_classes,
                          max_depth=self.max_depth_cap, n_bins=self.n_bins,
                          n_trees=self.n_trees_cap,
                          classification=self.classification)

    def predict_kernel(self, params, X, n_classes):
        return _probs_from_mean(ensemble_raw(params, X), n_classes)

    def _fit_binned(self, bins, edges, y, w, hyper_b, n_classes):
        return fit_forest_binned(
            bins, edges, y, w, hyper_b, n_classes,
            max_depth=self.max_depth_cap, n_trees=self.n_trees_cap,
            classification=self.classification)


class RandomForestRegressorFamily(RandomForestClassifierFamily):
    name = "RandomForestRegressor"
    problem_types = ("regression",)
    classification = False

    def predict_kernel(self, params, X, n_classes):
        return ensemble_raw(params, X)


class _BoostedFamily(_TreeFamily):
    n_rounds_cap = 24
    objective = "logistic"

    def _objective(self, n_classes: int) -> str:
        if self.objective == "logistic" and n_classes > 2:
            return "softmax"
        return self.objective

    def fit_kernel(self, X, y, w, hyper, n_classes):
        return fit_boosted(X, y, w, hyper, n_classes,
                           max_depth=self.max_depth_cap, n_bins=self.n_bins,
                           n_rounds=self.n_rounds_cap,
                           objective=self._objective(n_classes))

    def predict_kernel(self, params, X, n_classes):
        raw = ensemble_raw(params, X)
        if self.objective == "squared":
            return raw
        if raw.shape[-1] == 1:                       # binary logistic margin
            p1 = torch.sigmoid(raw[..., 0])
            return torch.stack([1 - p1, p1], dim=-1)
        return torch.softmax(raw, dim=-1)

    def _fit_binned(self, bins, edges, y, w, hyper_b, n_classes):
        return fit_boosted_binned(
            bins, edges, y, w, hyper_b, n_classes,
            max_depth=self.max_depth_cap, n_rounds=self.n_rounds_cap,
            objective=self._objective(n_classes))


class GBTClassifierFamily(_BoostedFamily):
    """Reference: OpGBTClassifier (mllib GBT, binary only)."""
    name = "GBTClassifier"
    problem_types = ("binary",)
    objective = "logistic"
    default_hyper = {"maxIter": 20.0, "maxDepth": 5.0, "stepSize": 0.1,
                     "regLambda": 0.0, "minSplitGain": 0.0,
                     "minChildWeight": 1.0, "subsample": 1.0,
                     "colsampleByTree": 1.0, "seed": 0.0}
    default_grid = {"maxDepth": [3.0, 5.0], "stepSize": [0.1, 0.3]}


class GBTRegressorFamily(_BoostedFamily):
    name = "GBTRegressor"
    problem_types = ("regression",)
    objective = "squared"
    default_hyper = dict(GBTClassifierFamily.default_hyper)
    default_grid = {k: list(v) for k, v in
                    GBTClassifierFamily.default_grid.items()}


class XGBoostClassifierFamily(_BoostedFamily):
    """Reference: OpXGBoostClassifier (JNI libxgboost + Rabit)."""
    name = "XGBoostClassifier"
    problem_types = ("binary", "multiclass")
    objective = "logistic"
    max_depth_cap = 6
    default_hyper = {"maxIter": 24.0, "maxDepth": 6.0, "stepSize": 0.3,
                     "regLambda": 1.0, "minSplitGain": 0.0,
                     "minChildWeight": 1.0, "subsample": 1.0,
                     "colsampleByTree": 1.0, "colsampleByNode": 1.0,
                     "seed": 0.0}
    default_grid = {"regLambda": [1.0], "stepSize": [0.1, 0.3]}


class XGBoostRegressorFamily(XGBoostClassifierFamily):
    name = "XGBoostRegressor"
    problem_types = ("regression",)
    objective = "squared"
    default_hyper = dict(XGBoostClassifierFamily.default_hyper)
    default_grid = {k: list(v) for k, v in
                    XGBoostClassifierFamily.default_grid.items()}


# ---------------------------------------------------------------------------
# Op* estimator stages (reference wrapper-class parity)
# ---------------------------------------------------------------------------

class _ProblemArg:
    """Mixin of the classifier stages that take ``problem`` (binary or
    multiclass), as the JAX package's do; not a stage itself, so the
    stage registry holds only the Op* classes, as the JAX one does."""

    def __init__(self, uid=None, problem: str = "binary", device=None,
                 **hyper):
        super().__init__(uid=uid, device=device, **hyper)
        self.problem = problem


class OpDecisionTreeClassifier(_ProblemArg, ModelStage):
    family_name = "DecisionTreeClassifier"


class OpDecisionTreeRegressor(ModelStage):
    family_name = "DecisionTreeRegressor"
    problem = "regression"


class OpRandomForestClassifier(_ProblemArg, ModelStage):
    family_name = "RandomForestClassifier"


class OpRandomForestRegressor(ModelStage):
    family_name = "RandomForestRegressor"
    problem = "regression"


class OpGBTClassifier(ModelStage):
    family_name = "GBTClassifier"


class OpGBTRegressor(ModelStage):
    family_name = "GBTRegressor"
    problem = "regression"


class OpXGBoostClassifier(_ProblemArg, ModelStage):
    family_name = "XGBoostClassifier"


class OpXGBoostRegressor(ModelStage):
    family_name = "XGBoostRegressor"
    problem = "regression"
