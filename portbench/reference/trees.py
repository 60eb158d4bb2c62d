"""The histogram tree families, written from their published rules, as a
judge of fitted trees and as a grower for the controls.

The rules (TransmogrifAI's DT / RF / GBT / XGBoost on a binned matrix):
features are cut at weighted quantiles over the training rows (for each
q = i/B, the first sorted value whose cumulative weight reaches q of the
total; NaN carries no weight); a tree grows level by level to its depth
cap; a node's candidate splits are every (feature, edge), a row going
right when its value is above the edge; a split's gain is
sum_c GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam) over the stat channels
c, allowed when both sides keep at least ``min_w`` of weight and, for a
forest, the feature is in the node's column subset; the node splits on
the first best candidate when its gain beats ``gamma`` and the level is
under the ``maxDepth`` hyper; a leaf holds G/(H+lam) per channel (times
the step size in a boosted round). DT and RF grow class channels
(one-hot label times weight, and the weight), lam 1e-6; GBT and XGBoost
grow the logistic gradient (y - p) and hessian max(p(1-p), 1e-6), each
times the weight, from a base margin of the weighted log-odds, with
``regLambda``, ``minSplitGain``, ``minChildWeight``, ``stepSize`` and
``maxIter`` rounds. A forest's row weights are Poisson(1) bootstrap
counts, and its per-node column subsets keep a column when a uniform
draw is under ``featureSubsetRate`` (all columns when none is kept):
both drawn from a ``torch.Generator`` seeded with the ``seed`` hyper on
the rows' device, the counts (trees, rows) first, then the draws (trees,
2^l, d) of each level l in turn.

:func:`run` (a refit) and :func:`sweep` (each fold's fit of each grid
point, on the one sketch of the training rows, as the selector's
cross-validation makes them) replay the program's own trees over the
rows (its splits route the rows; a boosted round's gradients come from
the margin of its earlier trees) and read, at every node, how far the
gain of the split the program chose falls below the best candidate's,
in float64, and at every leaf how far its value lies from G/(H+lam); or
grow the trees themselves, with the histogram's operands rounded to
``operand`` and f32 sums (the controls). Every tree of a batch of fits
on the same rows grows side by side, one level at a time.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import metrics
from .precision import OPERAND

_INF = float("inf")

#: the families' static caps: (kind, depth cap, trees or rounds cap)
FAMILY = {"DecisionTreeClassifier": ("dt", 5, 1),
          "RandomForestClassifier": ("rf", 5, 32),
          "GBTClassifier": ("boost", 5, 24),
          "XGBoostClassifier": ("boost", 6, 24)}
N_BINS = 32
#: hyper defaults of each family
DEFAULTS = {
    "DecisionTreeClassifier": {"maxDepth": 5.0, "minInstancesPerNode": 1.0,
                               "minInfoGain": 0.0},
    "RandomForestClassifier": {"numTrees": 20.0, "maxDepth": 5.0,
                               "minInstancesPerNode": 1.0,
                               "minInfoGain": 0.0,
                               "featureSubsetRate": 0.6, "seed": 0.0},
    "GBTClassifier": {"maxIter": 20.0, "maxDepth": 5.0, "stepSize": 0.1,
                      "regLambda": 0.0, "minSplitGain": 0.0,
                      "minChildWeight": 1.0, "subsample": 1.0,
                      "colsampleByTree": 1.0, "seed": 0.0},
    "XGBoostClassifier": {"maxIter": 24.0, "maxDepth": 6.0, "stepSize": 0.3,
                          "regLambda": 1.0, "minSplitGain": 0.0,
                          "minChildWeight": 1.0, "subsample": 1.0,
                          "colsampleByTree": 1.0, "colsampleByNode": 1.0,
                          "seed": 0.0},
}


def edges_of(X: torch.Tensor, w: torch.Tensor, B: int = N_BINS
             ) -> torch.Tensor:
    """(d, B-1) weighted quantile edges of f32 rows X (n, d), weights w."""
    Xf = X.to(torch.float32)
    qs = torch.arange(1, B, dtype=torch.float32) * (
        torch.tensor(1.0, dtype=torch.float32) / float(B))
    qs = qs.to(X.device)
    Xs, order = torch.sort(Xf, dim=0, stable=True)
    ws = torch.where(torch.isnan(Xs), 0.0, w.to(torch.float32)[order])
    cw = torch.cumsum(ws.T.contiguous(), dim=1)                 # (d, n)
    total = torch.clamp(cw[:, -1], min=1e-12)
    idx = torch.searchsorted(cw, (qs[None, :] * total[:, None]).contiguous(),
                             side="left").clamp(0, Xf.shape[0] - 1)
    e = torch.gather(Xs.T, 1, idx)
    return torch.nan_to_num(e, nan=_INF, posinf=_INF, neginf=-_INF)


def bins_of(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin ids (n, d): the number of edges strictly below each value."""
    out = torch.empty(X.shape, dtype=torch.int64, device=X.device)
    for j in range(X.shape[1]):
        out[:, j] = torch.searchsorted(edges[j].contiguous(),
                                       X[:, j].contiguous(), side="left")
    return torch.where(torch.isnan(X), 0, out)


def forest_draws(seed: int, trees: int, n: int, d: int, depth: int, device):
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    boot = torch.poisson(torch.ones((trees, n), device=device), generator=gen)
    levels = [torch.rand((trees, 1 << lv, d), generator=gen, device=device)
              for lv in range(depth)]
    return boot, levels


class _Rows:
    """The rows a batch of trees sees, binned on a sketch, with the
    histogram over a level's nodes."""

    def __init__(self, X, edges, dtype):
        self.X = X
        self.n, self.d = X.shape
        self.B = edges.shape[1] + 1
        self.edges = edges
        self.dtype = dtype
        self.bins = bins_of(X, edges)
        self._onehot = None
        #: sum by products with one-hot bins (on a card) or by scatter-add
        self.products = X.is_cuda

    def onehot(self):
        """(n, d*B) one-hot bins in ``dtype``, made once."""
        if self._onehot is None:
            col = self.bins + torch.arange(self.d, device=self.X.device) \
                * self.B
            oh = torch.zeros((self.n, self.d * self.B), dtype=self.dtype,
                             device=self.X.device)
            self._onehot = oh.scatter_(1, col, 1.0)
        return self._onehot

    def histogram(self, pos, stats, m):
        """(I, m, S, d, B) sums of each tree's ``stats`` (I, n, S) by its
        node ``pos`` (I, n) and bin. With ``products`` (on a card), the
        rows' node-placed stats times their one-hot bins, in blocks of
        rows (a scatter-add there serialises on the few bins of a shallow
        level); else a weighted bincount a tree and channel."""
        I, n, S = stats.shape
        d, B = self.d, self.B
        stats = stats.to(self.dtype)
        if not self.products:
            flat = self.bins + torch.arange(d) * B
            out = []
            for i in range(I):
                idx = (pos[i][:, None] * (d * B) + flat).reshape(-1)
                out.append(torch.stack([torch.bincount(
                    idx, stats[i, :, c].repeat_interleave(d),
                    minlength=m * d * B) for c in range(S)], 1))
            return torch.stack(out).reshape(I, m, d, B, S).permute(
                0, 1, 4, 2, 3)
        cols = I * m * S
        oh = self.onehot()
        out = torch.zeros((cols, d * B), dtype=self.dtype,
                          device=self.X.device)
        base = ((torch.arange(I, device=pos.device)[:, None] * m + pos)
                * S)[:, :, None] + torch.arange(S, device=pos.device)
        step = max(256, (1 << 26) // cols)
        for r0 in range(0, n, step):
            r1 = min(n, r0 + step)
            idx = base[:, r0:r1].permute(1, 0, 2).reshape(r1 - r0, I * S)
            src = stats[:, r0:r1].permute(1, 0, 2).reshape(r1 - r0, I * S)
            A = torch.zeros((r1 - r0, cols), dtype=self.dtype,
                            device=self.X.device)
            A.scatter_(1, idx, src)
            out.addmm_(A.T, oh[r0:r1])
        return out.reshape(I, m, S, d, B)


class Rules:
    """The rules of I trees grown side by side: the stat layout (C
    gradient and C hessian channels, then the weight), and per tree lam,
    gamma, min weight, depth limit (each (I,)), with a forest's per-level
    column-subset draws ((I, 2^l, d) a level) and rate (I,)."""

    def __init__(self, C, lam, gamma, min_w, depth_limit, depth_cap,
                 subsets=None, rate=None):
        self.C, self.depth_cap = C, depth_cap
        self.lam, self.gamma, self.min_w = lam, gamma, min_w
        self.depth_limit = depth_limit
        self.subsets, self.rate = subsets, rate

    def allowed(self, level):
        """Each node's column subset (I, m, d), or None (every column)."""
        if self.subsets is None:
            return None
        keep = self.subsets[level] < self.rate.to(torch.float32)[:, None,
                                                                  None]
        none = keep.sum(2, keepdim=True) == 0
        return torch.where(none, torch.ones_like(keep), keep)

    def may_split(self, level):
        return (level < self.depth_limit)[:, None]


def _score(g, h, lam):
    return g * g / (h + lam + 1e-12)


def _gains(hist, rules: Rules, level):
    """Every candidate's gain (I, m, d, B-1), -inf where not allowed."""
    C = rules.C
    cum = torch.cumsum(hist, dim=4)
    GL, HL = cum[:, :, :C, :, :-1], cum[:, :, C:2 * C, :, :-1]
    WL = cum[:, :, 2 * C, :, :-1]
    G, H = cum[:, :, :C, :, -1:], cum[:, :, C:2 * C, :, -1:]
    W = cum[:, :, 2 * C, :, -1:]
    lam = rules.lam.to(hist.dtype)[:, None, None, None, None]
    gain = (_score(GL, HL, lam) + _score(G - GL, H - HL, lam)
            - _score(G, H, lam)).sum(2)
    mw = rules.min_w.to(hist.dtype)[:, None, None, None]
    ok = (WL >= mw) & (W - WL >= mw)
    allowed = rules.allowed(level)
    if allowed is not None:
        ok = ok & allowed[..., None]
    return torch.where(ok, gain, -_INF)


def _node_sums(pos, stats, m, dtype, keep=None):
    """(I, m, S) sums of ``stats`` (I, n, S) by node (rows in ``keep``)."""
    I, n, S = stats.shape
    node = torch.arange(I, device=pos.device)[:, None] * m + pos
    out = torch.zeros((I * m, S), dtype=dtype, device=pos.device)
    if keep is None:
        out.index_add_(0, node.reshape(-1), stats.reshape(-1, S).to(dtype))
    else:
        out.index_add_(0, node[keep], stats[keep].to(dtype))
    return out.reshape(I, m, S)


def _replay(rows: _Rows, rules: Rules, stats, feat, thr, report):
    """Route the rows through the program's trees (feat, thr: (I, nodes)),
    reading at each node how far the gain of the program's choice falls
    below the best allowed candidate's (or none, where the reference
    would not split), as a share of its tree's root gain, into
    ``report["split_loss"]``; returns each row's leaf (I, n)."""
    I, n, S = stats.shape
    C, dt = rules.C, rows.dtype
    dev = rows.X.device
    pos = torch.zeros((I, n), dtype=torch.int64, device=dev)
    ar = torch.arange(n, device=dev)[None, :]
    lam = rules.lam.to(dt)[:, None, None]
    mw = rules.min_w.to(dt)[:, None]
    root = None
    for level in range(rules.depth_cap):
        m = 1 << level
        hist = rows.histogram(pos, stats, m)
        best = _gains(hist, rules, level).reshape(I, m, -1).max(2).values
        if root is None:
            root = torch.clamp(best[:, :1], min=1e-300)          # (I, 1)
        f = feat[:, m - 1:2 * m - 1].to(torch.int64)
        t = thr[:, m - 1:2 * m - 1].to(torch.float32)
        right = rows.X[ar, f.gather(1, pos)] > t.gather(1, pos)
        left = _node_sums(pos, stats, m, dt, ~right)
        tot = hist[:, :, :, 0, :].sum(3)                          # (I, m, S)
        GL, HL, WL = left[..., :C], left[..., C:2 * C], left[..., 2 * C]
        G, H, W = tot[..., :C], tot[..., C:2 * C], tot[..., 2 * C]
        chosen = (_score(GL, HL, lam) + _score(G - GL, H - HL, lam)
                  - _score(G, H, lam)).sum(2)
        ok = (WL >= mw) & (W - WL >= mw)
        allowed = rules.allowed(level)
        if allowed is not None:
            ok = ok & allowed.gather(2, f[..., None])[..., 0]
        may = rules.may_split(level)
        # the gain the reference's own choice makes at this node (none:
        # no split) and the gain of the program's choice (a split the
        # rules forbid loses the whole root gain)
        want = torch.where(may & (best > rules.gamma.to(dt)[:, None]), best,
                           torch.zeros_like(best))
        got = torch.where(torch.isfinite(t),
                          torch.where(ok & may, chosen, -root),
                          torch.zeros_like(best))
        lost = torch.clamp(want - got, min=0.0) / root
        report["split_loss"] = max(report.get("split_loss", 0.0),
                                   float(lost.max()))
        report["nodes"] = report.get("nodes", 0) + I * m
        pos = 2 * pos + right.to(torch.int64)
    return pos


def _grow(rows: _Rows, rules: Rules, stats, operand):
    """Grow I trees with the histogram's operands rounded by ``operand``
    and sums in the rows' dtype: (feat, thr (I, nodes), each row's leaf
    (I, n))."""
    I, n, _ = stats.shape
    dev = rows.X.device
    pos = torch.zeros((I, n), dtype=torch.int64, device=dev)
    ar = torch.arange(n, device=dev)[None, :]
    hstats = operand(stats) if operand is not None else stats
    feats, thrs = [], []
    for level in range(rules.depth_cap):
        m = 1 << level
        flat = _gains(rows.histogram(pos, hstats, m), rules,
                      level).reshape(I, m, -1)
        best, arg = flat.max(2)
        # the first of equal maxima, as the program's argmax takes
        first = (flat == best[..., None]).to(torch.int64).argmax(2)
        arg = torch.where(torch.isfinite(best), first, arg)
        f, b = arg // (rows.B - 1), arg % (rows.B - 1)
        do = (best > rules.gamma.to(best.dtype)[:, None]) \
            & rules.may_split(level)
        feats.append(torch.where(do, f, 0))
        thrs.append(torch.where(do, rows.edges[f, b].to(torch.float32),
                                torch.full_like(best, _INF,
                                                dtype=torch.float32)))
        tb = torch.where(do, b, rows.B - 1)
        right = rows.bins[ar, f.gather(1, pos)] > tb.gather(1, pos)
        pos = 2 * pos + right.to(torch.int64)
    return torch.cat(feats, 1), torch.cat(thrs, 1), pos


class _LeafErrors:
    """Each fit's leaf error over its trees: the row-weighted sums of
    (program's leaf value - G/(H+lam))^2 and of (G/(H+lam))^2 a tree."""

    def __init__(self):
        self.err, self.ref = [], []

    def add(self, got, want, rows):
        """got, want (I, L, C); rows (I, L) the weight each leaf holds."""
        r = rows.to(want.dtype)[..., None]
        self.err.append(((got.to(want.dtype) - want) ** 2 * r).sum((1, 2)))
        self.ref.append((want ** 2 * r).sum((1, 2)))

    def gap(self, fits: int) -> float:
        """The worst fit's worst tree's root-mean-square leaf error over
        its rows, as a share of that fit's largest root-mean-square leaf
        value (a late boosting round's leaves are small, so its own scale
        would read the f32 rounding its gradients carry as a large
        share). Each call of :meth:`add` holds its trees fit-major."""
        err = torch.cat([e.reshape(fits, -1) for e in self.err], 1)
        ref = torch.cat([r.reshape(fits, -1) for r in self.ref], 1)
        share = err.max(1).values / torch.clamp(ref.max(1).values,
                                                min=1e-300)
        return float(share.max()) ** 0.5


def _hyper(family, hyper):
    h = dict(DEFAULTS[family])
    h.update({k: float(v) for k, v in hyper.items()})
    return h


def _class_stats(y, w):
    """(..., n, 5): one-hot label times weight, the weight twice, the
    weight."""
    w = w.expand(y.shape) if w.dim() < y.dim() else w
    y = y.expand(w.shape)
    oh = torch.stack([1 - y, y], -1)
    return torch.cat([oh * w[..., None], w[..., None].expand(
        w.shape + (2,)), w[..., None]], -1)


def _per_fit(hs, key, dev, dtype=torch.float64):
    return torch.tensor([h[key] for h in hs], dtype=dtype, device=dev)


def _fits(family: str, hypers, rows: _Rows, y, w, params=None,
          operand=None, leaf_operand=None, draw_rows=None, n_draws=None):
    """Judge the program's fits of ``family`` at each hyper of
    ``hypers`` on the same ``rows`` (labels y, weights w: (n,)), its
    ``params`` holding each fit's arrays along a leading axis; or, with
    ``params`` None, grow them. A forest's draws are made over
    ``n_draws`` rows, of which the fits' rows are ``draw_rows`` (all
    when None). Returns the report or the grown params."""
    kind, depth_cap, cap = FAMILY[family]
    hs = [_hyper(family, h) for h in hypers]
    J = len(hs)
    dev, dt = rows.X.device, rows.dtype
    y, w = y.to(dt), w.to(dt)
    judge = params is not None
    rnd = OPERAND[operand] if operand else None
    lrnd = OPERAND[leaf_operand] if leaf_operand else None

    def lround(stats):
        return stats if lrnd is None else lrnd(stats.to(torch.float32))
    report: Dict[str, float] = {}
    errors = _LeafErrors()
    L = 1 << depth_cap
    if kind in ("dt", "rf"):
        trees = cap if kind == "rf" else 1
        active = [min(int(h.get("numTrees", 1)), trees) for h in hs]
        T = max(active) if judge else trees
        draws = {}
        if kind == "rf":
            for s in {int(h["seed"]) for h in hs}:
                boot, levels = forest_draws(s, trees, n_draws or rows.n,
                                            rows.d, depth_cap, dev)
                if draw_rows is not None:
                    boot = boot[:, draw_rows]
                draws[s] = (boot[:T], [lv[:T] for lv in levels])
        if kind == "rf":
            wt = torch.stack([w * draws[int(h["seed"])][0].to(dt)
                              for h in hs])                   # (J, T, n)
            subsets = [torch.stack([draws[int(h["seed"])][1][lv]
                                    for h in hs]).reshape(J * T, 1 << lv,
                                                          rows.d)
                       for lv in range(depth_cap)]
        else:
            wt, subsets = w.expand(J, 1, rows.n), None
        stats = _class_stats(y, wt).reshape(J * T, rows.n, 5)

        def rep(key):
            return _per_fit(hs, key, dev).repeat_interleave(T)
        rules = Rules(2, torch.full((J * T,), 1e-6, dtype=torch.float64,
                                    device=dev),
                      rep("minInfoGain"), rep("minInstancesPerNode"),
                      rep("maxDepth"), depth_cap, subsets,
                      rep("featureSubsetRate") if kind == "rf" else None)
        if judge:
            pos = _replay(rows, rules, stats, params["feat"][:, :T].reshape(
                J * T, -1), params["thr"][:, :T].reshape(J * T, -1), report)
        else:
            feat, thr, pos = _grow(rows, rules, stats.to(torch.float32), rnd)
        s = _node_sums(pos, lround(stats), L, dt)
        leaf = s[..., :2] / (s[..., 2:4] + 1e-6 + 1e-12)
        if not judge:
            return {"feat": feat.reshape(J, T, -1),
                    "thr": thr.reshape(J, T, -1),
                    "leaf": leaf.to(torch.float32).reshape(J, T, L, 2),
                    "tree_w": torch.stack([
                        (torch.arange(T, device=dev) < a).to(torch.float32)
                        / max(a, 1) for a in active])}
        live = torch.tensor([t < a for a in active for t in range(T)],
                            device=dev)
        errors.add(params["leaf"][:, :T].reshape(J * T, L, 2),
                   leaf, s[..., 4] * live[:, None])
        report["leaf_gap"] = errors.gap(J)
        return report
    # boosted: a logistic margin from each fit's weighted log-odds
    if any(h.get("subsample", 1.0) < 1.0 or h.get("colsampleByTree", 1.0)
           < 1.0 or h.get("colsampleByNode", 1.0) < 1.0 for h in hs):
        raise NotImplementedError("row or column subsampling")
    sw = torch.clamp(w.sum(), min=1e-6)
    p0 = torch.clamp((w * y).sum() / sw, 1e-5, 1 - 1e-5)
    base = torch.log(p0 / (1 - p0)).expand(J)
    if judge:
        # the base margin as a tree of one leaf that holds every row
        errors.add(params["base"].reshape(J, 1, 1), base.reshape(J, 1, 1),
                   sw.expand(J, 1))
    margin = base[:, None].expand(J, rows.n).clone()
    lr = _per_fit(hs, "stepSize", dev, dt)
    rules = Rules(1, _per_fit(hs, "regLambda", dev),
                  _per_fit(hs, "minSplitGain", dev),
                  _per_fit(hs, "minChildWeight", dev),
                  _per_fit(hs, "maxDepth", dev), depth_cap)
    lam = rules.lam.to(dt)[:, None, None]
    feats, thrs, leaves = [], [], []
    for r in range(cap):
        p = torch.sigmoid(margin)
        g = (y - p) * w
        hh = torch.clamp(p * (1 - p), min=1e-6) * w
        stats = torch.stack([g, hh, w.expand(J, rows.n)], 2)
        if judge:
            pos = _replay(rows, rules, stats, params["feat"][:, r],
                          params["thr"][:, r], report)
        else:
            f, th, pos = _grow(rows, rules, stats.to(torch.float32), rnd)
            feats.append(f)
            thrs.append(th)
        s = _node_sums(pos, lround(stats), L, dt)
        active = torch.tensor([1.0 if h["maxIter"] > r else 0.0 for h in hs],
                              dtype=dt, device=dev)
        leaf = s[..., :1] / (s[..., 1:2] + lam + 1e-12) \
            * (lr * active)[:, None, None]
        if judge:
            got = params["leaf"][:, r].to(dt)
            errors.add(got, leaf, s[..., 2])
        else:
            got = leaf.to(torch.float32)
            leaves.append(got)
        margin = margin + got.to(dt).gather(1, pos[..., None])[..., 0]
    if judge:
        report["leaf_gap"] = errors.gap(J)
        return report
    return {"feat": torch.stack(feats, 1), "thr": torch.stack(thrs, 1),
            "leaf": torch.stack(leaves, 1),
            "tree_w": torch.ones((J, cap), device=dev),
            "base": base.to(torch.float32).reshape(J, 1)}


def _merge(report, more):
    for k in ("split_loss", "leaf_gap"):
        report[k] = max(report.get(k, 0.0), more[k])
    report["nodes"] = report.get("nodes", 0) + more["nodes"]


def run(family: str, hyper, X: torch.Tensor, y: torch.Tensor,
        w: torch.Tensor, params: Optional[Dict[str, torch.Tensor]] = None,
        operand: Optional[str] = None, leaf_operand: Optional[str] = None,
        dtype=torch.float64):
    """Judge the program's fitted ``params`` of ``family`` at ``hyper``
    on rows (X, y, w), binned on their own sketch (a refit) ->
    {"split_loss", "leaf_gap", "nodes"}; or, with ``params`` None, grow
    them (histogram operands rounded to ``operand``, the leaf sums'
    operands to ``leaf_operand``, sums in ``dtype``) -> params in the
    program's layout.

    ``split_loss``: the most gain any node gives up, the best allowed
    candidate's (or none, where the reference would not split) less the
    program's choice's, as a share of its tree's root gain.
    ``leaf_gap``: see :meth:`_LeafErrors.gap`; a boosted base margin
    counts as a tree of one leaf (G and H from the program's own margin
    of its earlier rounds)."""
    X = X.to(torch.float32)
    rows = _Rows(X, edges_of(X, w), dtype)
    batch = None if params is None else {
        k: torch.as_tensor(v)[None] for k, v in params.items()}
    out = _fits(family, [hyper], rows, y, w, batch, operand, leaf_operand)
    return out if params is not None else {k: v[0] for k, v in out.items()}


def sweep(family: str, grid, X: torch.Tensor, y: torch.Tensor,
          w: torch.Tensor, fold: torch.Tensor, folds: int,
          params: Optional[Dict[str, torch.Tensor]] = None,
          operand: Optional[str] = None, leaf_operand: Optional[str] = None,
          dtype=torch.float64, score_operand: Optional[str] = None):
    """The cross-validation of ``family`` over ``grid`` on the training
    rows (X, y, w) with validation fold ids ``fold``: every fit binned on
    the one sketch of (X, w), fold f's fit of grid point j trained on the
    rows outside fold f and scored on the rows in it (AUROC weighted by
    w), the fit's arrays at ``params``' leading index f * len(grid) + j.
    Judges the program's fits -> (report over every fit, each grid
    point's mean AUROC of the program's fits); or, with ``params`` None,
    grows them (as :func:`run`, the scores rounded by ``score_operand``)
    -> (params in the program's layout, each grid point's mean AUROC)."""
    X = X.to(torch.float32)
    edges = edges_of(X, w)
    g = len(grid)
    report: Dict[str, float] = {}
    grown = []
    auc = torch.zeros((folds, g), dtype=torch.float64)
    srnd = OPERAND[score_operand] if score_operand else (lambda s: s)
    for f in range(folds):
        tr = torch.nonzero(fold != f)[:, 0]
        va = fold == f
        rows = _Rows(X[tr], edges, dtype)
        part = None if params is None else {
            k: torch.as_tensor(v)[f * g:(f + 1) * g] for k, v in
            params.items()}
        out = _fits(family, grid, rows, y[tr], w[tr], part, operand,
                    leaf_operand, draw_rows=tr, n_draws=X.shape[0])
        del rows
        if params is None:
            grown.append(out)
            part = out
        else:
            _merge(report, out)
        for j in range(g):
            pj = {k: v[j] for k, v in part.items()}
            s = srnd(score(family, grid[j], pj, X[va]))
            auc[f, j] = metrics.auroc(s, y[va], w[va])
    cv = [float(v) for v in auc.mean(0)]
    if params is not None:
        return report, cv
    return ({k: torch.stack([o[k] for o in grown]).reshape(
        (folds * g,) + grown[0][k].shape[1:]) for k in grown[0]}, cv)


def score(family: str, hyper, params, X: torch.Tensor) -> torch.Tensor:
    """P(label 1) of each row from fitted trees, in float64."""
    kind, depth_cap, _ = FAMILY[family]
    feat = params["feat"].to(torch.int64)
    thr = params["thr"].to(torch.float32)
    leaf = params["leaf"].to(torch.float64)
    T = feat.shape[0]
    n = X.shape[0]
    Xf = X.to(torch.float32)
    ar = torch.arange(n, device=X.device)
    out = torch.zeros((n, leaf.shape[-1]), dtype=torch.float64,
                      device=X.device)
    h = _hyper(family, hyper)
    if kind == "rf":
        active = min(int(h["numTrees"]), T)
        tw = [1.0 / max(active, 1) if t < active else 0.0 for t in range(T)]
    else:
        tw = [1.0] * T
    for t in range(T):
        if tw[t] == 0.0:
            continue
        pos = torch.zeros(n, dtype=torch.int64, device=X.device)
        for level in range(depth_cap):
            i = (1 << level) - 1 + pos
            pos = 2 * pos + (Xf[ar, feat[t][i]] > thr[t][i]).to(torch.int64)
        out += tw[t] * leaf[t][pos]
    if kind == "boost":
        return torch.sigmoid(out[:, 0] + params["base"].reshape(-1)[0]
                             .to(torch.float64))
    p = torch.clamp(out, min=0.0)
    s = p.sum(1)
    return torch.where(s > 1e-9, p[:, 1] / torch.clamp(s, min=1e-9),
                       torch.full_like(s, 0.5))

