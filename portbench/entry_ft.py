"""The ``ft`` entry: the binary selector cross-validating the published
FT-Transformer (``mixes/ft.json``: the one candidate
``FTTransformerPublishedClassifier`` over learning rate and weight decay)
on the configuration's rows, judged against the plain reference
(``reference/ft_transformer.py``).

Before any rows are made it refuses, with ``SystemExit``, a program
without that family and its counters, or whose family's recipe (its
attributes named as the configuration's ``model`` keys) differs from the
configuration's. Every fit records, by wrapping the program's functions
where the trees' entry wraps the grower (only to judge them):

* each sweep item's fold fit, as the family's ``fit_batch`` returns it,
  with its fold (the row plan);
* ``GRAD_STEPS`` item-steps drawn from the seed over every step of
  every item, sweep and refit alike (a reservoir over the steps in
  order): each one's parameters before it, the rule's epoch and step, the
  item's fold, its loss terms and its gradient;
* one more item-step drawn so: also the Adam moments and the step number
  before it, and the parameters and moments after it;
* the counters of the family (item-steps, rows stepped, padded items).

The judge (:meth:`FTEntry.judge`):

* ``step_loss_gap`` -- the drawn steps' loss terms (each batch row's
  weighted loss over the batch's weight, which sum to the loss) against
  the reference's, in f32, on the same parameters, the rows the rule
  gives (the item's fold, the epoch order) and the rule's dropout masks:
  relative L2 over the steps together (the root of the summed squared
  errors over the root of the summed squares);
* ``step_grad_gap`` -- the drawn steps' gradients against the
  reference's autograd on the same: each leaf's relative L2 over the
  steps together, the largest of the leaves (one leaf's gradient wrong
  reads as such, however small the leaf). The ReLU and ReGLU gates near
  zero flip under any rounding, so one step's gap grows as about the
  square root of the operands' rounding and swings by ten times from
  step to step with the gradient's size; over many steps it settles;
* ``update_gap`` -- the parameters' change and both moments after the
  step against the reference AdamW (its own parameter groups) applied to
  the program's gradient and state: the largest relative L2;
* ``ft_cv_gap`` -- each grid point's CV AUROC against the mean over folds
  of the reference's AUROC of the scores of the program's fold fits on
  the fold's validation rows;
* ``holdout_logit_gap`` -- the program's logits of the holdout rows from
  the refit parameters against the reference forward's, relative L2;
  ``holdout_auroc_gap`` -- the reported holdout AUROC against the
  reference's of its scores, ``holdout_logloss_gap`` the reported log
  loss against the reference's, relative;
* ``winner_gap`` -- the best reported CV metric less the winner's.

The control (:meth:`FTEntry.control`) is the reference one precision
below the configuration's: every block's product operands in float8
e4m3, and the gradients that flow back into them in float8 e5m2 scaled
to their largest entry, as fp8 training's hybrid recipe keeps them (bf16
stated); Adam's state and the parameters it writes in bf16 (f32
stated).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Mapping

import numpy as np
import torch

from . import check
from .entries import SelectorEntry
from .reference import ft_transformer as ref
from .reference import metrics, split
from .reference.precision import OPERAND

FAMILY = "FTTransformerPublishedClassifier"
#: the configuration's ``model`` keys the family carries as attributes
RECIPE = ("d_token", "n_blocks", "n_heads", "ffn_hidden",
          "attention_dropout", "ffn_dropout", "batch_size", "epochs")
#: the counters the entry reads off the family
COUNTERS = ("chunk_steps", "item_steps", "rows_stepped", "padded_items")
#: the control's precisions, one below the configuration's: float8
#: e4m3 operands, float8 e5m2 gradients (scaled), bf16 state
CONTROL_OPERAND = "fp8"
CONTROL_STATE = "bf16"
#: float8 e5m2's largest finite value
E5M2_MAX = 57344.0
#: rows a block of the reference's scoring
SCORE_ROWS = 8192
#: item-steps a fit records for ``step_loss_gap`` and ``step_grad_gap``
GRAD_STEPS = 16


def require_published(config: Mapping, mix: Mapping) -> Dict[str, Any]:
    """The configuration's recipe (``model``'s ``RECIPE`` keys);
    SystemExit naming what is missing where the mix names another
    family, the program lacks the family or its counters, or the
    family's recipe is not the configuration's."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    (name, _), = mix["candidates"]
    if name != FAMILY:
        raise SystemExit(f"portbench: the ft mix names {name!r}, not "
                         f"{FAMILY!r}")
    fam = MODEL_FAMILIES.get(FAMILY)
    missing = [k for k in RECIPE + COUNTERS if not hasattr(fam, k)]
    if missing:
        raise SystemExit(
            f"portbench: the program lacks the published FT-Transformer "
            f"the higgs.ft cell runs: its {FAMILY} has no "
            f"{', '.join(missing)}")
    model = config["model"]
    other = [f"{k} {getattr(fam, k)} (configuration {model[k]})"
             for k in RECIPE if getattr(fam, k) != model[k]]
    if other:
        raise SystemExit(f"portbench: the program's {FAMILY} is not the "
                         f"configuration's: {', '.join(other)}")
    return {k: model[k] for k in RECIPE}


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.to(torch.float64)
    b = b.to(a.device, torch.float64)
    return float((a - b).norm() / torch.clamp(b.norm(), min=1e-30))


def _rel_l2_over(pairs) -> float:
    """Relative L2 of (program, reference) pairs taken together."""
    err = sum(float((a.double() - b.to(a.device).double()).norm()) ** 2
              for a, b in pairs)
    ref_sq = sum(float(b.double().norm()) ** 2 for _, b in pairs)
    return math.sqrt(err) / max(math.sqrt(ref_sq), 1e-30)


def _worst_leaf(pairs, layout) -> float:
    """The largest relative L2 of a leaf over (program, reference) pairs
    of dense gradients, taken together."""
    sizes = [t.numel() for _, t in ref.leaves(layout.template)]
    split = [(a.split(sizes), b.split(sizes)) for a, b in pairs]
    return max(_rel_l2_over([(a[i], b[i]) for a, b in split])
               for i in range(len(sizes)))


class FTEntry(SelectorEntry):
    """``SelectorEntry`` over the published FT-Transformer's grid."""

    def __init__(self, config: Mapping, mix: Mapping, seed: int, device,
                 rows=None):
        self.cfg = require_published(config, mix)
        super().__init__(config, mix, seed, device, rows=rows)
        self.rng = np.random.default_rng(seed)

    # -- the fit ------------------------------------------------------------
    def fit(self) -> Dict[str, Any]:
        from transmogrifai_tpu_torch.models import MODEL_FAMILIES
        fam = MODEL_FAMILIES[FAMILY]
        before = {c: getattr(fam, c) for c in COUNTERS}
        out = super().fit()
        out["ft"] = {c: getattr(fam, c) - before[c] for c in COUNTERS}
        out["model"] = dict(self.cfg)
        out["n_holdout"] = int(out["summary"]["dataCounts"]["holdout"])
        return out

    @contextlib.contextmanager
    def sweep_fits(self, out: Dict[str, Any]):
        """Records each fold fit and the seed-drawn item-steps into
        ``out`` (``items``: [(fold, params)] in item order; ``steps``, the
        ``GRAD_STEPS`` records; ``step``, the one with its update), by
        wrapping the family's ``fit_batch`` and the step's two
        functions."""
        from transmogrifai_tpu_torch.models import ft_published as FT
        fam_cls = FT.FTTransformerPublishedClassifierFamily
        real_fit = fam_cls.fit_batch
        real_grad, real_adam = FT._train_loss_grad, FT._adamw_step
        out["items"] = []
        out["steps"] = steps = []
        seen = [0]
        pick: Dict[str, Any] = {}
        rng = self.rng

        def fit_batch(fam, X, y, w, hyper, n_classes, init=None, plan=None):
            params = real_fit(fam, X, y, w, hyper, n_classes, init=init,
                              plan=plan)
            if plan is not None and plan.folds[0] >= 0:
                real = len(plan.folds) - plan.padded
                for j in range(real):
                    out["items"].append((plan.folds[j], {
                        "net": _item(params["net"], j),
                        "mu": params["mu"][j], "sd": params["sd"][j]}))
            return params

        def loss_grad(flat, layout, Xs, y, w, at, *a, **k):
            live = [j for j in range(at.real) if at.active[j]]
            n0 = seen[0]
            seen[0] += len(live)
            j = None
            if live and rng.random() < len(live) / seen[0]:
                j = live[int(rng.integers(len(live)))]
            loss, g = real_grad(flat, layout, Xs, y, w, at, *a, **k)

            def record(i):
                return dict(fold=at.folds[i], epoch=at.epoch, step=at.step,
                            layout=layout, d=Xs.shape[-1],
                            p=_dense(layout, flat[i].detach()),
                            loss=loss[i].clone(), g=_dense(layout, g[i]))
            for n, i in enumerate(live, n0):
                slot = n if n < GRAD_STEPS else int(rng.integers(n + 1))
                if slot < len(steps):
                    steps[slot] = record(i)
                elif slot < GRAD_STEPS:
                    steps.append(record(i))
            if j is not None:
                pick.clear()
                pick.update(record(j), j=j, t=at.t[j])
            return loss, g

        def adam(flat, g, m, v, lr, wd, decay, at):
            j = pick.get("j") if "p_after" not in pick else None
            if j is not None:
                lay = pick["layout"]
                pick.update(m=_dense(lay, m[j]), v=_dense(lay, v[j]),
                            lr=lr[j].clone(), wd=wd[j].clone())
            real_adam(flat, g, m, v, lr, wd, decay, at)
            if j is not None:
                pick.update(p_after=_dense(lay, flat[j].detach()),
                            m_after=_dense(lay, m[j]),
                            v_after=_dense(lay, v[j]))
                out["step"] = dict(pick)

        fam_cls.fit_batch = fit_batch
        FT._train_loss_grad, FT._adamw_step = loss_grad, adam
        try:
            yield out
        finally:
            fam_cls.fit_batch = real_fit
            FT._train_loss_grad, FT._adamw_step = real_grad, real_adam

    # -- the judge ----------------------------------------------------------
    def _item_rows(self, rows: check.Rows, fold: int):
        """An item's training rows, weights and labels: its fold's
        training rows in order, or the whole split (fold -1)."""
        if fold < 0:
            return rows.X, rows.y, rows.w
        keep = rows.fold != fold
        return rows.X[keep], rows.y[keep], rows.w[keep]

    def _step_numbers(self, rows: check.Rows, st: Mapping,
                      operand=None):
        """The reference's loss terms, one a batch slot (a short last
        batch's empty slots zero, as the program's), and its flat
        gradient at the recorded step's parameters, on the rule's batch
        and masks."""
        Xi, yi, wi = self._item_rows(rows, st["fold"])
        mu, sd = ref.standardize(Xi, wi)
        B = int(self.cfg["batch_size"])
        pos = torch.as_tensor(ref.batch_positions(
            split.SELECTOR_SEED, st["fold"], st["epoch"], st["step"],
            len(yi), B), device=Xi.device)
        r = len(pos)
        masks = [{k: v[:r] for k, v in m.items()} for m in
                 ref.dropout_masks(self.cfg, split.SELECTOR_SEED,
                                   st["epoch"], st["step"], B, st["d"] + 1,
                                   Xi.device)]
        net = _tree(st["layout"], st["p"])
        loss, grads = ref.loss_and_grad(net, (Xi[pos] - mu) / sd, yi[pos],
                                        wi[pos], 2, masks, operand)
        return (torch.cat([loss, loss.new_zeros(B - r)]),
                torch.cat([g.reshape(-1) for g in grads]))

    def _decay(self, st: Mapping) -> torch.Tensor:
        net = _tree(st["layout"], st["p"])
        return torch.cat([torch.full((t.numel(),), float(ref.decays(p)),
                                     device=st["p"].device)
                          for p, t in ref.leaves(net)])

    def _scores(self, rows: check.Rows, fit: Mapping, operand=None):
        """(each item's validation AUROC by (fold, grid index), the
        holdout logits) of the reference over the fit's fold and refit
        parameters."""
        g = len(fit["summary"]["validationResults"][0]["grid"])
        aucs = {}
        for i, (fold, p) in enumerate(fit["sweep"]["items"]):
            if fold != i // g:
                return None, None
            keep = rows.fold == fold
            z = ref.logits_blocked(p["net"], p["mu"], p["sd"], rows.X[keep],
                                   SCORE_ROWS, operand)
            aucs[(fold, i % g)] = metrics.auroc(torch.sigmoid(z[:, 0]),
                                                rows.y[keep], rows.w[keep])
        pr = fit["params"]
        zh = ref.logits_blocked(pr["net"], pr["mu"], pr["sd"], rows.Xh,
                                SCORE_ROWS, operand)
        return aucs, zh

    def judge(self, fit: Mapping, device) -> Dict[str, float]:
        rows = check.Rows(self.X, self.y, self.folds, device)
        summary, sw = fit["summary"], fit["sweep"]
        out: Dict[str, float] = {}
        recs = sw.get("steps") or []
        if recs:
            want = [self._step_numbers(rows, r) for r in recs]
            out["step_loss_gap"] = _rel_l2_over(
                [(r["loss"], lw) for r, (lw, _) in zip(recs, want)])
            out["step_grad_gap"] = _worst_leaf(
                [(r["g"], gw) for r, (_, gw) in zip(recs, want)],
                recs[0]["layout"])
        else:
            out["step_loss_gap"] = out["step_grad_gap"] = math.inf
        st = sw.get("step")
        if st is None:
            out["update_gap"] = math.inf
        else:
            p, m, v = ref.adamw(st["p"], st["g"], st["m"], st["v"],
                                int(st["t"]), float(st["lr"]),
                                float(st["wd"]), self._decay(st))
            out["update_gap"] = max(_rel_l2(st["p_after"] - st["p"],
                                            p - st["p"]),
                                    _rel_l2(st["m_after"], m),
                                    _rel_l2(st["v_after"], v))
        vr = summary["validationResults"]
        aucs, zh = self._scores(rows, fit)
        if aucs is None or len(aucs) != self.folds * len(vr[0]["grid"]):
            out["ft_cv_gap"] = math.inf
        else:
            out["ft_cv_gap"] = max(
                abs(a - float(np.mean([aucs[(f, j)]
                                       for f in range(self.folds)])))
                for j, a in enumerate(vr[0]["gridMetrics"]))
        best = max(v for r in vr for v in r["gridMetrics"])
        j = check._grid_index(vr, summary["bestModel"])
        out["winner_gap"] = (best - vr[0]["gridMetrics"][j]
                             if j is not None else math.inf)
        got = fit.get("holdout_logits")
        if got is None:
            from transmogrifai_tpu_torch.models import MODEL_FAMILIES
            params = fit["params"]
            with torch.inference_mode():
                got = MODEL_FAMILIES[FAMILY].logits(params, rows.Xh)
        out["holdout_logit_gap"] = _rel_l2(got, zh)
        auc = metrics.auroc(torch.sigmoid(zh[:, 0]), rows.yh,
                            torch.ones_like(rows.yh))
        out["holdout_auroc_gap"] = abs(
            float(summary["holdoutEvaluation"]["AuROC"]) - auc)
        ll = metrics.logloss(torch.sigmoid(zh[:, 0]), rows.yh)
        out["holdout_logloss_gap"] = abs(
            float(summary["holdoutEvaluation"]["LogLoss"]) - ll) / ll
        return out

    def control(self, fit: Mapping, device) -> Dict[str, Any]:
        """The fit with the control's outputs in the program's place: the
        drawn steps' loss terms and gradients with float8 operands, the
        update with bf16 state, the CV metrics and holdout logits of the
        program's fold and refit parameters scored with float8 operands,
        the winner the best of those metrics."""
        rows = check.Rows(self.X, self.y, self.folds, device)
        op = ref.rounding(OPERAND[CONTROL_OPERAND], _scaled_fp8)
        low = OPERAND[CONTROL_STATE]
        sw = dict(fit["sweep"])
        sw["steps"] = [dict(r, **dict(zip(("loss", "g"),
                                          self._step_numbers(rows, r, op))))
                       for r in sw["steps"]]
        st = dict(sw["step"])
        loss, g = self._step_numbers(rows, st, op)
        p, m, v = ref.adamw(st["p"], g, st["m"], st["v"], int(st["t"]),
                            float(st["lr"]), float(st["wd"]),
                            self._decay(st))
        st.update(loss=loss, g=g, p_after=low(p),
                  m_after=low(m), v_after=low(v))
        sw["step"] = st
        aucs, zh = self._scores(rows, fit, op)
        vr = [dict(r) for r in fit["summary"]["validationResults"]]
        grid = vr[0]["grid"]
        vr[0]["gridMetrics"] = [
            float(np.mean([aucs[(f, j)] for f in range(self.folds)]))
            for j in range(len(grid))]
        best = {"family": FAMILY,
                "hyper": grid[int(np.argmax(vr[0]["gridMetrics"]))]}
        sh = OPERAND[CONTROL_STATE](torch.sigmoid(zh[:, 0]))
        ev = {"AuROC": metrics.auroc(sh, rows.yh, torch.ones_like(rows.yh)),
              "LogLoss": metrics.logloss(sh, rows.yh)}
        summary = dict(fit["summary"], validationResults=vr, bestModel=best,
                       holdoutEvaluation=ev)
        return dict(fit, summary=summary, sweep=sw, holdout_logits=zh)


def _scaled_fp8(g: torch.Tensor) -> torch.Tensor:
    """float8 e5m2 of a gradient scaled so its largest entry is e5m2's
    largest, and scaled back."""
    s = torch.clamp(g.abs().amax(), min=1e-30) / E5M2_MAX
    return (g / s).to(torch.float8_e5m2).to(torch.float32) * s


def _item(net, j: int):
    """Item j of a pytree with a leading item axis."""
    if isinstance(net, dict):
        return {k: _item(v, j) for k, v in net.items()}
    if isinstance(net, (list, tuple)):
        return [_item(v, j) for v in net]
    return net[j]


def _dense(layout, flat: torch.Tensor) -> torch.Tensor:
    """A flat parameter vector in the program's layout (its leaves
    aligned, gaps between) as the leaves' entries alone, in order."""
    return torch.cat([t.reshape(-1) for _, t in
                      ref.leaves(_item(layout.views(flat[None]), 0))])


def _tree(layout, dense: torch.Tensor):
    """Leaves' entries in order (:func:`_dense`) as the nested dict the
    reference reads."""
    shapes = [t.shape for _, t in ref.leaves(layout.template)]
    parts = dense.split([math.prod(s) for s in shapes])
    return ref.rebuild(layout.template,
                       iter(p.view(s) for p, s in zip(parts, shapes)))


ENTRY = FTEntry
