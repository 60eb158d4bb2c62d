#!/usr/bin/env python3
"""The every-type workflow in the JAX package and in the port, on the
CPU, over several data seeds: the readings behind the limits of
``tests/test_torch_features_e2e.py``.

For each seed, the workflow of ``chip_smoke.every_type_data`` /
``every_type_workflow`` is trained by both packages on the same rows
(the port's OpLDA handed the JAX package's initial lambda) in two
variants: ``lda`` (TextArea through OpLDA, 1,000 rows, LR/DT/GBT) and
``smart`` (TextArea through SmartTextVectorizer, 600 rows, LR/DT/GBT/
RF). Each line gives the two workflows' CV gaps per family and the
topics' largest gap; lambda's largest |gap| and |gap|/|lambda|; and on
the JAX package's own checked matrix the port selector's LR gap, and
for DT and GBT the gap between both packages' plain CV fits, the JAX
workflow's own gap to its plain fits, round 0's largest leaf gap where
round 0's splits agree, the largest gain gap where the trees part, and
how many fits part. One JSON line per (seed, variant) goes to standard
output.

Run from the repository root:
    JAX_PLATFORMS=cpu python3 tests/torch_every_type_probe.py [--seeds 0,1]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_features_e2e as T  # noqa: E402

VARIANTS = {"lda": (1000, T.CANDIDATES),
            "smart": (600, T.CANDIDATES + [["RandomForestClassifier",
                                             None]])}


def _lda_lambda(model):
    st = [s for s in model.stages if type(s).__name__ == "LDAModel"]
    if not st:
        return None
    lam = st[0].lam
    return np.asarray(lam.cpu() if isinstance(lam, torch.Tensor) else lam)


def reading(seed: int, variant: str) -> dict:
    rows, cands = VARIANTS[variant]
    j = T._train(T.J, rows, cands, textarea=variant, seed=seed)
    p = T._train(T.P, rows, cands, textarea=variant, seed=seed)
    out = {"seed": seed, "variant": variant, "rows": rows,
           "workflow_gaps": T.every_type_gaps(j, p, textarea=variant)}
    lj, lp = _lda_lambda(j[1]), _lda_lambda(p[1])
    if lj is not None:
        gap = np.abs(lj - lp)
        out["lambda_max_abs_gap"] = float(gap.max())
        out["lambda_max_rel_gap"] = float((gap / np.abs(lj)).max())
    if variant == "smart":
        jg, pg = (T.chip_smoke._grid_metrics(m.selected_model().summary)
                  for _, m in (j, p))
        rf = "RandomForestClassifier"
        out["rf_mean_gap"] = float(np.mean(pg[rf]) - np.mean(jg[rf]))
    same = T.selector_against_jax(j)
    lr = same["LogisticRegression"]
    out["same_matrix"] = {"LogisticRegression": T._gap(
        lr["port_selector"], lr["jax_workflow"])}
    for fam in ("DecisionTreeClassifier", "GBTClassifier"):
        r = same[fam]
        fits = r["fits"]
        out["same_matrix"][fam] = {
            "port_selector_vs_fits": T._gap(r["port_selector"], r["port"]),
            "fits_gap": T._gap(r["port"], r["jax"]),
            "jax_workflow_vs_fits": T._gap(r["jax_workflow"], r["jax"]),
            "round0_leaf_rel_gap_max": max(
                [d["round0_leaf_rel_gap"] for d in fits
                 if d["round0_splits_equal"]] + [0.0]),
            "gain_gap_max": max([d["divergence"]["gap_cpu"] for d in fits
                                 if d["divergence"]] + [0.0]),
            "fits_parted": sum(d["divergence"] is not None for d in fits),
            "fits": len(fits)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    ap.add_argument("--variants", default="lda,smart")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(reading(seed, variant)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
