#!/usr/bin/env python3
"""How far the card's exact-mode GBT fits come from the CPU's, on
several seeds of chip_smoke.py's training data, and how far they come
under planted faults of the histogram: the readings behind chip_smoke's
GBT_GAP_RTOL and GBT_PARITY_TOL.

For each seed, the CPU's exact-mode GBT selector and one fit per grid
point on GBT_PARITY_ROWS rows are the reference; the same on
``--device`` is read in three arms:

  sound     exact mode (f32 operands), the kernel as it is;
  bf16      operands rounded to bf16 where exact mode keeps f32 (the
            histogram rounding at the wrong point);
  drop_row  each node's last row left out of every level's histogram
            (an off-by-one at the end of a node's rows).

Each arm gives the largest validation-AUROC difference over the grid
points and, per grid point, the first node where the trees part with
the gain gap of its two splits (chip_smoke.first_divergence). One JSON
line per (seed, arm) goes to standard output.

Run from the repository root:
    python3 gbt_parity_probe.py [--seeds 0,1,2,3] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import chip_smoke as cs


def drop_last_row(stats: torch.Tensor, pos: torch.Tensor,
                  m: int) -> torch.Tensor:
    """The stats with each (instance, node)'s last row, in row order,
    set to zero."""
    G, n, _ = stats.shape
    rows = torch.arange(n, device=pos.device).expand(G, n)
    last = torch.full((G, m), -1, dtype=torch.int64, device=pos.device)
    last = last.scatter_reduce(1, pos.long(), rows, "amax")
    g, node = (last >= 0).nonzero(as_tuple=True)
    out = stats.clone()
    out[g, last[g, node]] = 0.0
    return out


GBT = "GBTClassifier"
ARMS = {
    "sound": ({"TM_KERNEL_EXACT": "1"}, None),
    "bf16": ({"TM_KERNEL_EXACT": "0", "TM_HIST_BF16": "1"}, None),
    "drop_row": ({"TM_KERNEL_EXACT": "1"}, drop_last_row),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=cs.GBT_PARITY_ROWS)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("gbt_parity_probe: CUDA is not available", file=sys.stderr)
            return 2
        print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        X, y = cs.training_data(seed, args.rows)
        t0 = time.perf_counter()
        cpu = cs.tree_side(GBT, X, y, "cpu", {"TM_KERNEL_EXACT": "1"})
        cpu_s = time.perf_counter() - t0
        for arm, (knobs, fault) in ARMS.items():
            t0 = time.perf_counter()
            side = cs.tree_side(GBT, X, y, args.device, knobs, fault)
            row = dict(cs.tree_compare(GBT, side, cpu, X), seed=seed,
                       arm=arm, rows=args.rows, device=args.device,
                       wall_s=time.perf_counter() - t0, cpu_wall_s=cpu_s)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
