#!/usr/bin/env python3
"""The tree histogram kernel's shared-bins launches, bit for bit, across
two versions of the package: ``save`` writes the histograms of seeded
inputs at chip_smoke.py's HIST_SHAPES, in both operand modes (bf16, and
f32 under TM_KERNEL_EXACT=1), launched through ``histogram_grid``;
``compare`` launches the same and prints, per shape and mode, whether
it equals the saved file bitwise. It is the check for a change to the
kernel that must keep the shared-bins launches' bits: save with the
parent commit's package, compare with the change's.

``--package DIR`` runs the ``transmogrifai_tpu_torch`` package under
DIR instead of this checkout's (for example an earlier commit unpacked
with ``git archive``); each run builds its own kernel. Exits 2 without
a card, 1 when ``compare`` finds a difference.

Run from the repository root:
    python3 hist_bits_probe.py save FILE --package OLD_DIR
    python3 hist_bits_probe.py compare FILE
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

import chip_smoke as cs


def histograms(tk) -> dict:
    out = {}
    for i, (label, G, n, d, S, m, B) in enumerate(cs.HIST_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        bins = torch.randint(0, B, (n, d), generator=gen, device="cuda",
                             dtype=torch.int32)
        stats = torch.randn((G, n, S), generator=gen, device="cuda")
        pos = torch.randint(0, m, (G, n), generator=gen, device="cuda",
                            dtype=torch.int32)
        for exact in ("0", "1"):
            with cs.env(TM_KERNEL_EXACT=exact, TM_HIST_BF16="1"):
                out[f"{label}/exact={exact}"] = tk.histogram_grid(
                    bins, stats, pos, m, B).cpu()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("save", "compare"))
    ap.add_argument("file")
    ap.add_argument("--package", default=None,
                    help="directory holding the transmogrifai_tpu_torch "
                         "to run (default: this checkout's)")
    args = ap.parse_args(argv)
    if args.package:
        # ahead of this script's directory, which holds its own copy
        sys.path.insert(0, os.path.abspath(args.package))
    from transmogrifai_tpu_torch.models import kernels as tk
    if not torch.cuda.is_available():
        print("hist_bits_probe: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    got = histograms(tk)
    if args.mode == "save":
        torch.save(got, args.file)
        return 0
    ref = torch.load(args.file)
    same = {k: bool(torch.equal(v, ref[k])) for k, v in got.items()}
    print(json.dumps({"card": cs.card_line(), "kernels": tk.__file__,
                      "bitwise": same}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
