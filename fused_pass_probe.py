#!/usr/bin/env python3
"""One fused serving pass on the card, as chip_smoke.py's serving phase
probes it: ``FusedGroupScorer.launch`` then ``finalize`` over 60 rows of
the smoke's four-model catalog (one bucket slice), with the device
operations, device time and host time per pass.

``--package DIR`` measures the ``transmogrifai_tpu_torch`` package
under DIR instead of this checkout's (for example an earlier commit
unpacked with ``git archive``): the probe uses only the scorer's launch
/ finalize interface and the registry, which every version of the
package has. Prints one JSON line; exits 2 without a card.

Run from the repository root:
    python3 fused_pass_probe.py [--package DIR] [--seed N]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

import chip_smoke as cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", default=None,
                    help="directory holding the transmogrifai_tpu_torch "
                         "to measure (default: this checkout's)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.package:
        # ahead of this script's directory, which holds its own copy
        sys.path.insert(0, os.path.abspath(args.package))
    import transmogrifai_tpu_torch as port
    if not torch.cuda.is_available():
        print("fused_pass_probe: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    reg, _catalog = cs.build_catalog(args.seed, torch.device("cuda"))
    out = cs.fused_pass_probe(reg, args.seed)
    out.update(package=os.path.dirname(os.path.abspath(port.__file__)),
               card=cs.card_line())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
