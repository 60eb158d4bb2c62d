#!/usr/bin/env python3
"""How far torch.profiler's device timestamps stray from the host's, and
whether a trace keeps every kernel: sessions of 40 launches of the fused
scorer at the smoke's prefix_64 shape (static launch), through
chip_smoke.py's ``profiled``, with the host idling 0 s and
``PROFILE_PAD_S`` on each side of the launches. For each setting it
counts the scorer kernels each trace holds and reads, in each session,
the start of the first kernel minus the start of its launch call (a few
µs on an idle card when both clocks agree; below 0 the card's clock
reads earlier than the host's).

Prints one line a setting and, last, one JSON object; exits 2 without
a card. Run from the repository root:
    python3 profiler_probe.py [--sessions N] [--seed N]
"""
from __future__ import annotations

import argparse
import collections
import json
import sys

import numpy as np
import torch

import chip_smoke as cs

#: launches of the scorer in one profiler session (the autotune phase's)
CALLS = cs.TUNE_SERVE_CALLS


def session_reading(run, pad: float):
    """(scorer kernels in the trace, first kernel's start minus first
    launch call's start in us, or None) of one profiler session."""
    from torch.autograd import DeviceType
    saved, cs.PROFILE_PAD_S = cs.PROFILE_PAD_S, pad
    try:
        prof, _ = cs.profiled(lambda: [run() for _ in range(CALLS)],
                              host=True)
    finally:
        cs.PROFILE_PAD_S = saved
    events = prof.events()
    kernels = sorted(e.time_range.start for e in events
                     if e.device_type == DeviceType.CUDA
                     and cs.TUNE_SERVE_KERNEL in e.name)
    launches = sorted(e.time_range.start for e in events
                      if e.device_type == DeviceType.CPU
                      and "LaunchKernel" in e.name)
    offset = kernels[0] - launches[0] if kernels and launches else None
    return len(kernels), offset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=90,
                    help="profiler sessions for each padding")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_probe: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    from transmogrifai_tpu_torch import _cuda_build
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    card = cs.card_line()
    _cuda_build.build_all()
    label, n, C, p, K, L, form = cs.TUNE_SERVE[0]
    inputs = cs._serve_inputs(np.random.default_rng(args.seed), form, n, C,
                              p, K, L, torch.device("cuda"))

    def run():
        return cs._serve_call(sk, form, inputs, sk.STATIC_LAUNCH_CONFIG)

    run()
    out = {"shape": label, "calls": CALLS, "card": card, "settings": []}
    for pad in (0.0, cs.PROFILE_PAD_S):
        counts, offsets = collections.Counter(), []
        for _ in range(args.sessions):
            kernels, offset = session_reading(run, pad)
            counts[kernels] += 1
            if offset is not None:
                offsets.append(offset)
        row = {"pad_s": pad, "sessions": args.sessions,
               "kernels_traced": {str(k): v for k, v in
                                  sorted(counts.items())},
               "first_kernel_after_launch_us": {
                   "min": min(offsets), "median": float(np.median(offsets)),
                   "max": max(offsets)}}
        out["settings"].append(row)
        print(f"profiler_probe: pad {pad} s: kernels a trace of {CALLS} "
              f"launches {row['kernels_traced']}; first kernel minus first "
              f"launch call {row['first_kernel_after_launch_us']} us "
              f"[{card}]", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
