#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process:

    python3 portbench/control.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--out <file>]

For each seed of ``--seeds``, one fit of the program through the same
entry the window drives (``entries.resolve``), judged by the entry's
``judge`` (the program's readings, whose largest is a limit's lower
reading); for each seed of ``--control-seeds``, the control judged the
same way: the reference put in the program's place one precision below
the configuration's (each entry's ``control``: ``check.control_fit``,
``check.control_sparse``), whose smallest is a limit's upper reading.
Each reading is printed as a JSON line and, with ``--out``, written
there. The benchmark's own runs never run the control. Like a run, it
fails when JAX or the JAX package is loaded once the readings are taken.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload, seeds, control_seeds, device="cuda", rows=None,
             emit=print):
    """[(side, seed, numbers)] for the program's and the control's
    seeds; ``rows`` cuts the configuration's rows (tests)."""
    sys.path.insert(0, ROOT)
    from portbench import run
    cell = run.load_cell(workload)
    mix = cell["mix"]
    out = []
    for side, seed in ([("program", s) for s in seeds]
                       + [("control", s) for s in control_seeds]):
        ent = cell["entry"](cell["config"], mix, seed, device, rows=rows)
        fit = ent.fit()
        if side == "control":
            fit = ent.control(fit, device)
        rec = {"side": side, "seed": seed,
               "numbers": ent.judge(fit, device),
               "winner": fit["summary"]["bestModel"]["family"]}
        emit(json.dumps(rec))
        out.append(rec)
        del ent, fit
    run.refuse_forbidden()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    recs = readings(args.workload, args.seeds, args.control_seeds,
                    emit=lambda s: print(s, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
