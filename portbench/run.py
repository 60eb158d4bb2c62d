#!/usr/bin/env python3
"""Run one cell of the benchmark once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/<name>.json``: the rows' shape and generator) and a
mix (``portbench/mixes/<name>.json``: the entry it drives and its
parameters; ``entries.resolve`` finds the entry by name, in
``entries.py`` or ``portbench/entry_<name>.py``); its limits are
``portbench/limits/<cell>.json`` and each per-layer metric is read by
``portbench/metrics/<name>.py``.

Set-up (counted as ``setup_s``, from process start): the rows from
``--seed``, the entry's one untimed warm-up fit at the cell's shapes,
which builds the kernels into the checkout's ``portbench/_cache``. The
window then runs whole fits back to back, from the first timed fit to
the first fit that completes once ``--seconds`` have passed (with
``--trace 1``: the profiler on, at most ``TRACE_FITS`` fits). Once it
closes, the peak memory is read, one fit drawn from the seed is judged
against the plain reference, and the result is printed as the last
line of standard output: the end-to-end metrics (``--trace 0``) or the
per-layer ones (``--trace 1``), ``cold_build`` (whether this run's
set-up built kernels into the cache), then the compared numbers
beside their limits under ``checks``, which also end standard error.

It fails, printing no result, without a CUDA device, with fewer devices
than the cell asks for, when any fit fails, or when JAX or the JAX
package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import gc         # noqa: E402
import importlib  # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
#: fits the traced window holds at most
TRACE_FITS = 2
#: top-level module names that must not be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "transmogrifai_tpu")


def log(what: str) -> None:
    """A phase's time since process start, on standard error."""
    print(f"portbench: {what} at {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr, flush=True)


def _environment() -> None:
    """Fixed cache directories inside the checkout, the program's knobs
    at their defaults, and no library loading JAX on its own."""
    for k in list(os.environ):
        if k.startswith("TM_"):
            del os.environ[k]
    cache = os.path.join(BENCH, "_cache")
    os.environ["TM_COMPILE_CACHE_DIR"] = os.path.join(cache, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def cached_kernels() -> set:
    """What the kernel cache holds."""
    d = os.environ.get("TM_COMPILE_CACHE_DIR", "")
    return set(os.listdir(d)) if os.path.isdir(d) else set()


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell's entry class, configuration, mix, limits and metrics, by
    the names ``BENCHMARK.json`` gives. A mix whose entry cannot be found
    fails here, before any rows are made."""
    from portbench.entries import resolve
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
    w = cells[name]

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in moved and mine(m)]
    mix = _load("mixes", w["traffic"])
    return {"workload": w, "entry": resolve(mix.get("entry")),
            "config": _load("configs", w["config"]),
            "mix": mix, "limits": _load("limits", name),
            "end_to_end": e2e, "per_layer": layer}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def refuse_forbidden() -> None:
    """Raises Forbidden if JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        raise Forbidden(found)


def window(entry, seconds: float, trace: bool, cuda: bool = True):
    """Whole fits back to back: (fits, window seconds, trace, histogram
    shapes). The window ends when the first fit completes once
    ``seconds`` have passed (traced: after TRACE_FITS at most)."""
    from portbench.trace import traced
    import contextlib
    fits, shapes = [], []
    rec = entry.record_shapes(shapes) if trace else contextlib.nullcontext()
    with traced(trace, cuda, entry.SPAN) as tr, rec:
        t0 = time.perf_counter()
        while True:
            fits.append(entry.fit())
            el = time.perf_counter() - t0
            if el >= seconds or (trace and len(fits) >= TRACE_FITS):
                break
    return fits, el, tr["trace"], shapes


def read_layers(cell: dict, run: dict) -> dict:
    out = {}
    for m in cell["per_layer"]:
        mod = importlib.import_module("portbench.metrics." + m["name"])
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", rows=None, warmup: bool = True):
    """Everything of a run after the look for a chip: set-up, the window,
    the judged fit, the result (its last key ``checks``) and the table of
    compared numbers. ``device`` and ``rows`` exist for a rehearsal on
    the CPU at a small size (no memory or trace of a card there). The
    result's ``cold_build`` marks a run whose set-up built kernels into
    the cache: its ``setup_s`` is not a cached run's."""
    import numpy as np
    import torch
    from portbench import check
    cuda = torch.device(device).type == "cuda"
    mix = cell["mix"]
    cached = cached_kernels()
    entry = cell["entry"](cell["config"], mix, seed, device, rows=rows)
    log("rows made")
    if warmup:
        entry.fit()                               # the warm-up fit
    setup_s = time.perf_counter() - T_START
    cold = bool(cached_kernels() - cached)
    log("set-up done")
    fits, window_s, trace_, shapes = window(entry, seconds, trace, cuda)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    log(f"window closed after {len(fits)} fits")
    refuse_forbidden()

    pick = int(np.random.default_rng(seed).integers(len(fits)))
    judged = fits[pick]
    for f in fits:
        if f is not judged:
            f["params"] = f["sweep"] = None
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = entry.judge(judged, device)
    log("fit judged")
    table = check.verdict(numbers, cell["limits"])

    chips = int(cell["workload"]["chips"])
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    result = {"correct": check.all_ok(table), "attempted": len(fits),
              "failed": 0}
    if trace:
        run = {"fits": fits, "trace": trace_, "hist_shapes": shapes,
               "window_s": window_s, "cell": cell}
        result["metrics"] = read_layers(cell, run)
        if trace_ is not None:
            dev["busy_s"] = trace_.busy_s()
            dev["window_s"] = trace_.window_s
        result["device"] = dev
        if trace_ is not None:
            result["breakdown"] = {"device_ops": trace_.top_device_ops(),
                                   "idle_gaps": trace_.idle_gaps()}
        log("trace read")
    else:
        values = {mix["fit_metric"]: window_s / len(fits),
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell["end_to_end"]}
        result["device"] = dev
    result["cold_build"] = cold
    result["checks"] = {k: {"value": r["value"], "limit": r["limit"]}
                        for k, r in table.items()}
    refuse_forbidden()      # the judge and the readers loaded nothing
    return result, table


class Forbidden(RuntimeError):
    """JAX or the JAX package was loaded in the process."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    cell = load_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        result, table = run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace))
    except Forbidden as e:
        print(f"portbench: loaded in this process: {e}", file=sys.stderr)
        return 3
    for k, r in table.items():
        print(f"check {k}: {r['value']!r} limit {r['limit']!r} "
              f"{'ok' if r['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
