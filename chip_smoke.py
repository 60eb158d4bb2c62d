#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two paths — fused multi-model LR serving and
tree-model AutoML training — through the entry points a user calls,
and holds each CUDA kernel against its plain PyTorch version:

1. device: the card's name and power limit (nvidia-smi), then every
   kernel under ``transmogrifai_tpu_torch/csrc`` built with nvcc for
   sm_90a, all builds started together;
2. kernel: ``fused_linear_scores`` against ``fused_linear_scores_torch``
   on the card at the serving shapes (and the top bucket, a softmax
   head, a ragged n, an inf weight in a model no row selects), in f32
   and bf16 operand modes, timed beside its bound, the plain version
   and one PyTorch library call: ``ms`` is the device time per call
   (torch.profiler), ``call_ms`` the CUDA-event time per call with the
   host's issue gaps, ``launch_ms`` the call time of an empty kernel
   launched through the same C entry path;
3. serving: four all-numeric LR models (12 Real columns, impute with
   null tracking, concat, a seeded keep_cols subset, a binary
   LogisticRegression head) built from ``--seed`` in the portable IR,
   loaded through ``portable.from_portable``, served as a 100-id
   catalog (4 backends + 96 aliases) by a ``ServingEngine`` with the
   fused plane on, buckets (16, 64) and max_batch_rows 64, under 8
   client threads sending Zipf(1.1) model ids. Every request carries a
   trace id, so the engine's spans say which plane served it: a fused
   request must match its model's numpy score under the fused operand
   policy, a classic one under f32. The fused plane and the kernel's
   launch counter must have moved. The storm is repeated under
   torch.profiler for the device's busy share;
4. hist_kernel: ``tree_histogram`` against ``histogram_torch`` on the
   card at the shapes the training path gives it (the histogram capture
   shape, a GBT level, XGBoost's last level, an RF level, a ragged n
   with one node and one instance), in both operand modes: float stats
   to a stated tolerance, integer stats bitwise, two launches bitwise,
   one instance alone equal to its slice of the batch; timed beside its
   bound, the plain version and the one-hot GEMM ``torch.matmul``;
5. training: ``BinaryClassificationModelSelector`` with 3-fold CV over
   DecisionTree/RandomForest/GBT/XGBoost at default grids and
   registered caps on 200k x 28 HIGGS-shaped rows from ``--seed``,
   through ``fit_transform``. The histogram launches must equal the
   tree levels the code grows, the winner must beat a linear score on
   the holdout; the fit is repeated under torch.profiler (busy share,
   the kernel's share), and the card is held to the CPU (an exact-mode
   decision tree bitwise; exact-mode GBT trees parting only at near
   ties, and its AUROC per grid point within a tolerance).

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when CUDA is unavailable or any phase fails.

Run from the repository root:  python3 chip_smoke.py [--seed N]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

#: the serving configuration of the repo's fused-serving benchmark
N_COLUMNS = 12          # Real columns, 5% missing
P_KEEP = 22             # keep_cols subset of the 24 impute+indicator columns
N_BACKENDS = 4          # stackable LR backends
N_MODELS = 100          # catalog ids: 4 backends + 96 aliases
BUCKETS = (16, 64)
MAX_BATCH_ROWS = 64
ZIPF_A = 1.1
REQUESTS = 256          # of 1-8 rows each
THREADS = 8             # closed-loop clients

#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
#: FLOP/s of the f32 pipes outside the tensor cores. The kernel's inputs
#: are f32 in both operand modes (bf16 rounding happens in registers)
#: and its FMAs run in f32, so the f32 rate bounds its operations.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

#: kernel vs plain version on the same card and the same rounded
#: operands: f32 accumulation in another order over <= 25 products
KERNEL_RTOL = 1e-4
#: served probabilities vs the numpy oracle (f64 after the same operand
#: rounding): f32 accumulation and f32 sigmoid
SERVE_ATOL = 1e-4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def round_bf16(a: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even of f32 values to bf16, returned as f32
    (the rounding ``torch.Tensor.to(torch.bfloat16)`` applies)."""
    a = np.ascontiguousarray(a, np.float32)
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(a), out, a)


@contextlib.contextmanager
def env(**values):
    """Set environment variables (the port's numerics knobs) for the
    block, restoring each one's old value or absence after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def call_ms(fn, rounds: int = 21, calls: int = 50) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``calls``
    back-to-back calls, per call: the card's stream time as a caller
    sees it, host issue gaps included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return float(np.median(per_call))


PROFILE_ATTEMPTS = 3


def profiled(run, host: bool = True):
    """Run ``run()`` under torch.profiler (CUDA activity, and CPU
    activity when ``host``) and return (the profile, run's result). A
    session whose trace holds no device event at all (CUPTI now and
    then delivers an empty one) is repeated, up to PROFILE_ATTEMPTS
    sessions; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            result = run()
            torch.cuda.synchronize()
        if any(ev.device_type == DeviceType.CUDA
               for ev in prof.key_averages()):
            return prof, result
    raise AssertionError(f"torch.profiler recorded no device time in "
                         f"{PROFILE_ATTEMPTS} sessions")


def device_ms(fn, calls: int = 50):
    """(ms, device events) per call: the summed device time of every
    kernel and copy ``fn`` puts on the card, from torch.profiler's
    CUPTI trace over ``calls`` calls."""
    for _ in range(3):
        fn()
    prof, _ = profiled(lambda: [fn() for _ in range(calls)])
    total_us, events = _device_time_us(prof)
    return total_us / calls / 1e3, events / calls


def _device_time_us(prof):
    """(summed device time in us, device events) of every kernel and
    copy in a torch.profiler trace; raises if it holds none."""
    from torch.autograd import DeviceType
    total_us, events = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = ev.cuda_time_total
            total_us += dev_us
            events += ev.count
    if not events:
        raise AssertionError("torch.profiler recorded no device time")
    return total_us, events


def kernel_case(sk, rng, n, p, K, L, dtype, inf_model=False):
    """Kernel vs plain version on the card at one shape and operand
    dtype, with timings. Returns one result row (raises on a
    disagreement or a non-finite result)."""
    dev = torch.device("cuda")
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = (0.5 * rng.normal(size=(K, p + 1, L))).astype(np.float32)
    mid = rng.integers(0, K - 1 if inf_model else K, size=n).astype(np.int32)
    if inf_model:
        W[K - 1] = np.inf      # no row selects model K-1
    Xt = torch.from_numpy(X).to(dev)
    Wt = torch.from_numpy(W).to(dev)
    mt = torch.from_numpy(mid).to(dev)
    got = sk.fused_linear_scores(Xt, Wt, mt, dtype=dtype)
    torch.cuda.synchronize()
    ref = sk.fused_linear_scores_torch(Xt, Wt, mt, dtype=dtype)
    got_np, ref_np = got.cpu().numpy(), ref.cpu().numpy()
    if not np.isfinite(got_np).all():
        raise AssertionError(f"non-finite kernel output at {(n, p, K, L)}")
    err = float(np.max(np.abs(got_np - ref_np))) if n else 0.0
    lim = KERNEL_RTOL * (1.0 + np.abs(ref_np))
    if not (np.abs(got_np - ref_np) <= lim).all():
        raise AssertionError(
            f"kernel disagrees with plain version at {(n, p, K, L)} "
            f"{dtype}: max abs err {err}")
    if dtype == torch.float32 and not inf_model:
        oracle = sk.np_reference_scores(X, W, mid)
        if not np.allclose(got_np, oracle, rtol=KERNEL_RTOL,
                           atol=KERNEL_RTOL):
            raise AssertionError(f"kernel disagrees with the f64 oracle "
                                 f"at {(n, p, K, L)}")
    out = torch.empty_like(got)
    kernel = lambda: sk.fused_linear_scores(Xt, Wt, mt, dtype=dtype)  # noqa: E731
    plain = lambda: sk.fused_linear_scores_torch(Xt, Wt, mt, dtype=dtype)  # noqa: E731
    bias, weights, ml = Wt[:, p:p + 1, :], Wt[:, :p, :], mt.long()

    def library():
        # yardstick only (f32): gather each row's block + one batched GEMM
        torch.baddbmm(bias[ml], Xt[:, None, :], weights[ml],
                      out=out[:, None, :])

    floor = sk.fused_cost_floor(n, p, K, L)
    dname = str(dtype).replace("torch.", "")
    bytes_ms = floor["analytic_gbytes"] * 1e9 / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * n * (p + 1) * L / F32_FLOPS_PER_S * 1e3
    row = {"shape": [n, p, K, L], "dtype": dname, "inf_model": inf_model,
           "max_abs_err": err,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    arms = [("", kernel), ("plain_", plain)]
    if not inf_model:
        arms.append(("library_", library))
    for prefix, fn in arms:
        row[prefix + "ms"], row[prefix + "device_events"] = device_ms(fn)
        row[prefix + "call_ms"] = call_ms(fn)
    row.setdefault("library_ms", None)
    return row


def launch_ms(sk) -> float:
    """CUDA-event time per call of an empty kernel launched through the
    kernel library's C entry path (ctypes, current stream): what any
    launch through that path costs before the kernel does any work."""
    lib = sk._library()

    def empty():
        err = lib.tm_empty_launch(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"empty launch failed: {lib.tm_cuda_error_string(err)}")

    return call_ms(empty)


def kernel_phase(seed: int):
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    rng = np.random.default_rng(seed)
    rows = []
    for n, p, K, L in [(64, P_KEEP, N_BACKENDS, 1), (64, 24, 4, 1),
                       (37, 24, 4, 1), (32768, 24, N_MODELS, 1),
                       (4096, 24, 8, 3)]:
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(kernel_case(sk, rng, n, p, K, L, dtype))
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(kernel_case(sk, rng, 64, 24, 4, 1, dtype,
                                inf_model=True))
    return rows


# ---------------------------------------------------------------------------
# phase 3: fused multi-model serving
# ---------------------------------------------------------------------------

def make_model_ir(rng, name: str):
    """One all-numeric LR workflow in the portable IR (what the JAX
    package's export_portable writes): 12 impute(track) stages, concat,
    a seeded keep_cols subset, a binary LogisticRegression head. Returns
    (manifest, arrays, numpy parameters for the oracle)."""
    raw = [f"x{i}" for i in range(N_COLUMNS)]
    vec = [f"{c}_vec" for c in raw]
    fills = rng.normal(0.0, 0.1, N_COLUMNS)
    keep = np.sort(rng.choice(2 * N_COLUMNS, P_KEEP, replace=False))
    beta = rng.normal(0.0, 0.5, P_KEEP + 1)
    stages = [{"out": v, "inputs": [c], "op": "impute",
               "fill": float(f), "track": True}
              for c, v, f in zip(raw, vec, fills)]
    stages.append({"out": "combined", "inputs": vec, "op": "concat"})
    stages.append({"out": "checked", "inputs": ["label", "combined"],
                   "op": "keep_cols"})
    stages.append({"out": name, "inputs": ["label", "checked"],
                   "op": "predict", "family": "LogisticRegression",
                   "nClasses": 2})
    manifest = {"format": 1, "boundary": raw + ["label"],
                "responseBoundary": ["label"], "resultNames": [name],
                "hostPrefix": [], "stages": stages,
                "scoreBuckets": list(BUCKETS)}
    n_impute = len(raw)
    arrays = {str(n_impute + 1): {"keep": keep.astype(np.int32)},
              str(n_impute + 2): {"params": {"beta": beta}}}
    return manifest, arrays, {"fills": fills, "keep": keep, "beta": beta}


def oracle_probs(cols, par, bf16: bool) -> np.ndarray:
    """The model's numpy score of one request: f32 features (impute,
    null indicators, concat, keep), operands rounded to bf16 when the
    fused kernel's policy does, f64 dot, sigmoid pair."""
    feats = []
    for i in range(N_COLUMNS):
        c = np.asarray(cols[f"x{i}"], np.float32)
        isnull = np.isnan(c)
        feats += [np.where(isnull, np.float32(par["fills"][i]), c),
                  isnull.astype(np.float32)]
    X = np.stack(feats, axis=1)[:, par["keep"]]
    w = par["beta"].astype(np.float32)
    if bf16:
        X, w = round_bf16(X), np.concatenate([round_bf16(w[:-1]), w[-1:]])
    z = X.astype(np.float64) @ w[:-1].astype(np.float64) + float(w[-1])
    p1 = 1.0 / (1.0 + np.exp(-z))
    return np.stack([1.0 - p1, p1], axis=1)


def build_catalog(seed: int, device):
    """The 100-id catalog: m000..m003 loaded through
    portable.from_portable on ``device``, m004..m099 aliases over them
    round-robin. Returns (registry, {model id: (result name, oracle
    parameters)})."""
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.serving import ModelRegistry
    rng = np.random.default_rng(seed)
    reg = ModelRegistry()
    warm = {f"x{i}": np.zeros(1) for i in range(N_COLUMNS)}
    backends = {}
    for k in range(N_BACKENDS):
        name = f"m{k:03d}"
        manifest, arrays, par = make_model_ir(rng, f"pred_{name}")
        pm = portable.from_portable(manifest, arrays, device)
        reg.register(name, pm, buckets=BUCKETS, warm_sample=warm,
                     make_default=(k == 0))
        backends[name] = (f"pred_{name}", par)
    catalog = dict(backends)
    for k in range(N_BACKENDS, N_MODELS):
        target = f"m{k % N_BACKENDS:03d}"
        reg.alias(f"m{k:03d}", target)
        catalog[f"m{k:03d}"] = backends[target]
    return reg, catalog


def _storm(eng, reqs, threads: int, traces=None):
    """Closed-loop clients: ``threads`` threads, each submitting its
    share of ``reqs`` one at a time and waiting for the result, request
    ``r`` under trace id ``traces[r]`` (None: untraced). Returns
    (results, latencies in s, wall s); raises a client's error."""
    lat = [0.0] * len(reqs)
    results = [None] * len(reqs)
    errors = []

    def client(t):
        try:
            for r in range(t, len(reqs), threads):
                t0 = time.perf_counter()
                results[r] = eng.submit(
                    reqs[r][1], model=reqs[r][0],
                    trace=None if traces is None else traces[r]
                ).result(60)
                lat[r] = time.perf_counter() - t0
        except BaseException as e:   # re-raised below, after the join
            errors.append(e)

    t0 = time.perf_counter()
    workers = [threading.Thread(target=client, args=(t,))
               for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return results, lat, wall


def _walled(run):
    """A zero-argument callable running ``run`` to the card's end and
    returning its wall in s."""
    def go():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    return go


def _device_busy(run):
    """Profile one call of ``run`` (torch.profiler): (summed device
    time of its kernels and copies in s, their count, its wall s)."""
    prof, wall = profiled(_walled(run))
    busy_us, events = _device_time_us(prof)
    return busy_us / 1e6, events, wall


def _served_planes(spans, traces):
    """Which plane served each traced request, from the engine's own
    spans: a request's ``engine.execute`` span names the batch it rode
    in, and that batch span is ``engine.fused_dispatch`` (one fused
    kernel pass over several backends) or ``engine.batch`` (a classic
    per-backend pass). Returns ({trace: "fused" | "classic"}, the fused
    dispatch spans); raises if a request's spans are missing."""
    kind = {"engine.fused_dispatch": "fused", "engine.batch": "classic"}
    batches = {s["trace"]: kind[s["name"]] for s in spans
               if s["name"] in kind}
    plane = {s["trace"]: batches.get(s["attrs"]["batch"])
             for s in spans if s["name"] == "engine.execute"}
    missing = [t for t in traces if plane.get(t) is None]
    if missing:
        raise AssertionError(f"{len(missing)} requests left no execute "
                             f"span naming their batch")
    return plane, [s for s in spans if s["name"] == "engine.fused_dispatch"]


def serving_phase(seed: int, device, requests: int = REQUESTS,
                  launches=None, profile=False):
    """Serve ``requests`` requests of 1-8 rows from THREADS client
    threads (Zipf model ids over the catalog) through the fused engine
    and check every result against its model's numpy score under the
    operand policy of the plane that served it. ``launches`` is a
    zero-argument callable returning the kernel's launch count (read
    before and after the storm). ``profile`` (CUDA only) repeats the
    storm on a second engine under torch.profiler for the device's busy
    share. Returns the phase's measurements; raises on any failure."""
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.profiling import percentile_nearest_rank
    from transmogrifai_tpu_torch.serving import EngineConfig, ServingEngine
    from transmogrifai_tpu_torch.telemetry.spans import TRACER
    reg, catalog = build_catalog(seed, device)
    rng = np.random.default_rng(seed + 1)
    ids = sorted(catalog)
    pz = 1.0 / np.arange(1, len(ids) + 1) ** ZIPF_A
    picks = rng.choice(len(ids), size=requests, p=pz / pz.sum())
    reqs = []
    for j in picks:
        n = int(rng.integers(1, 9))
        cols = {f"x{i}": np.where(rng.random(n) < 0.05, np.nan,
                                  rng.normal(size=n))
                for i in range(N_COLUMNS)}
        reqs.append((ids[j], cols))
    # ~5 spans per request must all stay in the tracer's ring
    if TRACER.capacity < 8 * requests:
        raise AssertionError(f"trace capacity {TRACER.capacity} is too "
                             f"small for {requests} traced requests")
    TRACER.clear()
    traces = [TRACER.mint("req") for _ in reqs]
    cfg = EngineConfig(max_batch_rows=MAX_BATCH_ROWS, fused_kernel=True)
    eng = ServingEngine(registry=reg, config=cfg).start()
    sk.fused_linear_scores.launches = 0
    tk.histogram_grid.launches = 0
    before = 0 if launches is None else launches()
    try:
        results, lat, wall = _storm(eng, reqs, THREADS, traces)
        moved = None if launches is None else launches() - before
    finally:
        eng.stop()
    if tk.histogram_grid.launches:
        raise AssertionError("serving launched the histogram kernel")
    stats = eng.stats.as_dict()
    plane, fused_spans = _served_planes(TRACER.spans(), traces)
    bf16 = sk.serve_dtype(device) == torch.bfloat16
    matched = {"fused": 0, "classic": 0}
    for (model, cols), res, tid in zip(reqs, results, traces):
        name, par = catalog[model]
        how = plane[tid]
        want = oracle_probs(cols, par, bf16 and how == "fused")
        err = float(np.abs(res[name] - want).max())
        if not err <= SERVE_ATOL:
            raise AssertionError(
                f"request for {model} served by the {how} plane disagrees "
                f"with its numpy score under that plane's operand policy: "
                f"max abs err {err}")
        matched[how] += 1
    if matched["fused"] != stats["fused_requests"]:
        raise AssertionError(f"spans show {matched['fused']} fused "
                             f"requests, the engine {stats['fused_requests']}")
    for key, want in (("failed", 0), ("fused_fallbacks", 0)):
        if stats[key] != want:
            raise AssertionError(f"engine {key} = {stats[key]}, want {want}")
    if stats["fused_batches"] <= 0:
        raise AssertionError("the fused plane never engaged")
    if moved is not None and moved <= 0:
        raise AssertionError("the fused kernel never launched")
    rows = sum(len(c["x0"]) for _, c in reqs)
    lat_ms = sorted(x * 1e3 for x in lat)
    fused_ms = sorted(s["dur"] * 1e3 for s in fused_spans)
    out = {"requests": requests, "rows": rows, "threads": THREADS,
           "wall_s": wall, "rows_per_s": rows / wall,
           "p50_ms": percentile_nearest_rank(lat_ms, 0.50),
           "p99_ms": percentile_nearest_rank(lat_ms, 0.99),
           "kernel_launches": moved, "matched": matched,
           "fused_batches": stats["fused_batches"],
           "fused_requests": stats["fused_requests"],
           "fused_fallbacks": stats["fused_fallbacks"],
           "fused_rows": stats["fused_rows"], "batches": stats["batches"],
           "completed": stats["completed"], "failed": stats["failed"],
           "wait_p50_ms": stats["wait_p50_ms"],
           # the engine's execute segment of a fused pass (its
           # engine.fused_dispatch span): gather, launch, copy out
           "fused_dispatch_p50_ms": percentile_nearest_rank(fused_ms, 0.50),
           "fused_dispatch_p99_ms": percentile_nearest_rank(fused_ms, 0.99),
           "fused_dispatch_rows_mean": (stats["fused_rows"]
                                        / stats["fused_batches"]),
           "host_overhead_p50_us": {
               k: v["p50_us"] for k, v in
               stats["requestOverhead"]["segments"].items()}}
    if profile:
        eng2 = ServingEngine(registry=reg, config=cfg).start()
        try:
            busy_s, events, pwall = _device_busy(
                lambda: _storm(eng2, reqs, THREADS))
        finally:
            eng2.stop()
        st2 = eng2.stats.as_dict()
        out.update(profiled_wall_s=pwall, device_busy_s=busy_s,
                   device_busy_share=busy_s / pwall,
                   device_events=events,
                   profiled_batches=st2["batches"],
                   profiled_fused_batches=st2["fused_batches"],
                   device_ms_per_batch=busy_s / st2["batches"] * 1e3,
                   device_events_per_batch=events / st2["batches"])
    return out


# ---------------------------------------------------------------------------
# phase 4: the tree histogram kernel against its plain version
# ---------------------------------------------------------------------------

#: (label, G, n, d, S, m, B): the shapes the training path gives the
#: kernel (the RF level's rows cut to 50k so its plain version fits)
HIST_SHAPES = [
    ("capture", 16, 200_000, 28, 5, 8, 32),
    ("gbt_level", 12, 200_000, 28, 3, 16, 32),
    ("xgb_last_level", 6, 200_000, 28, 3, 32, 32),
    ("rf_level", 192, 50_000, 28, 5, 16, 32),
    ("ragged_m1_g1", 1, 1_237, 28, 5, 1, 32),
]
#: kernel vs plain version on float stats: f32 sums in another order
#: (a sequential sum over each block's rows, then over <= 32 block
#: partials), each cell within HIST_RTOL of the sum of its |terms|
HIST_RTOL = 1e-4
#: H100 SXM bf16 dense tensor-core peak (NVIDIA data sheet): the
#: one-hot GEMM yardstick's operation rate
BF16_FLOPS_PER_S = 989e12


def _timed(fn, budget_s: float = 0.25):
    """(device ms per call from torch.profiler, CUDA-event ms per call)
    with call counts sized so each measurement takes ~``budget_s``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-6)
    calls = int(min(50, max(3, budget_s / one)))
    dev, _events = device_ms(fn, calls=calls)
    return dev, call_ms(fn, rounds=5 if one > 0.01 else 21, calls=calls)


def kernel_split_ms(fn, calls: int = 10) -> dict:
    """Device ms per call of each of the histogram kernel's device
    functions (torch.profiler), keyed by function name."""
    import re
    from torch.autograd import DeviceType
    fn()
    prof, _ = profiled(lambda: [fn() for _ in range(calls)], host=False)
    split = {}
    for ev in prof.key_averages():
        hit = re.search(r"tree_hist_\w+", ev.key)
        if ev.device_type == DeviceType.CUDA and hit:
            split[hit.group(0)] = (split.get(hit.group(0), 0.0)
                                   + ev.device_time_total / calls / 1e3)
    return split


def hist_case(tk, label, G, n, d, S, m, B, dtype, seed):
    """Kernel vs plain version at one shape, with timings, under knobs
    that make the operand dtype ``dtype``. Returns one result row;
    raises on a disagreement."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (n, d), generator=gen, device=dev,
                         dtype=torch.int32)
    stats = torch.randn((G, n, S), generator=gen, device=dev)
    pos = torch.randint(0, m, (G, n), generator=gen, device=dev,
                        dtype=torch.int32)
    got = tk.histogram_grid(bins, stats, pos, m, B)
    torch.cuda.synchronize()
    ref = tk.histogram_torch(bins, stats, pos, m, B)
    scale = tk.histogram_torch(bins, stats.abs(), pos, m, B)
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite histogram at {label}")
    err = float((got - ref).abs().max())
    if not bool(((got - ref).abs() <= HIST_RTOL * scale + 1e-6).all()):
        raise AssertionError(f"tree_histogram disagrees with its plain "
                             f"version at {label} {dtype}: max abs err {err}")
    if not torch.equal(tk.histogram_grid(bins, stats, pos, m, B), got):
        raise AssertionError(f"two launches differ at {label}")
    for g in sorted({0, G - 1}):
        one = tk.histogram_grid(bins, stats[g:g + 1].contiguous(),
                                pos[g:g + 1].contiguous(), m, B)
        if not torch.equal(one[0], got[g]):
            raise AssertionError(f"instance {g} alone differs from its "
                                 f"slice of the batch at {label}")
    exact = False
    if dtype == torch.float32:      # exact mode, integer stats: bitwise
        istats = torch.randint(-3, 4, (G, n, S), generator=gen, device=dev
                               ).to(torch.float32)
        if not torch.equal(tk.histogram_grid(bins, istats, pos, m, B),
                           tk.histogram_torch(bins, istats, pos, m, B)):
            raise AssertionError(f"integer stats not bitwise at {label}")
        exact = True
    del scale, ref
    # library yardstick: the one-hot GEMM A^T Z in the operand dtype
    # (f32 accumulation), A and Z built outside the timing
    Z = torch.nn.functional.one_hot(bins.long(), B).reshape(n, d * B).to(
        dtype)
    node = torch.nn.functional.one_hot(pos.long(), m).to(torch.float32)
    A = (node[:, :, :, None] * stats[:, :, None, :]).permute(1, 0, 2, 3) \
        .reshape(n, G * m * S).to(dtype)
    del node
    cost = tk.histogram_cost(G, n, d, S, m, B)
    bytes_ms = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = cost["adds"] / F32_FLOPS_PER_S * 1e3
    plan = tk.launch_plan(G, n, d, S, m, B)
    row = {"shape": label, "G": G, "n": n, "d": d, "S": S, "m": m, "B": B,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "integer_stats_bitwise": exact, "deterministic": True,
           "batch_independent": True,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "onehot_gemm_gflop": 2.0 * G * m * S * d * B * n / 1e9,
           "plan": plan}
    arms = [("", lambda: tk.histogram_grid(bins, stats, pos, m, B)),
            ("plain_", lambda: tk.histogram_torch(bins, stats, pos, m, B)),
            ("library_", lambda: torch.matmul(A.T, Z))]
    for prefix, fn in arms:
        row[prefix + "ms"], row[prefix + "call_ms"] = _timed(fn)
    row["split_ms"] = kernel_split_ms(arms[0][1])
    return row


def hist_phase(seed: int):
    from transmogrifai_tpu_torch.models import kernels as tk
    rows = []
    modes = [(torch.bfloat16, {"TM_KERNEL_EXACT": "0", "TM_HIST_BF16": "1"}),
             (torch.float32, {"TM_KERNEL_EXACT": "1"})]
    for i, (label, *shape) in enumerate(HIST_SHAPES):
        for dtype, knobs in modes:
            with env(**knobs):
                rows.append(hist_case(tk, label, *shape, dtype, seed + i))
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5: tree-model AutoML training
# ---------------------------------------------------------------------------

TRAIN_ROWS = 200_000
TRAIN_FEATURES = 28                 # HIGGS' width
TREE_FAMILIES = ["DecisionTreeClassifier", "RandomForestClassifier",
                 "GBTClassifier", "XGBoostClassifier"]
#: exact-mode GBT, card vs CPU, on GBT_PARITY_ROWS rows of the training
#: data. The kernel, the leaf products and sigmoid sum and round f32 in
#: another order on the card, so its histograms differ from the CPU's
#: in their last bits, a split whose two best candidates' gains are that
#: close may go either way, and the trees differ from there on. In one
#: fit per grid point, at the first node where the card's and the CPU's
#: trees split differently: the two splits' gains (recomputed in f64
#: from each side's histogram of that level) differ by at most
#: GBT_GAP_RTOL of their scale, and the two histograms by at most
#: GBT_HIST_RTOL of their largest cell. Validation AUROC per grid point
#: within GBT_PARITY_TOL. gbt_parity_probe.py reads all three on seeds
#: 0-3 and under two planted histogram faults (PERF.md): the sound
#: card's largest gap was 1.6e-8 and histogram difference 4.6e-7, the
#: faults' smallest 2.2e-4 and 4.3e-4; AUROC differences overlap
#: (sound up to 0.0076, faults from 0.0057), so the AUROC limit, twice
#: the largest sound reading, is a guard against gross faults only.
GBT_PARITY_ROWS = 8_000
GBT_GAP_RTOL = 1e-6
GBT_HIST_RTOL = 1e-5
GBT_PARITY_TOL = 0.015


def training_data(seed: int, n: int = TRAIN_ROWS):
    """HIGGS-shaped synthetic rows: 28 Real features, a nonlinear
    (XOR-style) label of a few of them plus noise, balanced so the
    default DataBalancer keeps unit weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, TRAIN_FEATURES)).astype(np.float32)
    z = (X[:, 0] * X[:, 1] + 0.5 * np.sin(2.0 * X[:, 2]) + 0.3 * X[:, 3]
         + 0.3 * rng.normal(size=n))
    return X, (z > 0).astype(np.float32)


def _selector(X, y, candidates, device):
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    ds = Dataset({"y": y.astype(np.float64), "x": X},
                 {"y": ft.RealNN, "x": ft.OPVector})
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    sel = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=3, candidates=candidates, device=device).set_input(lbl, vec)
    return ds, sel


def _linear_auroc(X, y, idx_tr, idx_ho) -> float:
    """Holdout AUROC of a least-squares linear score (numpy f64): the
    linear yardstick the tree winner must beat."""
    from transmogrifai_tpu_torch.evaluators import functional as F
    A = np.concatenate([X, np.ones((len(X), 1), np.float32)], 1)
    coef = np.linalg.lstsq(A[idx_tr].astype(np.float64), y[idx_tr] - 0.5,
                           rcond=None)[0]
    s = (A[idx_ho] @ coef).astype(np.float32)
    return float(F.auroc(torch.from_numpy(s), torch.from_numpy(y[idx_ho])))


def _exact_fit(X, y, candidates, device):
    with env(TM_KERNEL_EXACT="1"):
        ds, sel = _selector(X, y, candidates, device)
        return sel.fit(ds)


@contextlib.contextmanager
def hist_hook(record=None, fault=None):
    """Pass the growers' histogram calls through a hook: where given,
    ``fault(stats, pos, m)`` replaces the stats the kernel sees (a
    planted fault), and each level's histogram is appended, on the
    CPU, to ``record``."""
    from transmogrifai_tpu_torch.models import trees
    real = trees.histogram_grid

    def hooked(bins, stats, pos, m, B):
        if fault is not None:
            stats = fault(stats, pos, m)
        h = real(bins, stats, pos, m, B)
        if record is not None:
            record.append(h.cpu())
        return h
    trees.histogram_grid = hooked
    try:
        yield
    finally:
        trees.histogram_grid = real


def gbt_side(X, y, device, knobs, fault=None):
    """The GBT selector on ``device`` under the environment ``knobs``:
    its validation AUROC per grid point, and per grid point one fit on
    all rows with each level's histogram recorded."""
    from transmogrifai_tpu_torch import models as TM
    fam = TM.MODEL_FAMILIES["GBTClassifier"]
    with env(**knobs), hist_hook(fault=fault):
        ds, sel = _selector(X, y, ["GBTClassifier"], device)
        res = sel.fit(ds).summary["validationResults"][0]
    Xt, yt = torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)
    w = torch.ones(len(y), device=device)
    fits = []
    for hyper in res["grid"]:
        hists = []
        with env(**knobs), hist_hook(record=hists, fault=fault):
            params = fam.fit_kernel(Xt, yt, w, hyper, 2)
        fits.append(({k: v.cpu() for k, v in params.items()}, hists))
    return {"metrics": np.asarray(res["gridMetrics"]), "grid": res["grid"],
            "fits": fits}


def _node_gains(hist, node, lam, min_w, B):
    """The gain of every (feature, bin) split of ``node``, in f64, from
    one level's (1, m*S, d*B) logistic histogram (stats g, h, w): the
    grower's formula, -inf where a child would weigh under ``min_w``;
    and each gain's scale, the sum of its three terms' magnitudes (what
    f32 rounding of the histogram moves a gain in proportion to)."""
    h = hist[0].double()
    d = h.shape[1] // B
    cum = h.reshape(-1, 3, d, B)[node].cumsum(-1)             # (3, d, B)
    GL, HL, WL = cum[0, :, :-1], cum[1, :, :-1], cum[2, :, :-1]
    G, H, W = cum[0, :, -1:], cum[1, :, -1:], cum[2, :, -1:]

    def score(g, hh):
        return g * g / (hh + lam + 1e-12)
    left, right, parent = score(GL, HL), score(G - GL, H - HL), score(G, H)
    ok = (WL >= min_w) & (W - WL >= min_w)
    gain = torch.where(ok, left + right - parent,
                       torch.full_like(left, -np.inf))
    return gain, left.abs() + right.abs() + parent.abs()


def first_divergence(card, cpu, edges, hyper, max_depth):
    """The first (round, node), in growing order, where one fit's trees
    on the card and on the CPU split differently; the two splits'
    gains in each side's own histogram of that level, and their gap
    relative to the gains' scale (:func:`_node_gains`); the histograms'
    largest difference there relative to their largest cell. None when
    the trees agree."""
    (pa, ha), (pb, hb) = card, cpu
    fa, ta, fb, tb = pa["feat"], pa["thr"], pb["feat"], pb["thr"]
    same = (fa == fb) & ((ta == tb) | (torch.isinf(ta) & torch.isinf(tb)))
    bad = (~same).nonzero()
    if len(bad) == 0:
        return None
    r, i = (int(v) for v in bad[0])       # round, then heap (level) order
    level = (i + 1).bit_length() - 1
    node = i - ((1 << level) - 1)
    B = edges.shape[1] + 1

    def split(f, t):                      # (feature, bin); None: a leaf
        if torch.isinf(t):
            return None
        hit = (edges[int(f)] == t).nonzero()
        return (int(f), int(hit[0]) if len(hit) else -1)
    sa, sb = split(fa[r, i], ta[r, i]), split(fb[r, i], tb[r, i])
    out = {"round": r, "level": level, "node": node,
           "split_card": sa, "split_cpu": sb}
    call = r * max_depth + level
    for side, h in (("card", ha[call]), ("cpu", hb[call])):
        gains, scale = _node_gains(h, node, hyper["regLambda"],
                                   hyper["minChildWeight"], B)
        # a leaf's "gain" is minSplitGain, the bar a split must clear
        val = [float(hyper["minSplitGain"]) if sp is None
               else float(gains[sp]) if sp[1] >= 0 else float("nan")
               for sp in (sa, sb)]
        top = max([float(scale[sp]) for sp in (sa, sb)
                   if sp is not None and sp[1] >= 0] + [1e-30])
        out[f"gains_{side}"] = val
        out[f"gap_{side}"] = (abs(val[0] - val[1]) / top
                              if np.isfinite(val).all() else float("inf"))
    out["hist_rel_diff"] = float((ha[call] - hb[call]).abs().max()
                                 / hb[call].abs().max().clamp(min=1e-30))
    return out


def gbt_compare(card, cpu, X):
    """Card side against CPU side (:func:`gbt_side`): the largest AUROC
    difference over grid points, and each grid point's first
    divergence with the largest gain gap and histogram difference over
    them."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.models import trees
    fam = TM.MODEL_FAMILIES["GBTClassifier"]
    edges = trees._prep(torch.from_numpy(X), fam.n_bins,
                        torch.ones(len(X)))[1]
    divs = [first_divergence(a, b, edges, hyper, fam.max_depth_cap)
            for a, b, hyper in zip(card["fits"], cpu["fits"], cpu["grid"])]
    return {"metric_max_diff": float(np.max(np.abs(card["metrics"]
                                                   - cpu["metrics"]))),
            "gain_gap_max": max((max(d["gap_card"], d["gap_cpu"])
                                 for d in divs if d), default=0.0),
            "hist_diff_max": max((d["hist_rel_diff"] for d in divs if d),
                                 default=0.0),
            "metrics_card": card["metrics"].tolist(),
            "metrics_cpu": cpu["metrics"].tolist(),
            "divergence": divs}


def training_phase(seed: int, rows: int = TRAIN_ROWS, device="cuda"):
    """The selector's main path on ``device`` (launch count, winner,
    timings), a profiled repeat (busy and kernel shares; CUDA only) and
    the card-vs-CPU checks. ``rows`` and ``device`` exist for a CPU
    rehearsal at a small size. Returns the phase's measurements."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.models.base import params_to_numpy
    from transmogrifai_tpu_torch.models.tuning import DataSplitter
    X, y = training_data(seed, rows)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ds, sel = _selector(X, y, TREE_FAMILIES, device)
    sync()
    tk.histogram_grid.launches = 0
    sk.fused_linear_scores.launches = 0
    t0 = time.perf_counter()
    model, scored = sel.fit_transform(ds)
    sync()
    fit_wall = time.perf_counter() - t0
    launches = tk.histogram_grid.launches
    summ = model.summary
    winner = summ["bestModel"]["family"]
    expected = (sum(TM.MODEL_FAMILIES[f].levels_per_fit()
                    for f in TREE_FAMILIES)
                + TM.MODEL_FAMILIES[winner].levels_per_fit())
    if device == "cuda" and launches != expected:
        raise AssertionError(f"{launches} histogram launches, the code "
                             f"grows {expected} tree levels")
    if sk.fused_linear_scores.launches:
        raise AssertionError("training launched the serving kernel")
    col = scored.column(model.output.name)
    if len(col) != rows or not all(
            0.0 <= r["probability_1"] <= 1.0 for r in col[:1000]):
        raise AssertionError("scored column malformed")
    tr_idx, ho_idx = DataSplitter(seed=sel.params["seed"]).split(rows)
    linear = _linear_auroc(X, y, tr_idx, ho_idx)
    holdout = summ["holdoutEvaluation"]["AuROC"]
    if winner not in TREE_FAMILIES or not holdout >= linear + 0.1:
        raise AssertionError(f"winner {winner} holdout AUROC {holdout} vs "
                             f"linear {linear}")
    for name, p in params_to_numpy(model.model_params).items():
        if p.dtype.kind == "f" and np.isnan(p).any():
            raise AssertionError(f"NaN in refit params {name}")

    out = {"rows": rows, "features": TRAIN_FEATURES,
           "train_rows": summ["dataCounts"]["train"],
           "fit_transform_wall_s": fit_wall,
           "family_wall_s": summ["wallSeconds"]["families"],
           "refit_wall_s": summ["wallSeconds"]["refit"],
           "winner": winner, "winner_hyper": summ["bestModel"]["hyper"],
           "winner_val_auroc":
               summ["bestModel"]["validationMetric"]["auroc"],
           "holdout_auroc": holdout, "linear_holdout_auroc": linear,
           "grid_metrics": {r["family"]: r["gridMetrics"]
                            for r in summ["validationResults"]},
           "histogram_launches": launches, "expected_launches": expected}
    if device == "cuda":
        out.update(_profiled_fit(X, y))
    out.update(_card_vs_cpu(X, y, device))
    return out


def _profiled_fit(X, y):
    """The same selector fit again under torch.profiler (device activity
    only): the device's busy share of the fit's wall and the histogram
    kernel's share of device time."""
    from torch.autograd import DeviceType
    ds, sel = _selector(X, y, TREE_FAMILIES, "cuda")
    prof, wall = profiled(_walled(lambda: sel.fit(ds)), host=False)
    busy_us, events = _device_time_us(prof)
    kern_us = 0.0
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        if "tree_hist_" in ev.key:
            kern_us += ev.device_time_total
        top.append((ev.device_time_total, ev.count, ev.key[:90]))
    top.sort(reverse=True)
    return {"profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_events": events, "kernel_device_s": kern_us / 1e6,
            "kernel_share_of_device": kern_us / busy_us,
            "top_device_ops": [{"ms": us / 1e3, "count": c, "name": k}
                               for us, c, k in top[:10]]}


def _card_vs_cpu(X, y, device):
    """The card held to the CPU: the exact-mode decision-tree selector's
    refit bitwise (integer-valued stats); exact-mode GBT on
    GBT_PARITY_ROWS rows, its trees parting only at near ties
    (GBT_GAP_RTOL, GBT_HIST_RTOL) and its AUROC per grid point within
    GBT_PARITY_TOL."""
    from transmogrifai_tpu_torch.models.base import params_to_numpy
    dt_gpu = _exact_fit(X, y, ["DecisionTreeClassifier"], device)
    dt_cpu = _exact_fit(X, y, ["DecisionTreeClassifier"], "cpu")
    pg, pc = (params_to_numpy(m.model_params) for m in (dt_gpu, dt_cpu))
    for k in ("feat", "thr"):
        if not np.array_equal(pg[k], pc[k]):
            raise AssertionError(f"exact-mode DT refit {k} differs "
                                 f"between the card and the CPU")
    dt_metric_diff = float(np.max(np.abs(
        np.asarray(dt_gpu.summary["validationResults"][0]["gridMetrics"])
        - dt_cpu.summary["validationResults"][0]["gridMetrics"])))
    # ... and GBT on a row count the CPU fits in seconds
    Xs, ys = X[:GBT_PARITY_ROWS], y[:GBT_PARITY_ROWS]
    t2 = time.perf_counter()
    card = gbt_side(Xs, ys, device, {"TM_KERNEL_EXACT": "1"})
    t3 = time.perf_counter()
    cpu = gbt_side(Xs, ys, "cpu", {"TM_KERNEL_EXACT": "1"})
    t4 = time.perf_counter()
    gbt = gbt_compare(card, cpu, Xs)
    if not (gbt["gain_gap_max"] <= GBT_GAP_RTOL
            and gbt["hist_diff_max"] <= GBT_HIST_RTOL):
        raise AssertionError(
            f"GBT trees card vs CPU part at a split that is no near tie: "
            f"gain gap {gbt['gain_gap_max']} (limit {GBT_GAP_RTOL}), "
            f"histograms {gbt['hist_diff_max']} apart (limit "
            f"{GBT_HIST_RTOL}): {gbt['divergence']}")
    if not gbt["metric_max_diff"] <= GBT_PARITY_TOL:
        raise AssertionError(f"GBT grid metrics card vs CPU differ by "
                             f"{gbt['metric_max_diff']} > {GBT_PARITY_TOL}")
    return {
        "dt_exact_feat_thr_bitwise": True,
        "dt_exact_metric_max_diff": dt_metric_diff,
        "gbt_parity_rows": len(ys),
        "gbt_metric_max_diff": gbt["metric_max_diff"],
        "gbt_gain_gap_max": gbt["gain_gap_max"],
        "gbt_hist_diff_max": gbt["hist_diff_max"],
        "gbt_grid_metrics_card": gbt["metrics_card"],
        "gbt_grid_metrics_cpu": gbt["metrics_cpu"],
        "gbt_divergence": gbt["divergence"],
        "gbt_gpu_wall_s": t3 - t2, "gbt_cpu_wall_s": t4 - t3,
    }


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # the port itself, from the checkout this script sits in
    from transmogrifai_tpu_torch import _cuda_build
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2

    card = card_line()
    print(f"card: {card}", flush=True)
    # the plain versions' f32 matrix products are the f32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _cuda_build.build_all()
    print(f"phase device: built {_cuda_build.kernel_names()} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for name, log in _cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  nvcc {name}: {line.strip()}", file=sys.stderr)

    rows = kernel_phase(args.seed)
    for r in rows:
        print("phase kernel: " + json.dumps(r), flush=True)
    empty_ms = launch_ms(sk)
    print(f"phase kernel: empty launch {empty_ms} ms per call", flush=True)

    serve = serving_phase(args.seed, torch.device("cuda"),
                          launches=lambda: sk.fused_linear_scores.launches,
                          profile=True)
    print("phase serving: " + json.dumps(dict(serve, card=card)),
          flush=True)

    hrows = hist_phase(args.seed)
    for r in hrows:
        print("phase hist_kernel: " + json.dumps(dict(r, card=card)),
              flush=True)
    train = training_phase(args.seed)
    print("phase training: " + json.dumps(dict(train, card=card)),
          flush=True)

    main_row = rows[0]        # the serving path's shape and operand mode
    hmain = hrows[0]          # the capture shape, bf16 (training's mode)
    print(json.dumps({"kernels": [{
        "name": "fused_linear_scores", "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/fused_linear_scores.cu",
        "replaces": "transmogrifai_tpu/models/serving_kernels.py:224",
        "launches": serve["kernel_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], "dtype": main_row["dtype"],
        "call_ms": main_row["call_ms"],
        "plain_call_ms": main_row["plain_call_ms"],
        "library_call_ms": main_row["library_call_ms"],
        "launch_ms": empty_ms}, {
        "name": "tree_histogram", "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/tree_histogram.cu",
        "replaces": "transmogrifai_tpu/models/kernels.py:612 and "
                    "transmogrifai_tpu/models/kernels.py:649",
        "launches": train["histogram_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in hrows),
        "ms": hmain["ms"], "plain_ms": hmain["plain_ms"],
        "bound_ms": hmain["bound_ms"], "bound_by": hmain["bound_by"],
        "library_ms": hmain["library_ms"],
        "shape": [hmain[k] for k in ("G", "n", "d", "S", "m", "B")],
        "dtype": hmain["dtype"], "call_ms": hmain["call_ms"],
        "plain_call_ms": hmain["plain_call_ms"],
        "library_call_ms": hmain["library_call_ms"]}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
