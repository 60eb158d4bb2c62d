#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — fused multi-model LR serving — through
the entry points a user calls, and holds its CUDA kernel against the
plain PyTorch version:

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
   torch.profiler for the device's busy share.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when CUDA is unavailable or any phase fails.

Run from the repository root:  python3 chip_smoke.py [--seed N]
"""
from __future__ import annotations

import argparse
import json
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


def device_ms(fn, calls: int = 50):
    """(ms, device events) per call: the summed device time of every
    kernel and copy ``fn`` puts on the card, from torch.profiler's
    CUPTI trace over ``calls`` calls. Raises if the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
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
    torch.backends.cuda.matmul.allow_tf32 = False   # reference paths
    torch.backends.cudnn.allow_tf32 = False
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


def _device_busy(run):
    """Profile one call of ``run`` (torch.profiler): (summed device
    time of its kernels and copies in s, their count, its wall s)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    before = 0 if launches is None else launches()
    try:
        results, lat, wall = _storm(eng, reqs, THREADS, traces)
        moved = None if launches is None else launches() - before
    finally:
        eng.stop()
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

    main_row = rows[0]        # the serving path's shape and operand mode
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
        "launch_ms": empty_ms}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
