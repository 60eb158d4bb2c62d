#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths — fused multi-model LR serving, AutoML
training over the selector's default candidate lists (tree and linear
families), row-sharded tree growing over a data mesh and the workflow
front door (CSV reader, transmogrify, SanityChecker, selector,
save/load, scoring, export and serving) and the Criteo path (hashed
sparse families streamed, swept, served) — through the entry points a
user calls, and holds each CUDA kernel against its plain PyTorch
version:

1. device: the card's name and power limit (nvidia-smi), then every
   kernel under ``transmogrifai_tpu_torch/csrc`` built with nvcc for
   sm_90a, all builds started together;
2. kernel: the fused serving kernel against its plain version on the
   card, in f32 and bf16 operand modes: as ``fused_linear_scores``
   (the identity table) against ``fused_linear_scores_torch`` at the
   serving shapes (and the top bucket, a softmax head, a ragged n, an
   inf weight in a model no row selects), and in its prefix form
   ``fused_prefix_scores`` against ``fused_prefix_scores_torch`` at the
   serving pass's shape (NaNs, an out-of-range model id, an inf model,
   a softmax head), a group too large for shared memory, and with
   identity heads whose scores are the features, which must match bit
   for bit. Each is timed beside its bound, the plain version and, for
   the identity form, one PyTorch library call: ``ms`` is the device
   time per call (torch.profiler), ``call_ms`` the CUDA-event time per
   call with the host's issue gaps, ``launch_ms`` the call time of an
   empty kernel launched through the same C entry path;
3. serving: four all-numeric LR models (12 Real columns, impute with
   null tracking, concat, a seeded keep_cols subset, a binary
   LogisticRegression head) built from ``--seed`` in the portable IR,
   loaded through ``portable.from_portable``, served as a 100-id
   catalog (4 backends + 96 aliases) by a ``ServingEngine`` with the
   fused plane on, buckets (16, 64) and max_batch_rows 64, under 8
   client threads sending Zipf(1.1) model ids. Every request carries a
   trace id, so the engine's spans say which plane served it: a fused
   request must match its model's numpy score under the fused operand
   policy, a classic one under f32. The kernel must have launched once
   per bucket slice of the fused passes the spans show. The storm is
   repeated under torch.profiler for the device's busy share, and one
   fused pass of 60 rows over the 4 models is probed alone
   (``fused_pass_probe``): device operations, device and host time per
   pass, at most 3 device operations a bucket slice (one copy in, one
   launch, one copy out);
4. hist_kernel: ``tree_histogram`` against ``histogram_torch`` on the
   card at the shapes the training path gives it (the histogram capture
   shape, a GBT level, XGBoost's last level, an RF level, a ragged n
   with one node and one instance), in both operand modes: float stats
   to a stated tolerance, integer stats bitwise, two launches bitwise,
   one instance alone equal to its slice of the batch; timed beside its
   bound, the plain version and the one-hot GEMM ``torch.matmul``; the
   kernel's SASS (``cuobjdump -sass``) must hold tensor-core ``HMMA``
   instructions;
5. training: ``BinaryClassificationModelSelector`` with 3-fold CV over
   its default candidate list — DecisionTree/RandomForest/GBT/XGBoost
   and LinearSVC/LogisticRegression/NaiveBayes — at default grids and
   registered caps on 200k x 28 HIGGS-shaped rows from ``--seed``,
   through ``fit_transform``. The histogram launches must equal the
   tree levels the code grows, the serving kernel must not launch, the
   winner must be a tree family beating a linear score on the holdout
   by 0.1, the refit must hold no NaN; every family's wall is printed,
   and each linear family's sweep is profiled alone (device time and
   operations); the fit is repeated under torch.profiler (busy share,
   the kernel's share), and the card is held to the CPU (an exact-mode
   decision tree bitwise; exact-mode GBT trees parting only at near
   ties, and its AUROC per grid point within a tolerance);
   linear: the card's linear sweep against independent references —
   on one fold the L2 logistic and ridge coefficients against numpy f64
   solves (``ORACLE_RTOL``); every default grid point of LR, LinearSVC
   and NaiveBayes (binary) and of LR (multiclass, k = 3) on 8,000 rows
   on the card against the port's CPU path (``LINEAR_CPU_TOL``); an LR
   candidate alone and stacked with a second one, bitwise; and the
   binary linear families' dispatch at full width under
   ``torch.cuda.set_sync_debug_mode("error")``;
   other_lists: the multiclass (k = 3) and regression default lists at
   20k rows of the same features: winner, walls, histogram launches;
6. ring_kernel: ``ring_allreduce`` (all-gather and all-reduce) against
   ``ring_allgather_torch`` / ``ring_allreduce_torch`` on 2, 3 and 4
   ranks sharing one card (each rank its own stream), and over every
   visible card up to 4 as peers when there are two or more, at the
   histogram capture shape and a GBT level: every rank bitwise the
   plain version, 200 back-to-back calls with changing inputs right,
   each input overwritten on its rank's stream right after its call;
   timed beside its bound, the plain version and a library yardstick
   (one ``torch.sum`` over the stacked parts and ndev-1 copies):
   ``ms`` and ``library_ms`` are device times per call with every call
   queued before the card starts (``queued_ms``), ``span_ms`` the
   union of the ranks' kernels per call as the host issues them,
   ``after_last_start_ms`` the part of it after the last rank's kernel
   started, ``call_ms`` the CUDA-event time per call with the host's
   issue gaps;
7. data_parallel: ``trees.grow_tree_grid`` over a 4-rank data mesh on
   the training phase's 200k x 28 rows (50k a rank), GBT's folded first
   round (12 instances, depth 5, B = 32): every rank's trees bitwise
   the single-device grow's, the ring launched ranks x (levels + 1)
   times, ``parallel.sharded_histograms`` at the capture shape bitwise
   ``histogram_grid``; wall time and the device's busy share.

8. workflow: the front door. The Titanic helloworld
   (``examples/op_titanic_simple.py``'s schema and candidates, rebuilt
   from the port's classes) through ``WorkflowRunner`` TRAIN and SCORE
   on the card, the saved model loaded and scored again bitwise, the
   histogram launched once a tree level the selector grew, train AuROC
   > 0.75; then in exact mode on the card and on the CPU: the same kept
   slots, LR and GBT CV metrics within 1e-4, the same winner unless RF
   (whose draws differ by device) is within 0.02. A 200,000-row CSV
   from ``--seed`` (28 HIGGS-shaped Real columns, 5% missing; PickLists
   of 3, 8, 40 and 200 levels; 2 Integral, 1 Binary) read by
   ``DataReaders.csv``, transmogrified, checked and fit by the binary
   default list (3 folds) through ``Workflow.train``: the walls of the
   read, vectorizer fits, checker, selector, scoring (rows/s) and
   save/load; scores bitwise after save and load; ``LocalScorer`` on
   100 rows within 1e-5 of the batch; the checker's statistics against
   numpy f64 on the same matrix and its device ranks exact. Four Boston
   workflows (LinearRegression, seeded bootstraps) exported with
   ``export_portable``, loaded with ``portable.load`` and served by one
   ``ServingEngine``: every row within 1e-4 of its own WorkflowModel
   under its plane's operand policy, no fused fallback, the fused
   kernel launched once a bucket slice.
9. ctr: the Criteo path at Criteo's published widths (26 hashed
   categoricals, 13 numerics, 2^20 buckets, FM width 8; rows from a
   copy of ``bench.py::_ctr_chunk``). ``fit_sparse_lr_streaming`` over
   4 x 1M rows at batch 65,536 streamed from the host and device-fed
   (bitwise the same tables): rows/s, busy share, holdout AUROC; the
   first 3 minibatches of Adagrad-LR, FTRL and the FM against numpy
   f64 (``CTR_ORACLE_RTOL`` of max|w|); ``SparseModelSelector()`` at its
   defaults on 2M rows twice (losses, winner and refit bitwise; family
   and refit walls) and one streamed epoch under
   ``set_sync_debug_mode("error")``; the default grid on 20k rows at
   2^16 buckets on the card and the CPU (``CTR_CPU_TOL``, the same
   winner); ``examples/op_ctr_sparse.py``'s workflow on 200k records
   through ``WorkflowRunner`` TRAIN (cold, warm) and EVALUATE, save/load,
   ``score_stream``, ``LocalScorer`` (all bitwise) and
   ``SparseRecordInsightsLOCO`` against numpy; its export served by a
   ``ServingEngine`` (rows against a numpy mirror, every request on the
   classic plane). None of the three CUDA kernels may launch.

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
    row = {"form": "identity", "shape": [n, p, K, L], "dtype": dname,
           "inf_model": inf_model,
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


def prefix_inputs(rng, n, C, p, K, L, inf_model=False):
    """The prefix form's inputs on the card: boundary values with 5%
    NaN and column 0 all NaN, the last column the label's zero
    placeholder (which no table reads), tables of filled values and
    null indicators, weights, and model ids with row 0 out of range."""
    dev = torch.device("cuda")
    V = rng.normal(size=(n, C)).astype(np.float32)
    V[rng.random((n, C)) < 0.05] = np.nan
    V[:, 0] = np.nan
    V[:, C - 1] = 0.0
    src = rng.integers(0, C - 1, size=(K, p)).astype(np.int32)
    op = rng.integers(1, 3, size=(K, p)).astype(np.uint8)  # filled, null
    fill = rng.normal(0.0, 0.1, size=(K, p)).astype(np.float32)
    W = (0.5 * rng.normal(size=(K, p + 1, L))).astype(np.float32)
    mid = rng.integers(0, K - 1 if inf_model else K, size=n).astype(np.int32)
    mid[0] = K
    if inf_model:
        W[K - 1] = np.inf      # no row selects model K-1
    return [torch.from_numpy(a).to(dev)
            for a in (V, mid, src, op, fill, W)]


def prefix_case(sk, rng, n, C, p, K, L, act, dtype, inf_model=False,
                features=False):
    """The kernel's prefix form (``fused_prefix_scores``: each row's
    features through its model's tables, the head, the activation)
    against its plain version on the card, timed. ``features``: f32
    operands, every W[k] the identity (L = p) with a zero intercept, so
    each score is one feature and the kernel's features must equal the
    plain version's bit for bit (untimed). No single PyTorch call
    computes this function, so the row has no library time."""
    V, mid, src, op, fill, W = prefix_inputs(rng, n, C, p, K, L, inf_model)
    if features:
        W = torch.zeros((K, p + 1, p), device=V.device)
        W[:, :p, :] = torch.eye(p, device=V.device)
        mid = mid.clamp(0, K - 1).contiguous()
        L, act, dtype = p, "identity", torch.float32
    args = (V, mid, src, op, fill, W)
    got = sk.fused_prefix_scores(*args, act=act, dtype=dtype)
    torch.cuda.synchronize()
    ref = sk.fused_prefix_scores_torch(*args, act=act, dtype=dtype)
    got_np, ref_np = got.cpu().numpy(), ref.cpu().numpy()
    shape = [n, C, p, K, L]
    if not np.isfinite(got_np).all():
        raise AssertionError(f"non-finite prefix-form output at {shape}")
    err = float(np.max(np.abs(got_np - ref_np)))
    if not (np.abs(got_np - ref_np) <= KERNEL_RTOL * (1.0 + np.abs(ref_np))
            ).all():
        raise AssertionError(
            f"prefix form disagrees with its plain version at {shape} "
            f"{act} {dtype}: max abs err {err}")
    n_out = int(got.shape[1])
    dname = str(dtype).replace("torch.", "")
    row = {"form": "prefix", "shape": shape, "act": act, "dtype": dname,
           "inf_model": inf_model, "max_abs_err": err, "library_ms": None}
    if features:
        feats = sk.prefix_features_torch(V, mid, src, op, fill).cpu().numpy()
        if not (np.array_equal(got_np.view(np.uint32), feats.view(np.uint32))
                and np.array_equal(ref_np.view(np.uint32),
                                   feats.view(np.uint32))):
            raise AssertionError(f"the kernel's features at {shape} are not "
                                 f"bitwise the plain version's")
        return dict(row, features_bitwise=True)
    cost = sk.fused_prefix_cost(n, C, p, K, L, n_out)
    bytes_ms = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = cost["flops"] / F32_FLOPS_PER_S * 1e3
    row.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    kernel = lambda: sk.fused_prefix_scores(*args, act=act, dtype=dtype)  # noqa: E731
    plain = lambda: sk.fused_prefix_scores_torch(*args, act=act, dtype=dtype)  # noqa: E731
    for prefix, fn in (("", kernel), ("plain_", plain)):
        row[prefix + "ms"], row[prefix + "device_events"] = device_ms(fn)
        row[prefix + "call_ms"] = call_ms(fn)
    return row


def kernel_phase(seed: int):
    """The identity form (``fused_linear_scores``) at the serving and
    bulk shapes, then the prefix form: the serving pass's shape (64
    rows, the 13 boundary columns, 22 kept features, 4 models, a binary
    head), an inf model, a softmax head, a group too large for shared
    memory, and the bitwise feature check."""
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
    C = N_COLUMNS + 1           # the boundary: 12 columns and the label
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(prefix_case(sk, rng, MAX_BATCH_ROWS, C, P_KEEP,
                                N_BACKENDS, 1, "sigmoid_pair", dtype))
    rows.append(prefix_case(sk, rng, MAX_BATCH_ROWS, C, P_KEEP, N_BACKENDS,
                            1, "sigmoid_pair", torch.bfloat16,
                            inf_model=True))
    rows.append(prefix_case(sk, rng, MAX_BATCH_ROWS, C, P_KEEP, N_BACKENDS,
                            3, "softmax", torch.bfloat16))
    # W alone 512 x 65 x 3 f32 = 400 KB: past the 227 KB of shared memory
    rows.append(prefix_case(sk, rng, 4096, 70, 64, 512, 3, "softmax",
                            torch.bfloat16))
    for p in (P_KEEP, 64):
        rows.append(prefix_case(sk, rng, MAX_BATCH_ROWS, C, p, N_BACKENDS,
                                1, "identity", torch.float32,
                                features=True))
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


#: the fused-pass probe: passes timed and profiled, rows a pass (one
#: bucket slice of the top bucket), device operations a slice allowed
PROBE_PASSES = 50
PROBE_ROWS = 60
PROBE_MAX_OPS_PER_SLICE = 3


def fused_pass_probe(reg, seed: int, passes: int = PROBE_PASSES,
                     rows: int = PROBE_ROWS) -> dict:
    """One ``FusedGroupScorer`` pass — ``launch`` then ``finalize``, as
    the engine drives it — of ``rows`` rows over the catalog's
    N_BACKENDS members in ``reg`` (build_catalog), on the card: device
    operations (kernels and copies), device us and host us per pass.
    Host us is the median wall of one pass (it ends in the finalize's
    copy out, so the device is done); the device numbers come from
    torch.profiler over ``passes`` passes. Uses only the scorer's
    launch / finalize interface, so it measures any checkout's package
    (fused_pass_probe.py)."""
    from transmogrifai_tpu_torch.serving.fusion import (FusedGroupScorer,
                                                        stack_spec_of)
    members = []
    for k in range(N_BACKENDS):
        with reg.acquire(f"m{k:03d}") as (_vname, backend):
            members.append((backend, stack_spec_of(backend)))
    if any(spec is None for _b, spec in members):
        raise AssertionError("a catalog member has no stack spec")
    scorer = FusedGroupScorer(members)
    rng = np.random.default_rng(seed + 2)
    cols = {f"x{i}": np.where(rng.random(rows) < 0.05, np.nan,
                              rng.normal(size=rows))
            for i in range(N_COLUMNS)}
    n, vals = members[0][0].prepare(cols)
    mid = (np.arange(n) % N_BACKENDS).astype(np.int32)
    slices = len(list(scorer._slices(n)))

    def one():
        return scorer.finalize(scorer.launch(n, vals, mid))

    out = one()
    if out.shape != (n, 2) or not np.isfinite(out).all():
        raise AssertionError(f"fused pass gave {out.shape}, finite "
                             f"{bool(np.isfinite(out).all())}")
    for _ in range(5):
        one()
    host = []
    for _ in range(passes):
        t0 = time.perf_counter()
        one()
        host.append(time.perf_counter() - t0)
    prof, _ = profiled(lambda: [one() for _ in range(passes)], host=False)
    dev_us, events = _device_time_us(prof)
    return {"rows": n, "models": N_BACKENDS, "bucket_slices": slices,
            "passes": passes,
            "device_ops_per_pass": events / passes,
            "device_ops_per_slice": events / passes / slices,
            "device_us_per_pass": dev_us / passes,
            "host_us_per_pass": float(np.median(host)) * 1e6}


def serving_phase(seed: int, device, requests: int = REQUESTS,
                  launches=None, profile=False):
    """Serve ``requests`` requests of 1-8 rows from THREADS client
    threads (Zipf model ids over the catalog) through the fused engine
    and check every result against its model's numpy score under the
    operand policy of the plane that served it. ``launches`` is a
    zero-argument callable returning the kernel's launch count (read
    before and after the storm). ``profile`` (CUDA only) repeats the
    storm on a second engine under torch.profiler for the device's busy
    share, and runs the fused-pass probe, which must show at most
    PROBE_MAX_OPS_PER_SLICE device operations a bucket slice. Returns
    the phase's measurements; raises on any failure."""
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
    # one launch a bucket slice of every fused pass the engine ran
    fused_slices = sum(max(1, -(-s["attrs"]["rows"] // BUCKETS[-1]))
                       for s in fused_spans)
    if len(fused_spans) != stats["fused_batches"]:
        raise AssertionError(f"{len(fused_spans)} fused dispatch spans, "
                             f"{stats['fused_batches']} fused batches")
    if moved is not None and moved != fused_slices:
        raise AssertionError(f"the fused kernel launched {moved} times "
                             f"for {fused_slices} fused bucket slices")
    rows = sum(len(c["x0"]) for _, c in reqs)
    lat_ms = sorted(x * 1e3 for x in lat)
    fused_ms = sorted(s["dur"] * 1e3 for s in fused_spans)
    out = {"requests": requests, "rows": rows, "threads": THREADS,
           "wall_s": wall, "rows_per_s": rows / wall,
           "p50_ms": percentile_nearest_rank(lat_ms, 0.50),
           "p99_ms": percentile_nearest_rank(lat_ms, 0.99),
           "kernel_launches": moved, "fused_slices": fused_slices,
           "matched": matched,
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
        probe = fused_pass_probe(reg, seed)
        if probe["device_ops_per_slice"] > PROBE_MAX_OPS_PER_SLICE:
            raise AssertionError(
                f"a fused bucket slice took {probe['device_ops_per_slice']}"
                f" device operations (at most {PROBE_MAX_OPS_PER_SLICE}: "
                f"one copy in, one launch, one copy out)")
        out["fused_pass"] = probe
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
#: (the tensor cores' chain over each 128-row tile, then tiles and runs
#: in order), each cell within HIST_RTOL of the sum of its |terms|
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
           "kernel_mma_gflop": cost["mma_flop"] / 1e9,
           "plan": plan}
    arms = [("", lambda: tk.histogram_grid(bins, stats, pos, m, B)),
            ("plain_", lambda: tk.histogram_torch(bins, stats, pos, m, B)),
            ("library_", lambda: torch.matmul(A.T, Z))]
    for prefix, fn in arms:
        row[prefix + "ms"], row[prefix + "call_ms"] = _timed(fn)
    row["split_ms"] = kernel_split_ms(arms[0][1])
    return row


def sass_opcode_count(sass: str, opcode: str) -> int:
    """Instructions of ``opcode`` in ``cuobjdump -sass`` text. A line is
    "/*0150*/  @P0 HMMA.16816.F32.BF16 R4, R8, R12, R4 ;  /* 0x... */":
    the opcode is the first word after the address, or after a
    predicate."""
    count = 0
    for line in sass.splitlines():
        head, sep, rest = line.partition("*/")
        if sep and head.strip().startswith("/*"):
            count += any(w.startswith(opcode) for w in rest.split()[:2])
    return count


def sass_count(name: str, opcode: str) -> int:
    """Instructions of ``opcode`` in the SASS of kernel ``name``'s built
    library, read with the CUDA toolkit's ``cuobjdump -sass``."""
    from transmogrifai_tpu_torch import _cuda_build
    tool = os.path.join(os.path.dirname(_cuda_build.nvcc_path()),
                        "cuobjdump")
    sass = subprocess.run([tool, "-sass", _cuda_build.library_path(name)],
                          check=True, capture_output=True, text=True,
                          timeout=300).stdout
    return sass_opcode_count(sass, opcode)


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
#: the binary selector's default candidates (the JAX package's list):
#: the four tree families and the linear ones
LINEAR_FAMILIES = ["LinearSVC", "LogisticRegression", "NaiveBayes"]
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


def training_signal(seed: int, n: int = TRAIN_ROWS):
    """HIGGS-shaped synthetic rows: 28 Real features and a nonlinear
    (XOR-style) signal of a few of them plus noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, TRAIN_FEATURES)).astype(np.float32)
    z = (X[:, 0] * X[:, 1] + 0.5 * np.sin(2.0 * X[:, 2]) + 0.3 * X[:, 3]
         + 0.3 * rng.normal(size=n))
    return X, z


def training_data(seed: int, n: int = TRAIN_ROWS):
    """The binary label of :func:`training_signal`, balanced so the
    default DataBalancer keeps unit weights."""
    X, z = training_signal(seed, n)
    return X, (z > 0).astype(np.float32)


def problem_data(seed: int, n: int, problem: str):
    """The same rows for each problem: binary (the sign of the signal),
    multiclass (its terciles, k = 3) or regression (the signal)."""
    X, z = training_signal(seed, n)
    if problem == "binary":
        return X, (z > 0).astype(np.float32)
    if problem == "multiclass":
        return X, np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])
                              ).astype(np.float32)
    return X, z.astype(np.float32)


def _selector(X, y, candidates, device, problem="binary"):
    """A 3-fold CV selector of ``problem`` (``candidates`` None: the
    default list) and the dataset it fits."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    ds = Dataset({"y": y.astype(np.float64), "x": X},
                 {"y": ft.RealNN, "x": ft.OPVector})
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    factory = {"binary": TM.BinaryClassificationModelSelector,
               "multiclass": TM.MultiClassificationModelSelector,
               "regression": TM.RegressionModelSelector}[problem]
    sel = factory.with_cross_validation(
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
    """The selector's main path on ``device`` — the binary default
    candidate list, trees and linear families (launch count, winner,
    timings) — a profiled repeat and each linear family's sweep profiled
    alone (CUDA only), and the card-vs-CPU tree checks. ``rows`` and
    ``device`` exist for a CPU rehearsal at a small size. Returns the
    phase's measurements."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.models.base import params_to_numpy
    from transmogrifai_tpu_torch.models.tuning import DataSplitter
    X, y = training_data(seed, rows)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ds, sel = _selector(X, y, None, device)
    families = [name for name, _ in sel.params["candidates"]]
    if sorted(families) != sorted(TREE_FAMILIES + LINEAR_FAMILIES):
        raise AssertionError(f"binary default candidates {families}")
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
                + (TM.MODEL_FAMILIES[winner].levels_per_fit()
                   if winner in TREE_FAMILIES else 0))
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
           "families": families,
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
        out["linear_family_device"] = _linear_family_profile(
            X[tr_idx], y[tr_idx])
    out.update(_card_vs_cpu(X, y, device))
    return out


def _profiled_fit(X, y):
    """The same selector fit again under torch.profiler (device activity
    only): the device's busy share of the fit's wall and the histogram
    kernel's share of device time."""
    from torch.autograd import DeviceType
    ds, sel = _selector(X, y, None, "cuda")
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


def _linear_family_profile(X, y):
    """Each linear family of the binary default list validated alone
    (3-fold CV, its default grid, the selector's sweep) under
    torch.profiler: its wall, device time and device operations."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    from transmogrifai_tpu_torch.models.tuning import OpCrossValidation
    w = np.ones(len(y), np.float32)
    out = {}
    for name in LINEAR_FAMILIES:
        fam = MODEL_FAMILIES[name]
        cv = OpCrossValidation(n_folds=3, metric="auroc")

        def run():
            p = cv.dispatch_many([("0", fam, fam.make_grid())], X, y, w,
                                 2, "cuda")
            return cv.collect(p["0"])
        prof, wall = profiled(_walled(run), host=False)
        busy_us, events = _device_time_us(prof)
        out[name] = {"wall_s": wall, "device_s": busy_us / 1e6,
                     "device_ops": events,
                     "items": 3 * len(fam.make_grid())}
    return out


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
# phase 5b: the linear sweep held to independent references
# ---------------------------------------------------------------------------

#: rows of the card-vs-CPU and invariance checks (the CPU side runs the
#: sweep one item at a time)
LINEAR_PARITY_ROWS = 8_000
ORACLE_REG = 0.01
#: the card's coefficients against a numpy f64 solve, as max|diff| over
#: max|beta|: L2-only logistic (15 damped Newton steps in f32 against
#: Newton to convergence in f64) and ridge (one f32 Cholesky solve).
#: The f32 Gram over ~120k rows is good to ~1e-6 of its scale and the
#: designs are well conditioned (standard normal features), so 1e-4
#: leaves room for the solve; a dropped row or a wrong penalty moves
#: the coefficients by 1e-3 or more
ORACLE_RTOL = {"logistic": 1e-4, "ridge": 1e-4}
#: card vs CPU, per grid point: validation AUROC (binary) and log loss
#: (multiclass). Both sides run the same f32 program; only the order of
#: summation differs (cuBLAS against the CPU's GEMMs), which moves a
#: coefficient by ~1e-6 of its scale after Newton and carries through
#: the 200-300 first-order steps without growing (each step contracts)
LINEAR_CPU_TOL = {"binary": 1e-4, "multiclass": 1e-4}
#: rows of the multiclass and regression default lists
OTHER_ROWS = 20_000


def _np_logistic(Xb, y, w, l2, iters=50):
    """L2 logistic regression by undamped Newton in numpy f64 to
    convergence: the same objective as the port's (intercept unpenalized,
    the same 1e-5 ridge on the Hessian)."""
    d = Xb.shape[1]
    mask = np.ones(d)
    mask[-1] = 0.0
    sw = max(w.sum(), 1.0)
    beta = np.zeros(d)
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(Xb @ beta)))
        g = Xb.T @ (w * (p - y)) / sw + l2 * mask * beta
        H = (Xb.T @ (Xb * (w * p * (1 - p) / sw)[:, None])
             + np.diag(l2 * mask + 1e-5))
        beta = beta - np.linalg.solve(H, g)
    return beta


def _np_ridge(Xb, y, w, l2):
    """The port's ridge objective by its normal equations in numpy f64."""
    d = Xb.shape[1]
    mask = np.ones(d)
    mask[-1] = 0.0
    sw = max(w.sum(), 1.0)
    A = Xb.T @ (Xb * (w / sw)[:, None]) + np.diag(l2 * mask + 1e-5)
    return np.linalg.solve(A, Xb.T @ (w * y) / sw)


def _oracle(seed, rows, device):
    """On fold 0 of the selector's 3-fold split of the training rows:
    the family fits (the sweep's own fit functions) of L2-only logistic
    and ridge at regParam ORACLE_REG on ``device``, against numpy f64."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    from transmogrifai_tpu_torch.models.tuning import (DataSplitter,
                                                       make_fold_masks)
    X, z = training_signal(seed, rows)
    tr_idx, _ = DataSplitter().split(rows)
    train_m, _ = make_fold_masks(len(tr_idx), 3)
    rows_f = tr_idx[train_m[0] > 0]
    Xf = X[rows_f]
    targets = {"logistic": (z[rows_f] > 0).astype(np.float32),
               "ridge": z[rows_f].astype(np.float32)}
    Xb = np.concatenate([Xf, np.ones((len(Xf), 1), np.float32)],
                        1).astype(np.float64)
    w = np.ones(len(Xf))
    out = {"oracle_rows": len(Xf)}
    for kind, fam_name, k, ref in (
            ("logistic", "LogisticRegression", 2, _np_logistic),
            ("ridge", "LinearRegression", 1, _np_ridge)):
        yt = targets[kind]
        params = MODEL_FAMILIES[fam_name].fit_batch(
            torch.from_numpy(Xf).to(device)[None],
            torch.from_numpy(yt).to(device)[None],
            torch.ones((1, len(yt)), device=device),
            {"regParam": torch.full((1,), ORACLE_REG, device=device),
             "elasticNetParam": 0.0}, k)
        beta = params["beta"][0].double().cpu().numpy()
        want = ref(Xb, yt.astype(np.float64), w, ORACLE_REG)
        rel = float(np.abs(beta - want).max() / np.abs(want).max())
        out[f"oracle_{kind}_rel_err"] = rel
        if not rel <= ORACLE_RTOL[kind]:
            raise AssertionError(f"{kind} coefficients on {device} are "
                                 f"{rel} (relative) from numpy f64; limit "
                                 f"{ORACLE_RTOL[kind]}")
    return out


def _sweep_metrics(entries, X, y, k, metric, device, sync_error=False):
    """Validate ``entries`` (3-fold CV) on ``device``: {key: grid
    metrics}, and the dispatch's wall. With ``sync_error`` the dispatch
    runs under ``torch.cuda.set_sync_debug_mode("error")``: any call
    that would make the host wait on the card raises."""
    from transmogrifai_tpu_torch.models.tuning import OpCrossValidation
    cv = OpCrossValidation(n_folds=3, metric=metric)
    w = np.ones(len(y), np.float32)
    t0 = time.perf_counter()
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        pending = cv.dispatch_many(entries, X, y, w, k, device)
    finally:
        if sync_error:
            torch.cuda.set_sync_debug_mode("default")
    t1 = time.perf_counter()
    got = {key: cv.collect(p).grid_metrics for key, p in pending.items()}
    return got, t1 - t0, time.perf_counter() - t1


def linear_phase(seed: int, rows: int = TRAIN_ROWS,
                 parity_rows: int = LINEAR_PARITY_ROWS, device="cuda"):
    """The card's linear sweep held to independent references: the
    oracle coefficients; every default grid point of LR, LinearSVC and
    NaiveBayes (binary) and of LR (multiclass, k = 3) on the card
    against the port's CPU path; an LR candidate alone against the same
    candidate stacked with a second one, bitwise; and on the card the
    binary linear families' sweep at full width dispatched with no host
    synchronisation. ``device="cpu"`` rehearses it (CPU against CPU, no
    sync check)."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES as MF
    out = _oracle(seed, rows, device)

    gaps = {}
    for problem, names, k, metric in (
            ("binary", LINEAR_FAMILIES, 2, "auroc"),
            ("multiclass", ["LogisticRegression"], 3, "logloss")):
        X, y = problem_data(seed, parity_rows, problem)
        entries = [(n, MF[n], MF[n].make_grid()) for n in names]
        card, _, _ = _sweep_metrics(entries, X, y, k, metric, device)
        cpu, _, _ = _sweep_metrics(entries, X, y, k, metric, "cpu")
        for n in names:
            gap = float(np.max(np.abs(card[n] - cpu[n])))
            gaps[f"{problem}/{n}"] = gap
            if not gap <= LINEAR_CPU_TOL[problem]:
                raise AssertionError(
                    f"{problem} {n}: grid {metric} on {device} and on the "
                    f"CPU differ by {gap} > {LINEAR_CPU_TOL[problem]}: "
                    f"{card[n].tolist()} vs {cpu[n].tolist()}")
    out["card_vs_cpu_max_gap"] = gaps

    X, y = problem_data(seed, parity_rows, "binary")
    lr = MF["LogisticRegression"]
    one = ("one", lr, lr.make_grid())
    two = ("two", lr, lr.make_grid({"regParam": [0.05, 0.2],
                                    "elasticNetParam": [0.0, 0.5]}))
    alone, _, _ = _sweep_metrics([one], X, y, 2, "logloss", device)
    stacked, _, _ = _sweep_metrics([one, two], X, y, 2, "logloss", device)
    if not np.array_equal(alone["one"], stacked["one"]):
        raise AssertionError(f"LR candidate alone {alone['one'].tolist()} "
                             f"and stacked {stacked['one'].tolist()} "
                             f"differ on {device}")
    out["invariance_bitwise"] = True

    if device == "cuda":
        X, y = training_data(seed, rows)
        entries = [(n, MF[n], MF[n].make_grid()) for n in LINEAR_FAMILIES]
        got, dispatch_s, collect_s = _sweep_metrics(
            entries, X, y, 2, "auroc", device, sync_error=True)
        out.update({"no_sync_rows": rows, "no_sync_dispatch_s": dispatch_s,
                    "no_sync_collect_s": collect_s,
                    "no_sync_best_auroc": {n: float(np.max(m))
                                           for n, m in got.items()}})
    return out


def other_lists_phase(seed: int, rows: int = OTHER_ROWS, device="cuda"):
    """The multiclass (k = 3) and regression default candidate lists on
    ``device`` at ``rows`` rows: each selector's winner, its validation
    metric, every family's wall, the histogram launches against the tree
    levels grown (CUDA only) and a finite refit."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.models.base import params_to_numpy
    out = {}
    for problem in ("multiclass", "regression"):
        X, y = problem_data(seed, rows, problem)
        ds, sel = _selector(X, y, None, device, problem)
        families = [name for name, _ in sel.params["candidates"]]
        tk.histogram_grid.launches = 0
        t0 = time.perf_counter()
        model = sel.fit(ds)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        summ = model.summary
        winner = summ["bestModel"]["family"]
        trees = [f for f in families if hasattr(TM.MODEL_FAMILIES[f],
                                                "fit_eval_grid")]
        expected = (sum(TM.MODEL_FAMILIES[f].levels_per_fit() for f in trees)
                    + (TM.MODEL_FAMILIES[winner].levels_per_fit()
                       if winner in trees else 0))
        launches = tk.histogram_grid.launches
        if device == "cuda" and launches != expected:
            raise AssertionError(f"{problem}: {launches} histogram "
                                 f"launches, the code grows {expected}")
        for name, p in params_to_numpy(model.model_params).items():
            if p.dtype.kind == "f" and np.isnan(p).any():
                raise AssertionError(f"{problem}: NaN in refit {name}")
        if set(summ["wallSeconds"]["families"]) != set(families):
            raise AssertionError(f"{problem}: families validated "
                                 f"{sorted(summ['wallSeconds']['families'])}"
                                 f" of {families}")
        out[problem] = {
            "rows": rows, "families": families, "fit_wall_s": wall,
            "family_wall_s": summ["wallSeconds"]["families"],
            "refit_wall_s": summ["wallSeconds"]["refit"],
            "winner": winner, "winner_hyper": summ["bestModel"]["hyper"],
            "validation_metric": summ["bestModel"]["validationMetric"],
            "holdout": summ["holdoutEvaluation"],
            "histogram_launches": launches, "expected_launches": expected}
    return out


# ---------------------------------------------------------------------------
# phase 6: the ring kernel against its plain version
# ---------------------------------------------------------------------------

#: (label, shape) of the parts one rank contributes: the histogram
#: capture shape (G=16, m*S = 8*5, d*B = 28*32) and a GBT level (G=12,
#: m*S = 16*3), 2.29 and 2.06 MB a rank
RING_SHAPES = [("capture", (16, 8 * 5, 28 * 32)),
               ("gbt_level", (12, 16 * 3, 28 * 32))]
RING_RANKS = (2, 3, 4)
#: back-to-back calls with changing inputs and no host synchronisation
#: between them: the race probe of the epoch and the neighbour barrier
RING_REPEATS = 200


def ring_layouts(device):
    """(layout, devices) of the meshes the ring phase runs: ndev ranks
    sharing one card for each of RING_RANKS, then every visible card up
    to 4 as peers when there are two or more. On the CPU, CPU ranks."""
    if torch.device(device).type == "cpu":
        return [("cpu", ["cpu"] * k) for k in RING_RANKS]
    out = [("one card", [torch.device("cuda", 0)] * k) for k in RING_RANKS]
    count = torch.cuda.device_count()
    if count >= 2:
        out.append(("peers", [torch.device("cuda", i)
                              for i in range(min(count, 4))]))
    return out


def _sync(devices):
    for d in dict.fromkeys(torch.device(x) for x in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _ring_parts(devices, shape, seed):
    gens = [torch.Generator(device=d).manual_seed(seed + r)
            for r, d in enumerate(devices)]
    return [torch.randn(shape, generator=g, device=d)
            for g, d in zip(gens, devices)]


def queued_ms(fn, calls: int = 50, attempts: int = 6,
              devices=("cuda:0",)) -> float:
    """Device time per call of back-to-back calls that never wait on the
    host: the current stream of every card in ``devices`` is held by
    ``torch.cuda._sleep`` while the host issues all ``calls`` calls, and
    CUDA events on the first card time them from the end of its hold to
    the last call's end. (The ring's ranks are
    launched one after another; timed as issued, a rank launched first
    spins until the last arrives, and the host's issue rate shows as
    device time.) The hold is sized from the host's measured issue time
    and doubled until the host finishes inside it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(1_000_000)
    b.record()
    b.synchronize()
    cycles_per_s = 1_000_000 / (a.elapsed_time(b) / 1e3)
    hold_s = 2.0 * issue_s + 1e-3
    for _ in range(attempts):
        h0, h1, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
        h0.record()
        for d in dict.fromkeys(torch.device(x) for x in devices):
            with torch.cuda.device(d):
                torch.cuda._sleep(int(hold_s * cycles_per_s))
        h1.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        issued = time.perf_counter() - t0
        end.record()
        end.synchronize()
        if issued < 0.9 * h0.elapsed_time(h1) / 1e3:
            return h1.elapsed_time(end) / calls
        hold_s *= 2.0
    raise AssertionError(f"the host took {issued} s to issue {calls} calls, "
                         f"longer than the card was held")


def _kernel_span_ms(prof, pattern: str, calls: int) -> float:
    """Device time per call of concurrent kernels: the union of the
    intervals of every device kernel whose name holds ``pattern`` in a
    torch.profiler trace, over ``calls`` calls (ranks on one card
    overlap, so their summed times would count the overlap twice)."""
    from torch.autograd import DeviceType
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and pattern in ev.name)
    if not spans:
        raise AssertionError(f"no device kernel named *{pattern}* traced")
    total, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (total + hi - lo) / calls / 1e3


def _after_last_start_ms(prof, pattern: str) -> float:
    """Mean, over the calls in a torch.profiler trace, of the time from
    the start of a call's last kernel named *pattern* to the end of its
    kernels: what a call of concurrent rank kernels takes once every
    rank has arrived (a call is a run of overlapping kernels)."""
    from torch.autograd import DeviceType
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and pattern in ev.name)
    if not spans:
        raise AssertionError(f"no device kernel named *{pattern}* traced")
    calls, (last, hi) = [], spans[0]
    for a, b in spans[1:]:
        if a > hi:
            calls.append(hi - last)
            last, hi = a, b
        else:
            last, hi = a, max(hi, b)
    calls.append(hi - last)
    return float(np.mean(calls)) / 1e3


def ring_case(tk, par, layout, label, shape, devices, seed,
              repeats=RING_REPEATS, timed=True):
    """The kernel against its plain version on one mesh and shape:
    gather and reduce bitwise on every rank, RING_REPEATS back-to-back
    calls, then timings (CUDA only). Returns one result row; raises on
    any disagreement."""
    mesh = par.data_mesh(devices)
    ndev = mesh.size
    parts = _ring_parts(mesh.devices, shape, seed)
    gathered = tk.ring_allgather(parts, mesh)
    reduced = tk.ring_allreduce(parts, mesh)
    _sync(mesh.devices)
    home = mesh.devices[0]
    stacked = torch.stack([p.to(home) for p in parts])
    ref = tk.ring_allreduce_torch(parts)
    for r in range(ndev):
        if not torch.equal(gathered[r].to(home), stacked):
            raise AssertionError(f"ring all-gather rank {r} not the parts "
                                 f"in origin order ({layout}, {label})")
        if not (torch.equal(reduced[r], ref[r])
                and torch.equal(reduced[r].to(home), reduced[0])):
            raise AssertionError(f"ring all-reduce rank {r} differs from "
                                 f"the plain version ({layout}, {label})")
    # back to back, each input overwritten on its own rank stream right
    # after the call: a rank that read another's input after that
    # rank's kernel ended (an exit barrier at fault) would read NaN
    calls = [_ring_parts(mesh.devices, shape, seed + 1000 * (i + 1))
             for i in range(repeats)]
    wants = [tk.ring_allreduce_torch(ps) for ps in calls]
    outs = []
    for ps in calls:
        outs.append(tk.ring_allreduce(ps, mesh))
        for r, p in enumerate(ps):
            with mesh.rank(r):
                p.fill_(float("nan"))
    _sync(mesh.devices)
    for i, (want, out) in enumerate(zip(wants, outs)):
        if not all(torch.equal(o, w) for o, w in zip(out, want)):
            raise AssertionError(f"ring call {i} of {repeats} back to back "
                                 f"went wrong ({layout}, {label})")
    del calls, wants, outs
    numel = parts[0].numel()
    same_card = len(set(mesh.devices)) == 1
    cost = tk.ring_cost(ndev, numel, same_card=same_card)
    row = {"layout": layout, "shape": label, "dims": list(shape),
           "ndev": ndev, "devices": mesh.labels(), "numel": numel,
           "bitwise": True, "repeats": repeats, "max_abs_err": 0.0,
           "plan": tk.ring_plan(numel, ndev), "bound_ms": cost["bound_ms"],
           "bound_by": cost["bound_by"], "moved_bytes": cost["moved_bytes"]}
    if not timed:
        return row
    X = stacked
    lib_out = [torch.empty_like(parts[0]) for _ in range(ndev - 1)]

    def kernel():
        mesh.join(*tk.ring_allreduce(parts, mesh))

    def plain():
        tk.allreduce_data(parts, mesh, use_ring=False)

    def library():
        # yardstick only: one sum over the stacked parts, ndev-1 copies
        # (across cards: torch.cuda.comm.reduce_add + broadcast)
        if same_card:
            total = X.sum(0)
            for o in lib_out:
                o.copy_(total)
        else:
            total = torch.cuda.comm.reduce_add(parts, destination=home)
            torch.cuda.comm.broadcast(total, devices=mesh.devices)

    n_calls = 50
    row["ms"] = queued_ms(kernel, n_calls, devices=mesh.devices)
    prof, _ = profiled(lambda: [kernel() for _ in range(n_calls)],
                       host=False)
    row["span_ms"] = _kernel_span_ms(prof, "ring_kernel", n_calls)
    row["after_last_start_ms"] = _after_last_start_ms(prof, "ring_kernel")
    row["call_ms"] = call_ms(kernel)
    row["plain_ms"], _ = device_ms(plain)
    row["plain_call_ms"] = call_ms(plain)
    # the yardstick on the kernel's clock (queued), and on the
    # profiler's (its kernels' summed device time)
    row["library_ms"] = queued_ms(library, n_calls, devices=mesh.devices)
    row["library_device_ms"], _ = device_ms(library)
    row["library_call_ms"] = call_ms(library)
    return row


def ring_phase(seed: int, device="cuda", repeats=RING_REPEATS,
               shapes=RING_SHAPES):
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.models import kernels as tk
    rows = []
    for layout, devices in ring_layouts(device):
        for i, (label, shape) in enumerate(shapes):
            rows.append(ring_case(tk, par, layout, label, shape, devices,
                                  seed + 17 * i, repeats,
                                  timed=torch.device(device).type == "cuda"))
    return rows


# ---------------------------------------------------------------------------
# phase 7: row-sharded tree growing over a data mesh
# ---------------------------------------------------------------------------

DP_RANKS = 4
DP_BINS = 32
DP_FOLDS = 3
#: the capture shape of sharded_histograms (G, S, m): integer stats
DP_HIST = (16, 5, 8)


def _gbt_first_round(X, y, seed, device):
    """The GBT family's folded batch (3 folds x its default grid = 12
    instances) at its first round: g = 0.5 - y, h = 0.25 under the
    fold-mask weights, dyadic, so every order of summation is exact.
    Returns (bins, edges, gw, hw, w, replicated hypers, max_depth)."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.models import trees
    from transmogrifai_tpu_torch.models.tuning import (
        build_fold_grid_batch, make_fold_masks)
    fam = TM.MODEL_FAMILIES["GBTClassifier"]
    n = len(y)
    grid = fam.make_grid(None)
    train_m, val_m = make_fold_masks(n, DP_FOLDS, seed)
    train_b, _val_b, hyper_b = build_fold_grid_batch(grid, train_m, val_m)
    Xt = torch.from_numpy(X).to(device)
    yt = torch.from_numpy(y).to(device)
    bins, edges = trees._prep(Xt, DP_BINS, torch.ones(n, device=device))
    w = torch.from_numpy(train_b).to(device)
    gw = ((0.5 - yt)[None, :, None] * w[..., None]).contiguous()
    hw = (0.25 * w[..., None]).contiguous()
    Gb, d = w.shape[0], X.shape[1]

    def hyper(k, default):
        return torch.as_tensor(hyper_b.get(k, np.full(Gb, default)),
                               dtype=torch.float32).to(device)
    rep = (edges, torch.ones((Gb, d), device=device),
           hyper("regLambda", fam.default_hyper["regLambda"]),
           hyper("minSplitGain", 0.0),
           hyper("minChildWeight", fam.default_hyper["minChildWeight"]),
           hyper("maxDepth", fam.max_depth_cap))
    return bins, edges, gw, hw, w, rep, fam.max_depth_cap


def data_parallel_phase(seed: int, rows: int = TRAIN_ROWS, device="cuda"):
    """``trees.grow_tree_grid`` over a DP_RANKS-rank data mesh (ranks
    sharing one card; CPU ranks for a rehearsal) at full width: the
    training phase's rows, GBT's folded first round. Its trees bitwise
    those of the single-device grow on every rank; the ring launches
    those the code derives; ``sharded_histograms`` at the capture shape
    bitwise ``histogram_grid``; wall time and (CUDA) busy share."""
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.models import trees
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    X, y = training_data(seed, rows)
    bins, edges, gw, hw, w, rep, depth = _gbt_first_round(X, y, seed, dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    single = trees.grow_tree_grid(bins, gw, hw, w, *rep, max_depth=depth)
    sync()
    single_wall = time.perf_counter() - t0
    mesh = par.data_mesh([dev] * DP_RANKS)
    shards = [par.shard_rows(bins, mesh)] + [
        par.shard_rows(t, mesh, axis=1) for t in (gw, hw, w)]

    def grow():
        return trees.grow_tree_grid(*shards, *rep, max_depth=depth,
                                    mesh=mesh)
    sync()
    tk.ring_allreduce.launches = 0
    tk.histogram_grid.launches = 0
    out = grow()
    sync()
    ring_launches = tk.ring_allreduce.launches
    hist_launches = tk.histogram_grid.launches
    expected = DP_RANKS * (depth + 1) if cuda else 0
    if ring_launches != expected:
        raise AssertionError(f"{ring_launches} ring launches, the code "
                             f"derives {expected} ({DP_RANKS} ranks x "
                             f"({depth} levels + 1 leaf reduction))")
    if cuda and hist_launches != DP_RANKS * depth:
        raise AssertionError(f"{hist_launches} histogram launches, "
                             f"expected {DP_RANKS * depth}")
    names = ("feat", "thr", "leaf", "gains")
    for r, res in enumerate(out):
        for name, a, b in zip(names, single, res):
            if not torch.equal(a, b):
                raise AssertionError(f"rank {r} {name} differs from the "
                                     f"single-device grow")
    t0 = time.perf_counter()
    grow()
    sync()
    wall = time.perf_counter() - t0
    # sharded_histograms at the capture shape, integer stats: bitwise
    G, S, m = DP_HIST
    rng = np.random.default_rng(seed)
    hb = bins.cpu().numpy()
    hs = rng.integers(-3, 4, (G, rows, S)).astype(np.float32)
    hp = rng.integers(0, m, (G, rows)).astype(np.int32)
    got = par.sharded_histograms(hb, hs, hp, m, DP_BINS, mesh=mesh)
    whole = tk.histogram_grid(bins, torch.from_numpy(hs).to(dev),
                              torch.from_numpy(hp).to(dev), m, DP_BINS)
    if not np.array_equal(got, whole.cpu().numpy()):
        raise AssertionError("sharded_histograms differs from the "
                             "single-device histogram_grid")
    out_row = {"rows": rows, "ranks": DP_RANKS, "devices": mesh.labels(),
               "Gb": int(w.shape[0]), "max_depth": depth, "B": DP_BINS,
               "trees_bitwise": True, "ring_launches": ring_launches,
               "expected_ring_launches": expected,
               "histogram_launches": hist_launches,
               "sharded_histograms_bitwise": True,
               "wall_s": wall, "single_device_wall_s": single_wall}
    if cuda:
        prof, pwall = profiled(_walled(grow), host=False)
        busy_ms = _kernel_span_ms(prof, "", 1)
        out_row.update({"profiled_wall_s": pwall,
                        "device_busy_s": busy_ms / 1e3,
                        "device_busy_share": busy_ms / 1e3 / pwall,
                        "ring_device_s": _kernel_span_ms(
                            prof, "ring_kernel", 1) / 1e3})
    return out_row


# ---------------------------------------------------------------------------
# phase 8: the workflow front door
# ---------------------------------------------------------------------------

TITANIC_SCHEMA = {"id": "ID", "pclass": "PickList", "sex": "PickList",
                  "age": "Real", "sibSp": "Integral", "parCh": "Integral",
                  "fare": "Real", "cabin": "PickList", "embarked": "PickList",
                  "survived": "RealNN"}
#: examples/op_titanic_simple.py's candidates
TITANIC_CANDIDATES = [
    ["LogisticRegression", {"regParam": [0.001, 0.01, 0.1],
                            "elasticNetParam": [0.0, 0.5]}],
    ["RandomForestClassifier", None],
    ["GBTClassifier", None]]
#: card vs CPU on Titanic, exact mode: LR and GBT CV metrics; RF's draws
#: come from a torch.Generator on each device, so RF may part, and the
#: winners may differ only when RF is within TITANIC_RF_MARGIN of it.
#: A GBT grid point past TITANIC_CV_ATOL is held to the training phase's
#: GBT contract instead: on the checker's Titanic matrix the card's and
#: the CPU's trees may part only at a near tie (GBT_GAP_RTOL,
#: GBT_HIST_RTOL), the AUROC per grid point within GBT_PARITY_TOL, and
#: the recomputed metrics must be the workflow's own (ROADMAP queue 3)
TITANIC_CV_ATOL = 1e-4
TITANIC_RF_MARGIN = 0.02
#: the at-scale CSV: the training phase's 28 HIGGS-shaped Real columns
#: (5% missing), PickLists of these level counts, 2 Integral columns and
#: 1 Binary column
SCALE_ROWS = 200_000
SCALE_LEVELS = (3, 8, 40, 200)
SCALE_MISSING = 0.05
LOCAL_ROWS = 100
LOCAL_ATOL = 1e-5
#: the checker's statistics on the card against numpy f64 on the same
#: matrix: the mean to a relative error of the column's scale (its
#: larger of |mean| and std: a near-zero mean's own relative error
#: measures nothing), the variance to a relative error (f32 sums; it is
#: E[x^2] - mean^2 in f32), correlations to an absolute one
CHECKER_MOMENT_RTOL = 1e-4
CHECKER_CORR_ATOL = 1e-4
#: export and serve: four Boston workflows on seeded bootstraps
BOSTON_SCHEMA = {"crim": "Real", "zn": "Real", "indus": "Real",
                 "chas": "Binary", "nox": "Real", "rm": "Real",
                 "age": "Real", "dis": "Real", "rad": "Integral",
                 "tax": "Real", "ptratio": "Real", "lstat": "Real",
                 "medv": "RealNN"}
EXPORT_MODELS = 4
EXPORT_REQUESTS = 96


def _repo_file(*parts) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), *parts)


def _types(schema):
    from transmogrifai_tpu_torch.features import types as ft
    return {k: getattr(ft, v) for k, v in schema.items()}


def _titanic_workflow():
    """examples/op_titanic_simple.py's workflow from the port's classes:
    typed columns, transmogrify, SanityChecker, the binary selector with
    3-fold CV over its candidates."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.features import FeatureBuilder, reset_uids
    from transmogrifai_tpu_torch.ops import SanityChecker, transmogrify
    from transmogrifai_tpu_torch.workflow import Workflow
    reset_uids()
    types = _types(TITANIC_SCHEMA)
    survived = FeatureBuilder.of(types["survived"], "survived") \
        .from_column().as_response()
    preds = [FeatureBuilder.of(t, n).from_column().as_predictor()
             for n, t in types.items() if n not in ("id", "survived")]
    checked = SanityChecker().set_input(survived,
                                        transmogrify(preds)).output
    pred = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=3, candidates=TITANIC_CANDIDATES).set_input(
            survived, checked).output
    return Workflow([pred])


def _probs(model, ds):
    col = ds.column(model.result_features[0].name)
    key = "probability_1" if "probability_1" in col[0] else "prediction"
    return np.asarray([r[key] for r in col], np.float64)


def _checker_of(model):
    return next(st for st in model.stages
                if st.operation_name == "sanityChecked")


def _expected_levels(summary, families):
    """Histogram launches of one selector fit: every tree family's
    folded grid, then the refit when a tree family wins."""
    from transmogrifai_tpu_torch import models as TM
    tree = [f for f in families
            if hasattr(TM.MODEL_FAMILIES[f], "levels_per_fit")]
    winner = summary["bestModel"]["family"]
    return (sum(TM.MODEL_FAMILIES[f].levels_per_fit() for f in tree)
            + (TM.MODEL_FAMILIES[winner].levels_per_fit()
               if winner in tree else 0))


def _grid_metrics(summary):
    return {r["family"]: list(r["gridMetrics"])
            for r in summary["validationResults"]}


def titanic_part(device, workdir, check=None):
    """The Titanic helloworld through the runner on ``device``: TRAIN
    (model, metrics, insights), SCORE, then the saved model loaded and
    scored again (bitwise); its histogram launches against the levels
    the selector grew; then the same workflow in exact mode on
    ``device`` and on the CPU, held to each other by
    :func:`titanic_compare` (``check``: a test's planted fault)."""
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.runner import (OpParams, RunType,
                                                WorkflowRunner)
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    reader = DataReaders.csv(_repo_file("examples", "data", "titanic.csv"),
                             _types(TITANIC_SCHEMA), key="id")
    runner = WorkflowRunner(_titanic_workflow(), train_reader=reader,
                            score_reader=reader,
                            evaluator=Evaluators.binary_classification(),
                            device=device)
    params = OpParams(model_location=os.path.join(workdir, "model"),
                      metrics_location=os.path.join(workdir, "metrics"),
                      score_location=os.path.join(workdir, "scores"))
    sync()
    tk.histogram_grid.launches = 0
    t0 = time.perf_counter()
    res = runner.run(RunType.TRAIN, params)
    sync()
    train_wall = time.perf_counter() - t0
    launches = tk.histogram_grid.launches
    model = runner._model
    summ = model.selected_model().summary
    families = [c[0] for c in TITANIC_CANDIDATES]
    expected = _expected_levels(summ, families) if cuda else 0
    if launches != expected:
        raise AssertionError(f"Titanic: {launches} histogram launches, the "
                             f"selector grew {expected} tree levels")
    auroc = res["trainMetrics"]["AuROC"]
    if not auroc > 0.75:
        raise AssertionError(f"Titanic train AuROC {auroc} <= 0.75")
    for f in ("model_insights.json", "train_result.json"):
        if not os.path.exists(os.path.join(workdir, "metrics", f)):
            raise AssertionError(f"Titanic TRAIN wrote no {f}")
    t0 = time.perf_counter()
    score = runner.run(RunType.SCORE, params)
    score_wall = time.perf_counter() - t0
    if score["nRows"] != 891 or not os.path.exists(score["scoreLocation"]):
        raise AssertionError(f"Titanic SCORE gave {score}")
    trained = _probs(model, model.score(reader))
    t0 = time.perf_counter()
    loaded = WorkflowModel.load(params.model_location, device=device)
    load_wall = time.perf_counter() - t0
    if loaded.selected_model().device.type != torch.device(device).type:
        raise AssertionError("the loaded model's tensors left the device")
    if not np.array_equal(_probs(loaded, loaded.score(reader)), trained):
        raise AssertionError("Titanic: the loaded model scores differently "
                             "from the trained one")

    # the same workflow in exact mode on the device and on the CPU
    with env(TM_KERNEL_EXACT="1"):
        card = _titanic_workflow().train(reader, device=device)
        cpu = _titanic_workflow().train(reader, device="cpu")
    parity = titanic_compare(card, cpu, reader, device, check)
    return {"rows": 891, "train_wall_s": train_wall,
            "score_wall_s": score_wall, "load_wall_s": load_wall,
            "train_auroc": auroc, "winner": res["bestModel"],
            "histogram_launches": launches, "expected_launches": expected,
            "grid_metrics": _grid_metrics(summ),
            "loaded_scores_bitwise": True, **parity}


def titanic_compare(card, cpu, reader, device, check=None):
    """The Titanic workflow fitted in exact mode on ``device`` (``card``)
    against its CPU fit: the same kept slots and removal reasons, LR's
    CV metrics within TITANIC_CV_ATOL, GBT's too or else the near-tie
    analysis (:func:`_titanic_gbt_ties`), the same winner unless RF is
    within TITANIC_RF_MARGIN of it. ``check`` (a test's planted fault)
    may rewrite a copy of the card's summary first."""
    import copy
    cs, ps = (copy.deepcopy(m.selected_model().summary)
              for m in (card, cpu))
    if check is not None:
        check(cs)
    kept_card = _checker_of(card).params["keep_indices"]
    kept_cpu = _checker_of(cpu).params["keep_indices"]
    if kept_card != kept_cpu or (_checker_of(card).summary["dropped"]
                                 != _checker_of(cpu).summary["dropped"]):
        raise AssertionError(f"Titanic kept slots differ card {kept_card} "
                             f"vs CPU {kept_cpu}")
    gm_card, gm_cpu = _grid_metrics(cs), _grid_metrics(ps)
    gaps = {f: float(np.abs(np.subtract(gm_card[f], gm_cpu[f])).max())
            for f in gm_card}
    if not gaps["LogisticRegression"] <= TITANIC_CV_ATOL:
        raise AssertionError(f"Titanic LogisticRegression CV metrics card "
                             f"vs CPU differ by {gaps['LogisticRegression']}")
    gbt = None
    if not gaps["GBTClassifier"] <= TITANIC_CV_ATOL:
        gbt = _titanic_gbt_ties(card, reader, device, gm_card, gm_cpu)
    w_card, w_cpu = cs["bestModel"], ps["bestModel"]
    if (w_card["family"], w_card["hyper"]) != (w_cpu["family"],
                                               w_cpu["hyper"]):
        best = {k: (max(v) if k != "RandomForestClassifier" else None)
                for k, v in gm_cpu.items()}
        top = max(b for b in best.values() if b is not None)
        rf = max(gm_card["RandomForestClassifier"])
        if "RandomForestClassifier" not in (w_card["family"],
                                            w_cpu["family"]) \
                or not abs(rf - top) <= TITANIC_RF_MARGIN:
            raise AssertionError(f"Titanic winner card {w_card} vs CPU "
                                 f"{w_cpu}")
    return {"kept_slots": len(kept_card),
            "exact_card_vs_cpu_cv_gap": gaps, "exact_gbt_divergence": gbt,
            "exact_winner_card": w_card, "exact_winner_cpu": w_cpu}


def _titanic_gbt_ties(model, reader, device, gm_card, gm_cpu):
    """GBT on the checker's Titanic matrix in exact mode, on the card
    and on the CPU, each grid point refit with its histograms recorded:
    the validation metrics must be the workflow's own on each side, the
    trees may part only at a near tie and the AUROC per grid point
    within GBT_PARITY_TOL. Returns the comparison."""
    checker = _checker_of(model)
    full = model.transform(reader)
    X = np.ascontiguousarray(full.column(checker.output.name), np.float32)
    y = full.column("survived").astype(np.float32)
    knobs = {"TM_KERNEL_EXACT": "1"}
    card, cpu = gbt_side(X, y, device, knobs), gbt_side(X, y, "cpu", knobs)
    for side, got, want in (("card", card, gm_card), ("cpu", cpu, gm_cpu)):
        if list(got["metrics"]) != list(want["GBTClassifier"]):
            raise AssertionError(f"Titanic GBT metrics recomputed on the "
                                 f"{side} differ from the workflow's")
    gbt = gbt_compare(card, cpu, X)
    if not (gbt["gain_gap_max"] <= GBT_GAP_RTOL
            and gbt["hist_diff_max"] <= GBT_HIST_RTOL
            and gbt["metric_max_diff"] <= GBT_PARITY_TOL):
        raise AssertionError(
            f"Titanic GBT card vs CPU parts at a split that is no near "
            f"tie or past {GBT_PARITY_TOL}: gain gap "
            f"{gbt['gain_gap_max']}, histograms {gbt['hist_diff_max']}, "
            f"AUROC {gbt['metric_max_diff']}: {gbt['divergence']}")
    return {k: gbt[k] for k in ("metric_max_diff", "gain_gap_max",
                                "hist_diff_max", "divergence")}


def scale_csv(path, seed: int, rows: int):
    """Write the at-scale CSV: the training phase's HIGGS-shaped Real
    columns x0..x27 (SCALE_MISSING of them empty), PickLists p0..p3 of
    SCALE_LEVELS levels, Integral k0, k1, Binary b, the label y (the
    signal's sign, shifted by p0 and b). Returns the schema."""
    X, z = training_signal(seed, rows)
    rng = np.random.default_rng(seed + 11)
    cols = {}
    for j in range(TRAIN_FEATURES):
        v = np.char.mod("%.7g", X[:, j])
        v[rng.random(rows) < SCALE_MISSING] = ""
        cols[f"x{j}"] = v
    for j, levels in enumerate(SCALE_LEVELS):
        idx = np.minimum(rng.zipf(1.3, rows) - 1, levels - 1)
        cols[f"p{j}"] = np.char.add(f"l{j}_", idx.astype(str))
        if j == 0:
            z = z + 0.4 * (idx == 0)
    for j in range(2):
        k = rng.integers(0, 60, rows)
        v = k.astype(str)
        v[rng.random(rows) < SCALE_MISSING] = ""
        cols[f"k{j}"] = v
    b = rng.random(rows) < 0.3
    z = z - 0.3 * b
    bv = np.where(b, "true", "false")
    bv[rng.random(rows) < SCALE_MISSING] = ""
    cols["b"] = bv
    cols["y"] = (z > 0).astype(np.int64).astype(str)
    names = list(cols)
    table = np.stack([cols[n] for n in names], axis=1)
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        f.write("\n".join(",".join(r) for r in table.tolist()))
        f.write("\n")
    schema = {f"x{j}": "Real" for j in range(TRAIN_FEATURES)}
    schema.update({f"p{j}": "PickList" for j in range(len(SCALE_LEVELS))})
    schema.update({"k0": "Integral", "k1": "Integral", "b": "Binary",
                   "y": "RealNN"})
    return schema


def _avg_ranks_f64(x):
    """numpy f64 average ranks of each column (ties share the mean of
    their ordinal ranks, from 0): the oracle of the device ranks."""
    out = np.empty(x.shape, np.float64)
    for j in range(x.shape[1]):
        _, inv, counts = np.unique(x[:, j], return_inverse=True,
                                   return_counts=True)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        out[:, j] = (start + (counts - 1) / 2.0)[inv.ravel()]
    return out


def checker_oracle(X, y, stats, device):
    """The checker's statistics (its summary) against numpy f64 on the
    same (n, d) matrix and label, and the device ranks of ``X`` against
    the f64 average ranks, exactly. Returns the errors; raises past
    CHECKER_MOMENT_RTOL / CHECKER_CORR_ATOL or on any rank."""
    from transmogrifai_tpu_torch.ops import sanity_checker as sc
    Xd = X.astype(np.float64)
    yd = y.astype(np.float64)
    mean = Xd.mean(0)
    var = Xd.var(0)
    std = np.sqrt(var)
    ok = std > 0
    xs = (Xd - mean) / np.where(ok, std, 1.0)
    ys = (yd - yd.mean()) / yd.std()
    corr = np.where(ok, xs.T @ ys / len(yd), np.nan)
    rx = _avg_ranks_f64(Xd)
    ry = _avg_ranks_f64(yd[:, None])[:, 0]
    rxm, rym = rx - rx.mean(0), ry - ry.mean()
    # the checker's definition: rank spreads floored at 1e-12, so a
    # constant column's Spearman is 0
    spear = (rxm.T @ rym) / (len(yd)
                             * np.sqrt(np.maximum((rxm ** 2).mean(0), 1e-12))
                             * np.sqrt(max((rym ** 2).mean(), 1e-12)))
    got_ranks = sc.rank_columns(torch.from_numpy(X).to(device)).cpu().numpy()
    if not np.array_equal(got_ranks.astype(np.float64), rx):
        raise AssertionError("the device ranks differ from the f64 "
                             "average ranks")

    def rel(a, b, scale=None):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.abs(b) if scale is None else np.maximum(np.abs(b), scale)
        return float((np.abs(a - b) / np.maximum(scale, 1e-12)).max())

    def absd(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        both = np.isfinite(a) & np.isfinite(b)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError("NaN correlations differ from the oracle")
        return float(np.abs(a - b)[both].max())

    errs = {"mean_rel": rel(stats["mean"], mean, std),
            "variance_rel": rel(stats["variance"], var),
            "corr_label_abs": absd(stats["corr_label"], corr),
            "spearman_abs": absd(stats["spearman"], spear)}
    for k, v in errs.items():
        lim = CHECKER_MOMENT_RTOL if k.endswith("rel") else CHECKER_CORR_ATOL
        if not v <= lim:
            raise AssertionError(f"checker {k} error {v} against numpy f64 "
                                 f"(limit {lim})")
    errs["ranks_exact"] = True
    return errs


def scale_part(seed: int, device, workdir, rows: int = SCALE_ROWS):
    """The at-scale CSV through the front door on ``device``: read by
    ``DataReaders.csv``, transmogrify, SanityChecker and the binary
    default candidate list (3 folds) through ``Workflow.train``; the
    training CSV scored, saved, loaded and scored again (bitwise);
    LocalScorer on LOCAL_ROWS rows against the batch scores; the
    checker's statistics against numpy f64. Walls of each step."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.features import FeatureBuilder, reset_uids
    from transmogrifai_tpu_torch.local import LocalScorer
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.ops import SanityChecker, transmogrify
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.workflow import Workflow, WorkflowModel
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    path = os.path.join(workdir, "scale.csv")
    t0 = time.perf_counter()
    schema = scale_csv(path, seed, rows)
    write_wall = time.perf_counter() - t0
    types = _types(schema)
    reset_uids()
    label = FeatureBuilder.of(types["y"], "y").from_column().as_response()
    preds = [FeatureBuilder.of(t, n).from_column().as_predictor()
             for n, t in types.items() if n != "y"]
    checked = SanityChecker().set_input(label, transmogrify(preds)).output
    selector = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=3)
    pred = selector.set_input(label, checked).output
    wf = Workflow([pred])
    reader = DataReaders.csv(path, types)
    t0 = time.perf_counter()
    ds = reader.generate_dataset([label] + preds)
    read_wall = time.perf_counter() - t0
    if ds.n_rows != rows:
        raise AssertionError(f"read {ds.n_rows} rows of {rows}")
    sync()
    tk.histogram_grid.launches = 0
    t0 = time.perf_counter()
    model = wf.train(ds, device=device)
    sync()
    train_wall = time.perf_counter() - t0
    launches = tk.histogram_grid.launches
    summ = model.selected_model().summary
    families = [c[0] for c in selector.params["candidates"]]
    expected = _expected_levels(summ, families) if cuda else 0
    if launches != expected:
        raise AssertionError(f"at scale: {launches} histogram launches, "
                             f"the selector grew {expected} tree levels")
    if model.selected_model().device.type != torch.device(device).type:
        raise AssertionError("the fitted model is not on the train device")
    timings = model.train_summaries["stageTimings"]
    fit_s = {}
    for st in timings["stages"]:
        kind = ("vectorizers" if st["layer"] == 0 else
                {"SanityCheckerModel": "checker",
                 "SelectedModel": "selector"}.get(st["operation"]))
        if kind:
            fit_s[kind] = fit_s.get(kind, 0.0) + st["fit_s"]
    t0 = time.perf_counter()
    scored = model.score(ds)
    sync()
    score_wall = time.perf_counter() - t0
    first = _probs(model, scored)
    if not (np.isfinite(first).all() and (first >= 0).all()
            and (first <= 1).all()):
        raise AssertionError("at-scale scores malformed")
    t0 = time.perf_counter()
    model.save(os.path.join(workdir, "scale_model"))
    loaded = WorkflowModel.load(os.path.join(workdir, "scale_model"),
                                device=device)
    save_load_wall = time.perf_counter() - t0
    again = _probs(loaded, loaded.score(ds))
    if not np.array_equal(again, first):
        raise AssertionError("at scale: the loaded model's scores differ "
                             "from the trained one's")
    recs = ds.head(LOCAL_ROWS).rows()
    local = LocalScorer(loaded, device=device)
    name = loaded.result_features[0].name
    lp = np.asarray([local({k: v for k, v in r.items() if k != "y"})
                     [name]["probability_1"] for r in recs])
    local_err = float(np.abs(lp - first[:LOCAL_ROWS]).max())
    if not local_err <= LOCAL_ATOL:
        raise AssertionError(f"LocalScorer differs from the batch scores "
                             f"by {local_err}")
    checker = _checker_of(model)
    full = model.transform(ds)
    X = full.column(checker.input_names[1]).astype(np.float32)
    y = full.column("y").astype(np.float32)
    oracle = checker_oracle(X, y, checker.summary["stats"], device)
    return {"rows": rows, "csv_write_wall_s": write_wall,
            "read_wall_s": read_wall, "train_wall_s": train_wall,
            "vectorizer_fit_s": fit_s.get("vectorizers"),
            "vectorizer_layer_wall_s": timings["layers"][0]["wall_s"],
            "checker_fit_s": fit_s.get("checker"),
            "selector_fit_s": fit_s.get("selector"),
            "score_wall_s": score_wall, "score_rows_per_s": rows / score_wall,
            "save_load_wall_s": save_load_wall,
            "features_in": checker.summary["featuresIn"],
            "features_out": checker.summary["featuresOut"],
            "dropped": len(checker.summary["dropped"]),
            "winner": summ["bestModel"], "family_wall_s":
                summ["wallSeconds"]["families"],
            "holdout_auroc": summ["holdoutEvaluation"].get("AuROC"),
            "histogram_launches": launches, "expected_launches": expected,
            "loaded_scores_bitwise": True, "local_max_abs_err": local_err,
            "checker_oracle": oracle}


def export_part(seed: int, device, workdir, requests=EXPORT_REQUESTS):
    """EXPORT_MODELS Boston workflows (transmogrify and the
    LinearRegression candidate, each on its own seeded bootstrap)
    trained on ``device``, exported with ``export_portable``, loaded
    with ``portable.load`` and served together by one ServingEngine
    with the fused plane on. Every request's rows within SERVE_ATOL of
    its own WorkflowModel under the operand policy of the plane that
    served it; no fused fallback; on CUDA the fused kernel launched once
    a bucket slice."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.features import FeatureBuilder, reset_uids
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.ops import transmogrify
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.serving import (EngineConfig, ModelRegistry,
                                                 ServingEngine)
    from transmogrifai_tpu_torch.telemetry.spans import TRACER
    from transmogrifai_tpu_torch.workflow import Workflow
    types = _types(BOSTON_SCHEMA)
    records = DataReaders.csv(_repo_file("examples", "data", "boston.csv"),
                              types).read()
    rng = np.random.default_rng(seed + 23)
    reg = ModelRegistry()
    models = {}
    warm = None
    for k in range(EXPORT_MODELS):
        reset_uids()
        medv = FeatureBuilder.of(types["medv"], "medv").from_column() \
            .as_response()
        preds = [FeatureBuilder.of(t, n).from_column().as_predictor()
                 for n, t in types.items() if n != "medv"]
        pred = TM.RegressionModelSelector.with_train_validation_split(
            candidates=[["LinearRegression", None]]).set_input(
                medv, transmogrify(preds)).output
        boot = [records[i] for i in rng.integers(0, len(records),
                                                 len(records))]
        wm = Workflow([pred]).train(boot, device=device)
        art = os.path.join(workdir, f"boston_{k}")
        wm.export_portable(art, buckets=BUCKETS)
        pm = portable.load(art, device=device)
        if pm.manifest["hostPrefix"]:
            raise AssertionError(f"Boston export has a host prefix "
                                 f"{pm.manifest['hostPrefix']}")
        name = f"b{k}"
        if warm is None:
            warm = {c: np.zeros(1) for c in pm.boundary if c != "medv"}
        reg.register(name, pm, buckets=BUCKETS, warm_sample=warm,
                     make_default=(k == 0))
        models[name] = wm
    cols = [c for c in types if c != "medv"]
    reqs = []
    for _ in range(requests):
        n = int(rng.integers(1, 9))
        rows = rng.integers(0, len(records), n)
        data = {}
        for c in cols:
            v = np.asarray([np.nan if records[i][c] is None
                            else float(records[i][c]) for i in rows])
            v[rng.random(n) < 0.05] = np.nan
            data[c] = v
        reqs.append((f"b{int(rng.integers(0, EXPORT_MODELS))}", data))
    TRACER.clear()
    traces = [TRACER.mint("req") for _ in reqs]
    eng = ServingEngine(registry=reg, config=EngineConfig(
        max_batch_rows=MAX_BATCH_ROWS, fused_kernel=True)).start()
    sk.fused_linear_scores.launches = 0
    try:
        results, lat, wall = _storm(eng, reqs, THREADS, traces)
        moved = sk.fused_linear_scores.launches
    finally:
        eng.stop()
    stats = eng.stats.as_dict()
    plane, fused_spans = _served_planes(TRACER.spans(), traces)
    bf16 = sk.serve_dtype(device) == torch.bfloat16
    matched = {"fused": 0, "classic": 0}
    worst = 0.0
    for (mname, data), res, tid in zip(reqs, results, traces):
        wm = models[mname]
        sel = wm.selected_model()
        recs = [{c: (None if np.isnan(data[c][i]) else
                     (bool(data[c][i]) if types[c].__name__ == "Binary"
                      else float(data[c][i]))) for c in cols}
                for i in range(len(data[cols[0]]))]
        full = wm.transform(recs)
        if plane[tid] == "fused" and bf16:
            X = full.column(sel.input_names[1]).astype(np.float32)
            beta = sel.model_params["beta"].cpu().numpy()
            want = (round_bf16(X).astype(np.float64)
                    @ round_bf16(beta[:-1]).astype(np.float64)
                    + float(beta[-1]))
        else:
            want = _probs(wm, full)
        got = np.asarray(res[sel.output.name], np.float64).reshape(-1)
        err = float(np.abs(got - want).max())
        worst = max(worst, err)
        if not err <= SERVE_ATOL:
            raise AssertionError(f"Boston request for {mname} on the "
                                 f"{plane[tid]} plane differs from its "
                                 f"WorkflowModel by {err}")
        matched[plane[tid]] += 1
    if stats["fused_fallbacks"] != 0 or stats["failed"] != 0:
        raise AssertionError(f"engine fallbacks {stats['fused_fallbacks']}"
                             f", failed {stats['failed']}")
    if stats["fused_batches"] <= 0:
        raise AssertionError("the exported models never rode the fused "
                             "plane")
    slices = sum(max(1, -(-s["attrs"]["rows"] // BUCKETS[-1]))
                 for s in fused_spans)
    if torch.device(device).type == "cuda" and moved != slices:
        raise AssertionError(f"the fused kernel launched {moved} times for "
                             f"{slices} fused bucket slices")
    from transmogrifai_tpu_torch.profiling import percentile_nearest_rank
    lat_ms = sorted(x * 1e3 for x in lat)
    return {"models": EXPORT_MODELS, "requests": requests,
            "rows": sum(len(d["crim"]) for _, d in reqs), "wall_s": wall,
            "p50_ms": percentile_nearest_rank(lat_ms, 0.50),
            "p99_ms": percentile_nearest_rank(lat_ms, 0.99),
            "matched": matched, "max_abs_err": worst,
            "fused_batches": stats["fused_batches"],
            "fused_fallbacks": stats["fused_fallbacks"],
            "kernel_launches": moved, "fused_slices": slices}


def workflow_lines(wf) -> list:
    """One line per step of the workflow phase, every number taken from
    its result ``wf``."""
    ti, sc, ex = wf["titanic"], wf["scale"], wf["export"]
    steps = (("titanic train", ti["train_wall_s"], "s"),
             ("titanic score", ti["score_wall_s"], "s"),
             ("titanic load", ti["load_wall_s"], "s"),
             ("scale read", sc["read_wall_s"], "s"),
             ("scale vectorizer fits", sc["vectorizer_fit_s"], "s"),
             ("scale checker", sc["checker_fit_s"], "s"),
             ("scale selector", sc["selector_fit_s"], "s"),
             ("scale train", sc["train_wall_s"], "s"),
             ("scale score", sc["score_rows_per_s"], "rows/s"),
             ("scale save/load", sc["save_load_wall_s"], "s"),
             ("export serve p50", ex["p50_ms"], "ms"),
             ("export serve p99", ex["p99_ms"], "ms"))
    out = [f"phase workflow: {label}: {value!r} {unit}"
           for label, value, unit in steps]
    out.append("phase workflow: scale checker vs numpy f64: "
               + json.dumps(sc["checker_oracle"]))
    return out


def workflow_phase(seed: int, device="cuda", rows: int = SCALE_ROWS,
                   check=None):
    """The front door on ``device``: the Titanic helloworld through the
    runner (held to the port's CPU run), the at-scale CSV workflow and
    four exported Boston workflows served through the fused plane. The
    histogram launches of the whole phase are returned for the kernels
    line. ``rows`` and ``device`` exist for a CPU rehearsal."""
    import shutil
    import tempfile
    from transmogrifai_tpu_torch import native
    workdir = tempfile.mkdtemp(prefix="tm_workflow_phase_")
    try:
        titanic = titanic_part(device, os.path.join(workdir, "titanic"),
                               check=check)
        scale = scale_part(seed, device, workdir, rows)
        export = export_part(seed, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"native_csv": native.available(), "titanic": titanic,
            "scale": scale, "export": export,
            "histogram_launches": (titanic["histogram_launches"]
                                   + scale["histogram_launches"]),
            "fused_launches": export["kernel_launches"]}


# ---------------------------------------------------------------------------
# ctr: the Criteo path (hashed sparse families, streamed)

CTR_K, CTR_D, CTR_BUCKETS = 26, 13, 1 << 20     # bench.py:3025-3027
CTR_CHUNK_ROWS = 1_000_000
CTR_STREAM_CHUNKS = 4           # the bench's 10 chunks, cut for time
CTR_STREAM_BATCH = 65_536
CTR_ORACLE_STEPS, CTR_ORACLE_BATCH = 3, 8192
CTR_ORACLE_L2 = 1e-3            # lazy L2 on: the touched-bucket path runs
#: oracle limit, of max|w| of each table: f32 steps against numpy f64
CTR_ORACLE_RTOL = 1e-5
CTR_SWEEP_ROWS = 2_000_000
CTR_CPU_ROWS, CTR_CPU_BUCKETS = 20_000, 1 << 16
CTR_CPU_TOL = 1e-5              # per-grid-point validation loss
#: examples/op_ctr_sparse.py's schema; bench.py:3184-3188's settings
CTR_N_CAT, CTR_N_NUM, CTR_FRONT_BUCKETS = 8, 4, 1 << 18
CTR_FRONT_ROWS, CTR_FRONT_CHUNK, CTR_FRONT_STREAM_CHUNKS = 200_000, 50_000, 4
CTR_CAT_NAMES = ["device", "slot", "campaign"] + [
    f"cat{j}" for j in range(CTR_N_CAT - 3)]
CTR_LOCO_ROWS = 100
CTR_LOCO_ATOL = 1e-5
CTR_SERVE_ATOL = 1e-5
CTR_REQUESTS = 96
#: a fit that learned the signal fields beats chance by this much
CTR_MIN_AUROC = 0.55


def ctr_chunk(seed: int, rows: int = CTR_CHUNK_ROWS,
              buckets: int = CTR_BUCKETS) -> dict:
    """A copy of bench.py::_ctr_chunk (:3030): a synthetic Criteo-like
    chunk of 26 hashed categoricals (two carry signal at realistic
    cardinality, the rest uniform noise over the whole table) and 13
    numerics."""
    rng = np.random.default_rng(seed)
    n = rows
    idx = rng.integers(0, buckets, size=(n, CTR_K), dtype=np.int32)
    idx[:, 0] = rng.integers(0, 5000, n)
    idx[:, 1] = rng.integers(0, 3000, n)
    num = rng.normal(size=(n, CTR_D)).astype(np.float32)
    logit = ((idx[:, 0] % 7 < 3).astype(np.float32) * 1.2
             - (idx[:, 1] % 5 < 2).astype(np.float32) * 1.0
             + 0.5 * num[:, 0])
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return {"idx": idx, "num": num, "y": y, "w": np.ones(n, np.float32)}


def _sync_of(device):
    return (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))


def _auroc(p, y) -> float:
    from transmogrifai_tpu_torch.evaluators.functional import auroc
    return float(auroc(torch.as_tensor(np.asarray(p, np.float32)),
                       torch.as_tensor(np.asarray(y, np.float32))))


def ctr_stream_part(seed, device, rows=CTR_CHUNK_ROWS,
                    chunks=CTR_STREAM_CHUNKS, batch=CTR_STREAM_BATCH,
                    buckets=CTR_BUCKETS):
    """``fit_sparse_lr_streaming`` over ``chunks`` chunks at ``batch``:
    streamed from the host (chunks made on the producer thread, copied
    through pinned memory on a side stream), then with the padded
    chunks already on the card; rows/s each (after one warm chunk), the
    card's busy share of each, the holdout AUROC on a separate chunk.
    The two fits see the same minibatches, so their tables must be
    bitwise equal."""
    from transmogrifai_tpu_torch.io.stream import tree_map
    from transmogrifai_tpu_torch.models.sparse import (
        _pad_chunk, fit_sparse_lr_streaming, predict_sparse_lr)
    cuda = torch.device(device).type == "cuda"
    sync = _sync_of(device)

    def fit(factory):
        return fit_sparse_lr_streaming(factory, buckets, CTR_D, lr=0.05,
                                       epochs=1, batch_size=batch,
                                       device=device)

    def streamed():
        for s in range(chunks):
            yield ctr_chunk(seed * 1000 + s, rows, buckets)

    fit(lambda: iter([ctr_chunk(seed * 1000, rows, buckets)]))   # warm
    sync()
    t0 = time.perf_counter()
    host_params = fit(streamed)
    host_wall = time.perf_counter() - t0
    cached = [tree_map(lambda a: torch.as_tensor(a).to(device),
                       _pad_chunk(ctr_chunk(seed * 1000 + s, rows, buckets),
                                  batch)) for s in range(chunks)]
    fit(lambda: iter(cached[:1]))                                 # warm
    sync()
    t0 = time.perf_counter()
    dev_params = fit(lambda: iter(cached))
    dev_wall = time.perf_counter() - t0
    for k in host_params:
        if not np.array_equal(host_params[k], dev_params[k]):
            raise AssertionError(f"streamed and device-fed fits differ in "
                                 f"{k!r}: the same minibatches must give "
                                 f"the same bits")
    hold = ctr_chunk(seed * 1000 + 991, rows, buckets)
    probs = predict_sparse_lr(dev_params, hold["idx"], hold["num"],
                              device=device)
    auc = _auroc(probs[:, 1], hold["y"])
    if not auc > CTR_MIN_AUROC:
        raise AssertionError(f"streamed CTR fit holdout AUROC {auc}")
    out = {"rows": rows * chunks, "batch": batch, "chunks": chunks,
           "host_wall_s": host_wall, "host_rows_per_s":
               rows * chunks / host_wall,
           "device_fed_wall_s": dev_wall, "device_fed_rows_per_s":
               rows * chunks / dev_wall, "holdout_auroc": auc,
           "streamed_equals_device_fed": True}
    if cuda:
        from torch.autograd import DeviceType
        prof, wall = profiled(_walled(lambda: fit(lambda: iter(cached))),
                              host=False)
        busy_us, ops = _device_time_us(prof)
        top = sorted(((ev.device_time_total, ev.count, ev.key[:90])
                      for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA), reverse=True)
        out.update(device_fed_busy_share=busy_us / 1e6 / wall,
                   device_fed_device_ops=ops,
                   device_fed_step_ms=busy_us / 1e3 / (
                       chunks * -(-rows // batch)),
                   device_fed_top_ops=[{"ms": us / 1e3, "count": c,
                                        "name": k} for us, c, k in top[:8]])
        del cached
        busy, ops, wall = _device_busy(lambda: fit(streamed))
        out.update(host_busy_share=busy / wall, host_device_ops=ops,
                   host_profiled_wall_s=wall)
    return out


def _np_sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def ctr_np_oracle(family, idx, X, y, B, steps, batch, emb=None):
    """numpy f64 minibatch steps of one family from zero state (the FM
    from ``emb``), with ``np.add.at`` scatter-adds: Adagrad-LR and the FM
    with lazy L2 on the hashed tables and decoupled L2 on dense,
    FTRL-Proximal with per-row sum gradients."""
    K, d = idx.shape[1], X.shape[1]
    lr, l2 = 0.05, CTR_ORACLE_L2
    alpha, beta, l1 = 0.1, 1.0, 1e-3
    P = {"table": np.zeros(B), "dense": np.zeros(d), "bias": np.zeros(())}
    if family == "fm":
        P["emb"] = np.asarray(emb, np.float64).copy()
    A = {k: np.full_like(v, 1e-6) for k, v in P.items()}
    Z = {k: np.zeros_like(v) for k, v in P.items()}
    N = {k: np.zeros_like(v) for k, v in P.items()}

    def ftrl_w(z, n):
        return np.where(np.abs(z) > l1,
                        -(z - np.sign(z) * l1) / ((beta + np.sqrt(n))
                                                  / alpha + l2), 0.0)

    for s in range(steps):
        sl = slice(s * batch, (s + 1) * batch)
        bi, bx, by = idx[sl].astype(np.int64), X[sl].astype(np.float64), \
            y[sl].astype(np.float64)
        W = ({k: ftrl_w(Z[k], N[k]) for k in Z} if family == "ftrl"
             else P)
        z = W["table"][bi].sum(1) + bx @ W["dense"] + W["bias"]
        if family == "fm":
            e = W["emb"][bi]
            sv = e.sum(1)
            z = z + 0.5 * (sv * sv - (e * e).sum(1)).sum(1)
        p = _np_sigmoid(z)
        dz = (p - by) if family == "ftrl" else (p - by) / len(by)
        g = {"table": np.zeros(B), "dense": bx.T @ dz, "bias": dz.sum()}
        np.add.at(g["table"], bi.ravel(), np.repeat(dz, K))
        if family == "fm":
            g["emb"] = np.zeros_like(P["emb"])
            np.add.at(g["emb"], bi.ravel(),
                      (dz[:, None, None] * (sv[:, None, :] - e)
                       ).reshape(-1, e.shape[2]))
        if family == "ftrl":
            for k in g:
                sigma = (np.sqrt(N[k] + g[k] ** 2) - np.sqrt(N[k])) / alpha
                Z[k] = Z[k] + g[k] - sigma * W[k]
                N[k] = N[k] + g[k] ** 2
            continue
        touched = np.zeros(B, bool)
        touched[bi.ravel()] = True
        g["table"] += l2 * np.where(touched, P["table"], 0.0)
        g["dense"] += l2 * P["dense"]
        if family == "fm":
            g["emb"] += l2 * np.where(touched[:, None], P["emb"], 0.0)
        for k in g:
            A[k] = A[k] + g[k] ** 2
            P[k] = P[k] - lr * g[k] / np.sqrt(A[k])
    return ({k: ftrl_w(Z[k], N[k]) for k in Z} if family == "ftrl" else P)


def ctr_oracle_part(seed, device, buckets=CTR_BUCKETS,
                    steps=CTR_ORACLE_STEPS, batch=CTR_ORACLE_BATCH):
    """The first ``steps`` minibatches of Adagrad-LR, FTRL and the FM
    (from a fixed seeded emb) on the card against numpy f64: every
    table and ``dense`` within CTR_ORACLE_RTOL of its max|w|."""
    from transmogrifai_tpu_torch.models import sparse as S
    c = ctr_chunk(seed * 1000 + 7, steps * batch, buckets)
    w = np.ones(steps * batch, np.float32)
    emb = (0.01 * np.random.default_rng(seed + 5).normal(
        size=(buckets, 8))).astype(np.float32)
    out = {}
    for fam in ("adagrad", "ftrl", "fm"):
        if fam == "ftrl":
            st = S.init_sparse_ftrl(buckets, CTR_D, device)
            S.ftrl_epoch(st, c["idx"], c["num"], c["y"], w, 0.1, 1.0, 1e-3,
                         CTR_ORACLE_L2, batch)
            got = S.ftrl_weights(st, 0.1, 1.0, 1e-3, CTR_ORACLE_L2)
        else:
            init = (S.init_sparse_fm(buckets, CTR_D, 8, emb=emb,
                                     device=device) if fam == "fm"
                    else S.init_sparse_lr(buckets, CTR_D, device))
            acc = S._zero_like_acc(init)
            epoch = S.fm_epoch if fam == "fm" else S.sparse_lr_epoch
            got, _ = epoch(init, acc, c["idx"], c["num"], c["y"], w, 0.05,
                           CTR_ORACLE_L2, batch)
        want = ctr_np_oracle(fam, c["idx"], c["num"], c["y"], buckets,
                             steps, batch, emb)
        errs = {}
        for k in ("table", "dense") + (("emb",) if fam == "fm" else ()):
            g = got[k].detach().cpu().numpy().astype(np.float64)
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            errs[k] = float(np.abs(g - want[k]).max()) / scale
            if not errs[k] <= CTR_ORACLE_RTOL:
                raise AssertionError(f"ctr oracle: {fam} {k} differs from "
                                     f"numpy f64 by {errs[k]} of max|w|")
        out[fam] = errs
    return out


def _ctr_dataset(seed, rows, buckets, chunk_rows):
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import types as ft
    parts = [ctr_chunk(seed * 1000 + 500 + i, min(chunk_rows, rows - s),
                       buckets)
             for i, s in enumerate(range(0, rows, chunk_rows))]
    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return Dataset({"y": cat["y"].astype(np.float64), "sidx": cat["idx"],
                    "dense": cat["num"]},
                   {"y": ft.RealNN, "sidx": ft.SparseIndices,
                    "dense": ft.OPVector})


def _ctr_selector(buckets, device, **kw):
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.models.sparse import SparseModelSelector
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    sf = FeatureBuilder.of(ft.SparseIndices, "sidx").from_column() \
        .as_predictor()
    dn = FeatureBuilder.of(ft.OPVector, "dense").from_column().as_predictor()
    return SparseModelSelector(num_buckets=buckets, device=device,
                               **kw).set_input(lbl, sf, dn)


def _ctr_sync_free_epoch(ds, sel, device):
    """One streamed epoch of the default grid's Adagrad family (12
    instances) under ``set_sync_debug_mode("error")``: the chunks'
    prefetch and every step queue without a host sync."""
    from transmogrifai_tpu_torch.io.stream import prefetch_to_device
    from transmogrifai_tpu_torch.models import sparse as S
    p = sel.params
    hypers = [g for g in p["grid"] if g.get("family") == "adagrad"]
    keys, init_state, advance, _, _ = S._family_sweep_def("adagrad", 8, 0)
    GF = len(hypers) * p["n_folds"]
    st = S._broadcast_state(init_state(p["num_buckets"], CTR_D, p["seed"],
                                       None, device), GF)
    hyper_b = tuple(torch.as_tensor(np.tile([h[k] for h in hypers],
                                            p["n_folds"]), device=device,
                                    dtype=torch.float32) for k in keys)
    fold_b = torch.as_tensor(np.repeat(np.arange(p["n_folds"]),
                                       len(hypers)), device=device)
    idx, X, y = ds.column("sidx"), ds.column("dense"), \
        ds.column("y").astype(np.float32)

    def chunks():
        for s in range(0, len(y), p["chunk_rows"]):
            sl = slice(s, s + p["chunk_rows"])
            yield {"idx": idx[sl], "num": X[sl], "y": y[sl],
                   "w": np.ones(len(y[sl]), np.float32)}

    prepared = S._prepared_chunks(chunks, p["n_folds"], p["seed"],
                                  p["batch_size"])
    torch.cuda.synchronize()
    steps = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c in prefetch_to_device(prepared, 2, device=device):
            w = c["w"][None] * (c["fold"][None] != fold_b[:, None])
            advance(st, hyper_b, c["idx"].to(torch.int64), c["num"],
                    c["y"], w, p["batch_size"])
            steps += c["y"].shape[0] // p["batch_size"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return steps


def ctr_sweep_part(seed, device, rows=CTR_SWEEP_ROWS, buckets=CTR_BUCKETS,
                   chunk_rows=CTR_CHUNK_ROWS):
    """``SparseModelSelector()`` at its defaults (11-point grid over
    adagrad / ftrl / fm, 2 folds, batch 8,192, ``chunk_rows`` chunks) on
    ``rows`` rows, twice: the validation losses, the winner and the
    refit's tables must be bitwise equal; each family's sweep wall and
    the refit's; then one streamed epoch with no host sync."""
    ds = _ctr_dataset(seed, rows, buckets, chunk_rows)
    runs = []
    for _ in range(2):
        sel = _ctr_selector(buckets, device, chunk_rows=chunk_rows)
        t0 = time.perf_counter()
        model = sel.fit(ds)
        _sync_of(device)()
        runs.append((model, time.perf_counter() - t0))
    (m1, w1), (m2, w2) = runs
    s1, s2 = m1.summary, m2.summary
    l1 = [r["logloss"] for r in s1["validationResults"]]
    l2 = [r["logloss"] for r in s2["validationResults"]]
    if l1 != l2 or s1["bestModel"] != s2["bestModel"]:
        raise AssertionError(f"two default-grid sweeps differ: {l1} vs {l2}")
    for k in m1.model_params:
        if not torch.equal(m1.model_params[k], m2.model_params[k]):
            raise AssertionError(f"two refits differ in {k!r}")
    if not all(np.isfinite(l1)):
        raise AssertionError(f"non-finite validation losses {l1}")
    out = {"rows": rows, "grid": len(l1), "fit_wall_s": [w1, w2],
           "family_wall_s": s1["wallSeconds"]["families"],
           "family_wall_s_run2": s2["wallSeconds"]["families"],
           "refit_wall_s": [s1["wallSeconds"]["refit"],
                            s2["wallSeconds"]["refit"]],
           "winner": s1["bestModel"], "logloss": l1,
           "holdout_auroc": s1["holdoutEvaluation"]["AuROC"],
           "bitwise_repeat": True}
    if torch.device(device).type == "cuda":
        out["sync_free_epoch_steps"] = _ctr_sync_free_epoch(ds, sel, device)
    return out


def ctr_cpu_part(seed, device, rows=CTR_CPU_ROWS, buckets=CTR_CPU_BUCKETS):
    """The default grid on ``rows`` rows at ``buckets`` on ``device`` and
    with ``device="cpu"``: every grid point's validation loss within
    CTR_CPU_TOL and the same winner."""
    ds = _ctr_dataset(seed + 3, rows, buckets, rows)
    card = _ctr_selector(buckets, device).fit(ds).summary
    cpu = _ctr_selector(buckets, "cpu").fit(ds).summary
    a = [r["logloss"] for r in card["validationResults"]]
    b = [r["logloss"] for r in cpu["validationResults"]]
    gap = float(np.abs(np.asarray(a) - np.asarray(b)).max())
    if not gap <= CTR_CPU_TOL or card["bestModel"] != cpu["bestModel"]:
        raise AssertionError(f"ctr card vs CPU: loss gap {gap}, winners "
                             f"{card['bestModel']} / {cpu['bestModel']}")
    return {"rows": rows, "buckets": buckets, "max_loss_gap": gap,
            "winner": card["bestModel"]}


def ctr_records(n_rows: int, seed: int = 0):
    """examples/op_ctr_sparse.py::make_records, a copy: device/slot/
    campaign-style categoricals (two carry signal) and numeric
    counters."""
    rng = np.random.default_rng(seed)
    device = rng.choice(["ios", "android", "web"], n_rows, p=[.3, .5, .2])
    slot = rng.integers(0, 400, n_rows)
    campaign = rng.integers(0, 3000, n_rows)
    noise_cats = rng.integers(0, 100_000, size=(n_rows, CTR_N_CAT - 3))
    nums = rng.normal(size=(n_rows, CTR_N_NUM)).astype(np.float64)
    logit = (np.where(device == "ios", 0.8,
                      np.where(device == "web", -0.6, 0.1))
             + np.where(slot % 7 < 2, 0.9, -0.3) + 0.5 * nums[:, 0])
    y = (rng.random(n_rows) < 1 / (1 + np.exp(-logit))).astype(float)
    recs = []
    for i in range(n_rows):
        r = {"device": str(device[i]), "slot": f"s{slot[i]}",
             "campaign": f"c{campaign[i]}", "click": float(y[i])}
        for j in range(CTR_N_CAT - 3):
            r[f"cat{j}"] = f"v{noise_cats[i, j]}"
        for j in range(CTR_N_NUM):
            r[f"num{j}"] = float(nums[i, j])
        recs.append(r)
    return recs


def ctr_workflow(buckets=CTR_FRONT_BUCKETS, chunk_rows=CTR_FRONT_CHUNK):
    """examples/op_ctr_sparse.py::build_workflow rebuilt from the port's
    classes: transmogrify_sparse over the 8 categoricals and 4 numerics,
    SparseModelSelector over 2 adagrad + ftrl + fm."""
    from transmogrifai_tpu_torch.features import FeatureBuilder, reset_uids
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.models.sparse import SparseModelSelector
    from transmogrifai_tpu_torch.ops import transmogrify_sparse
    from transmogrifai_tpu_torch.workflow import Workflow
    reset_uids()
    click = FeatureBuilder.of(ft.RealNN, "click").from_column().as_response()
    cats = [FeatureBuilder.of(ft.PickList, c).from_column().as_predictor()
            for c in CTR_CAT_NAMES]
    nums = [FeatureBuilder.of(ft.Real, f"num{j}").from_column()
            .as_predictor() for j in range(CTR_N_NUM)]
    hashed, dense = transmogrify_sparse(cats + nums, num_buckets=buckets)
    pred = SparseModelSelector(
        num_buckets=buckets, n_folds=2, epochs=1, refit_epochs=2,
        batch_size=4096, chunk_rows=chunk_rows,
        grid=[{"family": "adagrad", "lr": lr, "l2": 0.0}
              for lr in (0.05, 0.1)]
        + [{"family": "ftrl", "alpha": 0.1, "l1": 0.0},
           {"family": "fm", "lr": 0.05, "l2": 0.0}],
    ).set_input(click, hashed, dense).output
    return Workflow([pred])


def _p1(model, ds) -> np.ndarray:
    name = model.result_features[0].name
    return np.asarray([r["probability_1"] for r in ds.column(name)])


def ctr_front_part(seed, device, workdir, rows=CTR_FRONT_ROWS,
                   chunk_rows=CTR_FRONT_CHUNK, buckets=CTR_FRONT_BUCKETS):
    """The front door: the example's workflow through ``WorkflowRunner``
    TRAIN twice (cold and warm walls) and EVALUATE; the saved model
    loaded and scored bitwise; ``score_stream`` over 4 chunks bitwise
    the batch scorer and ``score``; ``LocalScorer`` bitwise on 100 rows;
    ``SparseRecordInsightsLOCO`` on 100 rows within CTR_LOCO_ATOL of a
    numpy recomputation."""
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.insights import SparseRecordInsightsLOCO
    from transmogrifai_tpu_torch.local import LocalScorer
    from transmogrifai_tpu_torch.ops.sparse import SparseHashingVectorizer
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.runner import (OpParams, RunType,
                                                WorkflowRunner)
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    sync = _sync_of(device)
    t0 = time.perf_counter()
    recs = ctr_records(rows, seed)
    gen_wall = time.perf_counter() - t0
    reader = DataReaders.simple(recs)
    runner = WorkflowRunner(ctr_workflow(buckets, chunk_rows),
                            train_reader=reader, score_reader=reader,
                            evaluator=Evaluators.binary_classification(),
                            device=device)
    params = OpParams(model_location=os.path.join(workdir, "ctr_model"),
                      metrics_location=os.path.join(workdir, "ctr_metrics"),
                      response="click")
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        train = runner.run(RunType.TRAIN, params)
        sync()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ev = runner.run(RunType.EVALUATE, params)
    eval_wall = time.perf_counter() - t0
    auc = ev["metrics"]["AuROC"]
    if not auc > CTR_MIN_AUROC:
        raise AssertionError(f"ctr front door AuROC {auc}")
    model = runner._model
    first = _p1(model, model.score(recs))
    loaded = WorkflowModel.load(params.model_location, device=device)
    if not np.array_equal(_p1(loaded, loaded.score(recs)), first):
        raise AssertionError("ctr: the loaded model's scores differ")
    name = loaded.result_features[0].name
    sc = loaded.compile_scoring(device=device)
    batch = sc.score_arrays(recs)[name]
    step = -(-rows // CTR_FRONT_STREAM_CHUNKS)
    t0 = time.perf_counter()
    outs = list(sc.score_stream(iter([recs[s:s + step]
                                      for s in range(0, rows, step)])))
    stream_wall = time.perf_counter() - t0
    streamed = np.concatenate([o[name] for o in outs])
    if len(outs) != CTR_FRONT_STREAM_CHUNKS or not np.array_equal(
            streamed, batch) or not np.array_equal(
            streamed[:, 1].astype(np.float64), first):
        raise AssertionError("ctr: score_stream differs from the batch "
                             "scores")
    local = LocalScorer(loaded, device=device)
    lp = np.asarray([local({k: v for k, v in r.items() if k != "click"})
                     [name]["probability_1"]
                     for r in recs[:CTR_LOCO_ROWS]])
    if not np.array_equal(lp, first[:CTR_LOCO_ROWS]):
        raise AssertionError(
            f"ctr: LocalScorer differs from the batch by "
            f"{float(np.abs(lp - first[:CTR_LOCO_ROWS]).max())}")
    sel = loaded.selected_model()
    vec = next(st for st in loaded.stages
               if isinstance(st, SparseHashingVectorizer))
    hashed, dense = sel.input_names[1], sel.input_names[2]
    full = loaded.transform(recs[:CTR_LOCO_ROWS])
    idx = full.column(hashed).astype(np.int64)
    X = full.column(dense).astype(np.float64)
    d = X.shape[1]
    loco = SparseRecordInsightsLOCO.from_vectorizer(
        sel, vec, dense_names=[f"d{j}" for j in range(d)],
        top_k=idx.shape[1] + d).wire([hashed, dense], "loco")
    col = loco.transform(full).column("loco")
    P = {k: v.detach().cpu().numpy().astype(np.float64)
         for k, v in sel.model_params.items()}

    def p1(ix, x):
        z = P["table"][ix].sum(1) + x @ P["dense"] + P["bias"]
        if "emb" in P:
            e = P["emb"][ix]
            s = e.sum(1)
            z = z + 0.5 * (s * s - (e * e).sum(1)).sum(1)
        return _np_sigmoid(z)
    base = p1(idx, X)
    loco_err = 0.0
    for k, fname in enumerate(vec.input_names):
        ix = idx.copy()
        ix[:, k] = loco.null_buckets[k]
        want = base - p1(ix, X)
        got = np.asarray([json.loads(r[fname])[1] for r in col])
        loco_err = max(loco_err, float(np.abs(got - want).max()))
    for j in range(d):
        x = X.copy()
        x[:, j] = 0.0
        want = base - p1(idx, x)
        got = np.asarray([json.loads(r[f"d{j}"])[1] for r in col])
        loco_err = max(loco_err, float(np.abs(got - want).max()))
    if not loco_err <= CTR_LOCO_ATOL:
        raise AssertionError(f"ctr LOCO differs from numpy by {loco_err}")
    summ = sel.summary
    return {"rows": rows, "chunk_rows": chunk_rows, "buckets": buckets,
            "records_wall_s": gen_wall, "train_cold_wall_s": walls[0],
            "train_warm_wall_s": walls[1], "evaluate_wall_s": eval_wall,
            "auroc": auc, "best": train["bestModel"],
            "field_contributions": dict(zip(vec.input_names,
                                            train["fieldContributions"])),
            "family_wall_s": summ["wallSeconds"]["families"],
            "refit_wall_s": summ["wallSeconds"]["refit"],
            "stream_wall_s": stream_wall, "loaded_scores_bitwise": True,
            "stream_bitwise": True, "local_bitwise": True,
            "loco_max_abs_err": loco_err, "model": loaded}


def ctr_serve_part(model, device, workdir, requests=CTR_REQUESTS,
                   seed=0):
    """``export_portable`` -> ``portable.load`` -> one ServingEngine,
    ``requests`` requests of 1-8 rows from 8 threads carrying the
    boundary columns (hashed ids as int32): every row within
    CTR_SERVE_ATOL of a numpy mirror of the runtime's concat and
    ``op_sparse_predict``; every request on the classic plane (its
    engine spans), the fused kernel launched 0 times; p50 / p99."""
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.profiling import percentile_nearest_rank
    from transmogrifai_tpu_torch.serving import (EngineConfig, ModelRegistry,
                                                 ServingEngine)
    from transmogrifai_tpu_torch.telemetry.spans import TRACER
    art = os.path.join(workdir, "ctr_export")
    model.export_portable(art, buckets=BUCKETS)
    pm = portable.load(art, device=device)
    man = pm.manifest
    if "SparseHashingVectorizer" not in man["hostPrefix"] or \
            man["stages"][-1]["op"] != "sparse_predict":
        raise AssertionError(f"ctr export: unexpected manifest {man}")
    host = model.compile_scoring(device=device)._host_ds(
        ctr_records(512, seed + 1))
    cols = {c: np.asarray(host.column(c)) for c in pm.boundary
            if c in host and c not in pm.response_boundary}
    params = {k: v.astype(np.float64) for k, v in
              pm.arrays[str(len(man["stages"]) - 1)]["params"].items()}
    concat = next(st for st in man["stages"] if st["op"] == "concat")
    head = man["stages"][-1]

    def mirror(data):
        X = np.concatenate([np.asarray(data[c], np.float64).reshape(
            len(data[c]), -1) for c in concat["inputs"]], axis=1)
        ix = np.asarray(data[head["inputs"][1]]).astype(np.int64)
        z = params["table"][ix].sum(1) + X @ params["dense"] + \
            params["bias"]
        if "emb" in params:
            e = params["emb"][ix]
            s = e.sum(1)
            z = z + 0.5 * (s * s - (e * e).sum(1)).sum(1)
        return _np_sigmoid(z)

    reg = ModelRegistry()
    reg.register("ctr", pm, buckets=BUCKETS,
                 warm_sample={c: v[:1] for c, v in cols.items()})
    rng = np.random.default_rng(seed + 31)
    reqs = []
    for _ in range(requests):
        rows = rng.integers(0, 512, int(rng.integers(1, 9)))
        reqs.append(("ctr", {c: v[rows] for c, v in cols.items()}))
    TRACER.clear()
    traces = [TRACER.mint("req") for _ in reqs]
    eng = ServingEngine(registry=reg, config=EngineConfig(
        max_batch_rows=MAX_BATCH_ROWS, fused_kernel=True)).start()
    sk.fused_linear_scores.launches = 0
    try:
        results, lat, wall = _storm(eng, reqs, THREADS, traces)
        moved = sk.fused_linear_scores.launches
    finally:
        eng.stop()
    plane, _ = _served_planes(TRACER.spans(), traces)
    worst = 0.0
    name = pm.result_names[0]
    for (_, data), res in zip(reqs, results):
        got = np.asarray(res[name], np.float64)[:, 1]
        worst = max(worst, float(np.abs(got - mirror(data)).max()))
    if not worst <= CTR_SERVE_ATOL:
        raise AssertionError(f"ctr served rows differ from numpy by {worst}")
    if set(plane.values()) != {"classic"} or moved != 0:
        raise AssertionError(f"ctr requests rode {set(plane.values())}, "
                             f"fused launches {moved}")
    stats = eng.stats.as_dict()
    if stats["failed"]:
        raise AssertionError(f"ctr serving: {stats['failed']} failed")
    lat_ms = sorted(x * 1e3 for x in lat)
    return {"requests": requests, "rows": sum(len(d[head["inputs"][1]])
                                              for _, d in reqs),
            "wall_s": wall, "max_abs_err": worst,
            "p50_ms": percentile_nearest_rank(lat_ms, 0.50),
            "p99_ms": percentile_nearest_rank(lat_ms, 0.99),
            "planes": sorted(set(plane.values())), "fused_launches": moved}


def ctr_phase(seed: int, device="cuda", stream_rows=CTR_CHUNK_ROWS,
              stream_chunks=CTR_STREAM_CHUNKS, stream_batch=CTR_STREAM_BATCH,
              buckets=CTR_BUCKETS, sweep_rows=CTR_SWEEP_ROWS,
              sweep_chunk=CTR_CHUNK_ROWS, cpu_rows=CTR_CPU_ROWS,
              front_rows=CTR_FRONT_ROWS, front_chunk=CTR_FRONT_CHUNK,
              requests=CTR_REQUESTS):
    """The Criteo path on ``device`` at Criteo's published widths (26
    hashed categoricals, 13 numerics, 2^20 buckets, FM width 8): the
    streamed fit, the numpy oracle, the default-grid sweep (twice), the
    card against the CPU, the example's front door and its export
    served. The three CUDA kernels' launches over the whole phase are
    returned (the path has none). The sizes exist for a CPU
    rehearsal."""
    import shutil
    import tempfile
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    sk.fused_linear_scores.launches = 0
    tk.histogram_grid.launches = 0
    tk.ring_allreduce.launches = 0
    workdir = tempfile.mkdtemp(prefix="tm_ctr_phase_")
    walls = {}
    try:
        t0 = time.perf_counter()
        stream = ctr_stream_part(seed, device, stream_rows, stream_chunks,
                                 stream_batch, buckets)
        walls["stream"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        oracle = ctr_oracle_part(seed, device, buckets)
        walls["oracle"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sweep = ctr_sweep_part(seed, device, sweep_rows, buckets,
                               sweep_chunk)
        walls["sweep"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = ctr_cpu_part(seed, device, cpu_rows)
        walls["card_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        front = ctr_front_part(seed, device, workdir, front_rows,
                               front_chunk)
        walls["front_door"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve = ctr_serve_part(front.pop("model"), device, workdir,
                               requests, seed)
        walls["serve"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {"fused_linear_scores": sk.fused_linear_scores.launches,
                "tree_histogram": tk.histogram_grid.launches,
                "ring_allreduce": tk.ring_allreduce.launches}
    if any(launches.values()):
        raise AssertionError(f"the CTR path launched a CUDA kernel: "
                             f"{launches}")
    return {"stream": stream, "oracle": oracle, "sweep": sweep,
            "card_vs_cpu": cpu, "front_door": front, "serve": serve,
            "walls_s": walls, "launches": launches}


def ctr_lines(ctr) -> list:
    """One line per reported CTR number, each taken from ``ctr``."""
    st, sw, fd, sv = (ctr["stream"], ctr["sweep"], ctr["front_door"],
                      ctr["serve"])
    steps = [("stream host rows/s", st["host_rows_per_s"], "rows/s"),
             ("stream device-fed rows/s", st["device_fed_rows_per_s"],
              "rows/s"),
             ("stream holdout AUROC", st["holdout_auroc"], ""),
             ("stream host busy share", st.get("host_busy_share"), ""),
             ("stream device-fed busy share",
              st.get("device_fed_busy_share"), ""),
             ("sweep fit walls", sw["fit_wall_s"], "s"),
             ("sweep family walls", sw["family_wall_s"], "s"),
             ("sweep refit walls", sw["refit_wall_s"], "s"),
             ("sweep winner", sw["winner"], ""),
             ("card vs cpu max loss gap", ctr["card_vs_cpu"]["max_loss_gap"],
              ""),
             ("front door train cold", fd["train_cold_wall_s"], "s"),
             ("front door train warm", fd["train_warm_wall_s"], "s"),
             ("front door AUROC", fd["auroc"], ""),
             ("front door best", fd["best"], ""),
             ("front door fieldContributions", fd["field_contributions"],
              ""),
             ("serve p50", sv["p50_ms"], "ms"),
             ("serve p99", sv["p99_ms"], "ms")]
    return [f"phase ctr: {label}: {json.dumps(value)} {unit}".rstrip()
            for label, value, unit in steps]


# ---------------------------------------------------------------------------

def kernels_line(rows, serve, empty_ms, hrows, train, hmma, rrows, dp,
                 wf=None, ctr=None):
    """The ``kernels`` line from this run's phase results: every time
    and error is one this run measured, every bound one it computed
    from its own inputs, every launch count its main path's (the
    histogram's: the training phase's and the workflow phase's ``wf``;
    the serving kernel's: the serving phase's, with the workflow
    phase's exported models apart; ``ctr_launches``: the CTR phase's,
    which launches none)."""
    ctr_launches = (ctr or {}).get("launches", {})
    # the serving pass's shape in its operand mode: the prefix form,
    # and the identity form (the JAX function) with its library call
    main_row = next(r for r in rows if r["form"] == "prefix")
    ident = rows[0]
    hmain = hrows[0]          # the capture shape, bf16 (training's mode)
    # the data-parallel grow's deepest level, 4 ranks on one card
    rmain = next(r for r in rrows if r["layout"] == "one card"
                 and r["shape"] == "gbt_level" and r["ndev"] == DP_RANKS)
    return {"kernels": [{
        "name": "fused_linear_scores", "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/fused_linear_scores.cu",
        "replaces": "transmogrifai_tpu/models/serving_kernels.py:224 and "
                    "transmogrifai_tpu/serving/fusion.py:265",
        "launches": serve["kernel_launches"],
        "workflow_launches": None if wf is None else wf["fused_launches"],
        "ctr_launches": ctr_launches.get("fused_linear_scores"),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], "act": main_row["act"],
        "dtype": main_row["dtype"], "call_ms": main_row["call_ms"],
        "plain_call_ms": main_row["plain_call_ms"],
        "launch_ms": empty_ms,
        "identity_shape": ident["shape"], "identity_ms": ident["ms"],
        "identity_library_ms": ident["library_ms"],
        "identity_library_call_ms": ident["library_call_ms"]}, {
        "name": "tree_histogram", "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/tree_histogram.cu",
        "replaces": "transmogrifai_tpu/models/kernels.py:612 and "
                    "transmogrifai_tpu/models/kernels.py:649",
        "launches": train["histogram_launches"] + (
            0 if wf is None else wf["histogram_launches"]),
        "training_launches": train["histogram_launches"],
        "workflow_launches": None if wf is None else wf["histogram_launches"],
        "ctr_launches": ctr_launches.get("tree_histogram"),
        "max_abs_err": max(r["max_abs_err"] for r in hrows),
        "ms": hmain["ms"], "plain_ms": hmain["plain_ms"],
        "bound_ms": hmain["bound_ms"], "bound_by": hmain["bound_by"],
        "library_ms": hmain["library_ms"],
        "shape": [hmain[k] for k in ("G", "n", "d", "S", "m", "B")],
        "dtype": hmain["dtype"], "call_ms": hmain["call_ms"],
        "plain_call_ms": hmain["plain_call_ms"],
        "library_call_ms": hmain["library_call_ms"],
        "sass_hmma": hmma}, {
        "name": "ring_allreduce", "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/ring_allreduce.cu",
        "replaces": "transmogrifai_tpu/models/kernels.py:770",
        "launches": dp["ring_launches"],
        "ctr_launches": ctr_launches.get("ring_allreduce"),
        "max_abs_err": max(r["max_abs_err"] for r in rrows),
        "ms": rmain["ms"], "plain_ms": rmain["plain_ms"],
        "bound_ms": rmain["bound_ms"], "bound_by": rmain["bound_by"],
        "library_ms": rmain["library_ms"], "shape": rmain["dims"],
        "ndev": rmain["ndev"], "layout": rmain["layout"],
        "span_ms": rmain["span_ms"], "call_ms": rmain["call_ms"],
        "plain_call_ms": rmain["plain_call_ms"],
        "library_call_ms": rmain["library_call_ms"],
        "library_device_ms": rmain["library_device_ms"]}]}


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
    from transmogrifai_tpu_torch import native
    print(f"phase device: native CSV/murmur3 library (csrc/tmnative.cpp) "
          f"loaded: {native.available()}", flush=True)
    for name, log in _cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  nvcc {name}: {line.strip()}", file=sys.stderr)

    hmma = sass_count("tree_histogram", "HMMA")
    print(f"phase device: tree_histogram SASS holds {hmma} HMMA "
          f"instructions", flush=True)
    if not hmma:
        raise AssertionError("the tree_histogram library's SASS holds no "
                             "HMMA: its add pass is off the tensor cores")

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
    lin = linear_phase(args.seed)
    print("phase linear: " + json.dumps(dict(lin, card=card)), flush=True)
    other = other_lists_phase(args.seed)
    print("phase other_lists: " + json.dumps(dict(other, card=card)),
          flush=True)

    rrows = ring_phase(args.seed)
    for r in rrows:
        print("phase ring_kernel: " + json.dumps(dict(r, card=card)),
              flush=True)
    if not any(r["layout"] == "peers" for r in rrows):
        print("phase ring_kernel: one card visible, so the peer-access "
              "path did not run (ranks shared cuda:0)", flush=True)
    dp = data_parallel_phase(args.seed)
    print("phase data_parallel: " + json.dumps(dict(dp, card=card)),
          flush=True)

    wf = workflow_phase(args.seed)
    print("phase workflow: " + json.dumps(dict(wf, card=card)), flush=True)
    for line in workflow_lines(wf):
        print(line, flush=True)

    ctr = ctr_phase(args.seed)
    print("phase ctr: " + json.dumps(dict(ctr, card=card)), flush=True)
    for line in ctr_lines(ctr):
        print(line, flush=True)

    print(json.dumps(kernels_line(rows, serve, empty_ms, hrows, train, hmma,
                                  rrows, dp, wf, ctr)), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
