#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths — fused multi-model LR serving, AutoML
training over the selector's default candidate lists (tree and linear
families), row-sharded tree growing over a data mesh and the workflow
front door (CSV reader, transmogrify, SanityChecker, selector,
save/load, scoring, export and serving), the Criteo path (hashed
sparse families streamed, swept, served), every feature type
through transmogrify, the FT-Transformer (grid fit, selector, export,
serving) and the serving tier (fleets on both transports,
failover, rollout, the CLI, the continuum loop) — through the entry
points a user calls, and holds each CUDA kernel against its plain
PyTorch version:

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
   ``histogram_grid``; wall time and the device's busy share;
   mesh: multi-device on 4 ranks sharing the card.
   ``parallel.sharded_statistics`` on the training rows against the
   one-rank ``compute_statistics`` and numpy f64, the ring bitwise the
   plain version (TM_MESH_RDMA_RING=0), its launches those the code
   derives; ``SanityChecker(mesh=)`` with a planted leak and a constant
   column dropping what the checker without a mesh drops; the sharded
   LR, FM (k = 8) and 3-class softmax fits at the CTR phase's widths on
   one 1M-row chunk at batch 65,536, each within 1e-4 of the one-device
   fit and ring bitwise plain, the ring launched once a rank a step,
   wall and ms a step beside the one-device step; the binary default
   list through ``set_mesh`` on grid meshes of 1, 2 and 4 ranks: grid
   metrics and winner bitwise, rank items summing to the real items,
   histogram launches of k ranks each growing every level of its shard,
   the wall at each size.
   mesh2d: the 2-D grid x data mesh, 2 x 2 ranks sharing the card.
   ``trees.quantile_bin_edges`` with its rows sharded over 2 ranks
   (zero weights, NaNs) bitwise the unsharded edges; the two grid rows'
   exchanges in flight together at one GBT level's shape with
   integer-valued parts, bitwise the plain sums; the binary default
   list through ``TM_MESH_AXIS=grid,data`` over a pool of 4 ranks on
   the card (the selector's own default mesh) against the one-rank fit: LR, LinearSVC and NaiveBayes CV metrics
   within 1e-4 / 1e-6, DT and RF bitwise, GBT and XGBoost within 1e-2,
   the same winner; histogram launches 2 x 2 x the folded levels + the
   refit; the ring's sums and gathers; every rank attributed, the 2-D
   runners' labels; the wall beside the one-rank fit's.
   multihost: two processes on the card (``gloo``, a localhost
   coordinator), each with 2 data ranks, fit LogisticRegression and
   GBTClassifier at 200k x 28 through ``WorkflowRunner`` TRAIN with
   ``OpParams.distributed`` over the hybrid mesh (2 processes x 2
   ranks): both exit 0 within 300 s, report the same CV metrics and
   winner, within the mesh2d tolerances of the one-process fit; each
   process's histogram launches 2 x GBT's folded levels + its refit.

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
   kernel launched once a bucket slice. The fused plane's two forms,
   with the same gates: five LR-only Titanic workflows (four regParams
   on the same rows, one on a bootstrap) exported with a host prefix of
   four OneHotModels, served on the table form (the pivots' vectors as
   packed slots of the prefix tables), each request within SERVE_ATOL
   of its own WorkflowModel; four model-stacking members (an inner
   LinearRegression before the head, ``make_stacked_ir``) on the
   generic form (each member's own prefix, then the kernel's identity
   table through the activation), each request within SERVE_ATOL of
   numpy. For each form the kernel against its plain version on a
   served slice's own arguments, timed beside its bound, and a fused
   pass of 60 rows beside the classic plane's passes over the same rows
   (device operations, device and host us).
   services: the runner's process-level services. ``debugNans``: the
   Titanic TRAIN raises ``FloatingPointError`` in the SanityChecker
   (``full_like``), where the JAX package raises on the CPU for the
   same data; without the checker (LR and GBT) it completes, as the JAX
   package's does; a 0/0 planted on the card raises naming ``div``.
   ``compilationCacheLocation``: a fresh process's GBT TRAIN builds the
   histogram kernel into the run's directory and the build directory
   is the default again afterwards.
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
10. features: every feature type through ``transmogrify``. The JAX
   bench's wide CRM workflow (a copy of ``bench.py::
   _workflow_train_data``: 56 predictors, 18 of them maps) at
   FEAT_CRM_RUN_ROWS rows (the line prints the cut from 50,000), trained
   as the bench's AutoML build (SanityChecker, 2-fold LR) and through
   the default binary list with ``with_raw_feature_filter(min_fill_rate=
   0.001)``: the walls of the feature layer, checker, selector and
   ``Workflow.train``, histogram launches equal to the tree levels, the
   device busy share, save/load (scores bitwise), bulk rows/s and
   ``LocalScorer`` on 1,000 rows within FEAT_LOCAL_ATOL of the bulk
   scores. The every-type workflow (the port's ``testkit``: Email, URL,
   Phone, Base64, DateList, TextArea, TextList, Geolocation, seven map
   types and a seller name removed as sensitive) at 100,000 rows through
   the default binary list: kept slots, winner, holdout AUROC, the
   sensitive verdict, launches. After each timed train with tree
   families, the histogram kernel against its plain version at the
   largest level that train gave it, in its operand mode (HIST_RTOL).
   ``fit_lda`` alone at (100,000 docs, V = 256, k = 8): wall, device
   time and operations beside its bound, no host sync. At 5,000 rows in
   exact mode, card against CPU: the same LDA vocabulary and kept
   slots, lambda within the LDA test's tolerance, LR within
   LINEAR_CPU_TOL, DT and GBT within GBT_PARITY_TOL; then DT and GBT on
   the card's checked matrix, card against CPU, as Titanic's GBT is
   held (TITANIC_CV_ATOL or the near-tie contract), each side's metrics
   recomputed on its own workflow's matrix.
   ``examples/op_house_log.py`` through the port (the seller removed,
   dollars within the example's bar, label-free row scoring). The
   checked-in JAX artifact ``tests/data/jax_features_model`` loaded and
   scored against the JAX package's scores (ARTIFACT_RTOL). Neither the
   serving kernel nor the ring may launch.
11. fleet: the serving tier. The serving phase's 100-id catalog (plus
   a default ``v1``) written as a registry root, so both transports
   load it by path. An inproc ``ServingFleet`` of 4 replicas (the JAX
   bench's ``fleet_failover``: buckets (64, 256), open-loop Poisson
   arrivals at 60 requests/s of 1-16 rows, 5 s steady, the busiest
   replica hard-killed, 5 s more, under torch.profiler for the busy
   share), then a staged ``rollout`` to v2 (seed + 1) under traffic:
   no lost request and no client error, every answer within SERVE_ATOL
   of numpy under the operand policy of the plane its spans name and
   equal to the same request scored alone through that plane
   (FLEET_REF_ATOL, bitwise counted), the rollout not rolled back, no
   fused fallback, one kernel launch a fused bucket slice. Two socket
   workers (``python -m transmogrifai_tpu_torch.serving.worker
   --device cuda``, each its own CUDA context on the card) under the
   JAX bench's ``cross_host_load`` (250 requests/s of 1-8 rows for 4
   s, deadline 400 ms, no emulated dispatch hang), one SIGKILLed
   halfway: no lost request, answers as above, each worker's status
   naming the card with a fused launch a fused pass and no fallback,
   the restarted worker serving again; the wire overhead from
   ``TransportStats``. An LR workflow over the same 12 columns trained
   on the card and saved, then served by ``python -m
   transmogrifai_tpu_torch serve --engine --replicas 2`` as a
   subprocess with TM_TRACE_DIR set (every row within CLI_ATOL of
   ``WorkflowModel.score``, spans written) and by ``serve`` in stream
   mode over a CSV of the same rows. A drift drill: x0-shifted traffic
   through a 2-replica fleet, detection, a retrain on the card, lint
   and shadow gates, one promotion, zero client errors; ``/metricsz``
   scraped from the socket fleet and the controller must carry the
   ``tm_fleet_*``, ``tm_transport_*`` and ``tm_continuum_*`` families.
12. ft: the FT-Transformer (run after features, before fleet). The
   family's 3-fold CV over its default grid (18 fits of 200 full-batch
   AdamW steps at d_model 32, 4 heads, 2 layers, d_ff 64) through
   ``OpCrossValidation.dispatch`` at ``bench.py::bench_ft_transformer``'s
   shape (896 x 16 rows from ``--seed``, a label of x0 * x1 + x2), in
   bf16 (the CUDA default) and with TM_FT_BF16=0, then at d_model 128 /
   d_ff 256: wall, fits/s, one AdamW step's device time and device
   operations on a sweep chunk (torch.profiler, two fits' difference),
   the busy share, and the analytic FLOPs and bytes (copies of
   ``bench.py``'s ``_ft_flops`` / ``_ft_bytes``) with the bound at the
   dtype's peak; the bf16 grid's best held-out AUROC within
   FT_BF16_AUROC_TOL of the f32 one's. One fit on the card and on the
   CPU from the same injected draw (TM_FT_BF16=0, TF32 off), the
   probabilities within FT_CPU_ATOL. Titanic through a selector over
   LogisticRegression and FTTransformerClassifier (FT alone as well
   when LR wins, so an FT head is served): save/load and the exported
   artifact's batch scores bitwise, ``LocalScorer`` and
   ``export_portable`` -> ``portable.load`` -> a ``ServingEngine``
   within FT_ROW_ATOL of the batch scores, every
   request on the classic plane (no stack spec, the fallback counted),
   no kernel launched anywhere in the phase.

13. autotune: the learned autotuner on the two kernels' own launch
   choices (the histogram's sort chunk rows and reduce grid cap; the
   fused scorer's rows a block). Every candidate the
   screens admit, at HIST_SHAPES' first four in bf16 and the capture
   shape in exact mode, and at the serving pass's prefix and identity
   shapes and the prefix form at 1,024 and 8,192 rows, must give an
   output ``torch.equal`` to the static launch's; each is timed: a
   histogram candidate by the median of CUDA-event times, a scorer
   candidate by the median device time of a launch in a torch.profiler
   trace (its launch is shorter than the host's call). Both cost
   models are fitted from these measurements alone and saved; with
   ``TM_AUTOTUNE=1`` and the two model paths every case and the
   Titanic helloworld's train run again through the hooks: outputs,
   histograms and CV metrics bitwise the autotune-off run's, one
   dispatch-log entry and one flight-recorder record per distinct
   shape. A bucket ladder proposed from the serving
   storm's observed batch mix is applied through the engine swap, the
   rows rescored after it bitwise. Prints each shape's static, chosen,
   measured-best and predicted ms and whether the choice was the best.

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
#: seconds the host idles inside a profiler session before ``run()``
#: and after its work has ended: the profiler drops a device event whose
#: time, read on the card's clock, falls outside the session's window
#: on the host's, so a session whose first launch came at its very
#: start (or whose last kernel ended at its stop) could lose kernels
PROFILE_PAD_S = 0.05


def profiled(run, host: bool = True):
    """Run ``run()`` under torch.profiler (CUDA activity, and CPU
    activity when ``host``), PROFILE_PAD_S of host idling on each side
    of it inside the session, and return (the profile, run's result). A
    session whose trace holds no device event at all (CUPTI now and
    then delivers an empty one) is repeated, up to PROFILE_ATTEMPTS
    sessions; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(PROFILE_PAD_S)
            result = run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
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


def prefix_inputs(rng, n, C, p, K, L, inf_model=False, device="cuda"):
    """The prefix form's inputs on ``device``: boundary values with 5%
    NaN and column 0 all NaN, the last column the label's zero
    placeholder (which no table reads), tables of filled values and
    null indicators, weights, and model ids with row 0 out of range."""
    dev = torch.device(device)
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


def make_stacked_ir(rng, name: str):
    """A member whose prefix holds a predict stage (model stacking):
    :func:`make_model_ir`'s kept features feed an inner
    LinearRegression, whose score feeds the binary LogisticRegression
    head. The prefix compiler does not know the inner predict, so the
    fused plane serves it on the generic form. Returns (manifest,
    arrays, numpy parameters for :func:`stacked_oracle`)."""
    manifest, arrays, par = make_model_ir(rng, name)
    head = manifest["stages"].pop()
    manifest["stages"].append({
        "out": "inner", "inputs": ["label", "checked"], "op": "predict",
        "family": "LinearRegression", "nClasses": 1})
    head["inputs"] = ["label", "inner"]
    manifest["stages"].append(head)
    k = len(manifest["stages"])
    inner = rng.normal(size=P_KEEP + 1)
    beta = rng.normal(size=2)
    arrays[str(k - 2)] = {"params": {"beta": inner}}
    arrays[str(k - 1)] = {"params": {"beta": beta}}
    return manifest, arrays, dict(par, inner=inner, beta=beta)


def oracle_features(cols, par) -> np.ndarray:
    """The model's f32 head features of one request: impute, null
    indicators, concat, keep."""
    feats = []
    for i in range(N_COLUMNS):
        c = np.asarray(cols[f"x{i}"], np.float32)
        isnull = np.isnan(c)
        feats += [np.where(isnull, np.float32(par["fills"][i]), c),
                  isnull.astype(np.float32)]
    return np.stack(feats, axis=1)[:, par["keep"]]


def _pair(z) -> np.ndarray:
    p1 = 1.0 / (1.0 + np.exp(-z))
    return np.stack([1.0 - p1, p1], axis=1)


def stacked_oracle(cols, par, bf16: bool) -> list:
    """A :func:`make_stacked_ir` member's numpy scores of one request:
    the inner LinearRegression in f64 over the f32 features and f32
    weights, then the head's sigmoid pair. Under the fused plane's bf16
    operands the head's feature (the inner score, an f32 value the card
    computes, which lies within 1e-6 of this one relative to its size
    plus one) and weight round to bf16, the intercept not; where the
    two ends of that interval round apart, either rounding is the
    policy's. Returns the candidate (n, 2) scores (one when f32)."""
    X = oracle_features(cols, par).astype(np.float64)
    w_in = par["inner"].astype(np.float32).astype(np.float64)
    inner = X @ w_in[:-1] + w_in[-1]
    w = par["beta"].astype(np.float32)
    if not bf16:
        return [_pair(inner * float(w[0]) + float(w[1]))]
    slack = 1e-6 * (np.abs(inner) + 1.0)
    w0 = float(round_bf16(w[:1])[0])
    return [_pair(round_bf16(v).astype(np.float64) * w0 + float(w[1]))
            for v in (inner - slack, inner + slack)]


def oracle_probs(cols, par, bf16: bool) -> np.ndarray:
    """The model's numpy score of one request: f32 features
    (:func:`oracle_features`), operands rounded to bf16 when the fused
    kernel's policy does, f64 dot, sigmoid pair."""
    X = oracle_features(cols, par)
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
    out = {"rows": n, "models": N_BACKENDS, "bucket_slices": slices,
           "passes": passes}
    out.update(pass_numbers(one, passes))
    out["device_ops_per_slice"] = out["device_ops_per_pass"] / slices
    return out


def pass_numbers(one, passes: int = PROBE_PASSES) -> dict:
    """Device operations (kernels and copies), device us and host us of
    one serving pass ``one()`` (a zero-argument callable ending in the
    copy out, so the device is done when it returns), on the card. Host
    us is the median wall of one pass; the device numbers come from
    torch.profiler over ``passes`` passes."""
    for _ in range(5):
        one()
    host = []
    for _ in range(passes):
        t0 = time.perf_counter()
        one()
        host.append(time.perf_counter() - t0)
    prof, _ = profiled(lambda: [one() for _ in range(passes)], host=False)
    dev_us, events = _device_time_us(prof)
    return {"passes": passes, "device_ops_per_pass": events / passes,
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
    from transmogrifai_tpu_torch.autotune import observed_mix
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
               stats["requestOverhead"]["segments"].items()},
           # the storm's coalesced batch sizes, for the autotune phase's
           # bucket retune ({batch rows: batches})
           "batch_mix": {str(r): c for r, c in
                         sorted(observed_mix(eng.stats).items())}}
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


def hist_case(tk, label, G, n, d, S, m, B, dtype, seed, timed=True):
    """Kernel vs plain version at one shape, with timings (``timed``
    False: without them and the library yardstick), under knobs that
    make the operand dtype ``dtype``. Returns one result row; raises on
    a disagreement."""
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
    row = {"shape": label, "G": G, "n": n, "d": d, "S": S, "m": m, "B": B,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "integer_stats_bitwise": exact, "deterministic": True,
           "batch_independent": True}
    if not timed:
        return row
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
    row.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               onehot_gemm_gflop=2.0 * G * m * S * d * B * n / 1e9,
               kernel_mma_gflop=cost["mma_flop"] / 1e9, plan=plan)
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


def path_hist_check(shapes, label, seed):
    """The kernel against its plain version at the largest level a train
    gave it (``shapes``: :func:`hist_hook`'s record of that train), in
    the operand mode the train ran in, on seeded inputs of that shape
    (:func:`hist_case` untimed). None when no level was recorded or the
    train ran on the CPU, where the wrapper is the plain version."""
    from transmogrifai_tpu_torch.models import kernels as tk
    if not shapes or not torch.cuda.is_available():
        return None
    G, n, d, S, m, B = max(shapes, key=lambda s: (int(np.prod(s)), s))
    torch.cuda.empty_cache()
    row = hist_case(tk, label, G, n, d, S, m, B,
                    tk.hist_dtype(torch.device("cuda")), seed, timed=False)
    torch.cuda.empty_cache()
    return dict(row, levels=len(shapes), distinct_shapes=len(set(shapes)))


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
def hist_hook(record=None, fault=None, shapes=None):
    """Pass the growers' histogram calls through a hook: where given,
    ``fault(stats, pos, m)`` replaces the stats the kernel sees (a
    planted fault), each level's histogram is appended, on the CPU, to
    ``record``, and each call's shape (G, n, d, S, m, B) to ``shapes``."""
    from transmogrifai_tpu_torch.models import trees
    real = trees.histogram_grid

    def hooked(bins, stats, pos, m, B):
        if fault is not None:
            stats = fault(stats, pos, m)
        if shapes is not None:
            G, n, S = stats.shape
            shapes.append((G, n, bins.shape[1], S, m, B))
        h = real(bins, stats, pos, m, B)
        if record is not None:
            record.append(h.cpu())
        return h
    trees.histogram_grid = hooked
    try:
        yield
    finally:
        trees.histogram_grid = real


def tree_cv(family, X, y, device, knobs, fault=None):
    """The 3-fold selector of one tree ``family`` on (X, y) on
    ``device`` under the environment ``knobs``: its validation result
    (grid, gridMetrics)."""
    with env(**knobs), hist_hook(fault=fault):
        ds, sel = _selector(X, y, [family], device)
        return sel.fit(ds).summary["validationResults"][0]


def tree_side(family, X, y, device, knobs, fault=None):
    """One tree ``family``'s selector on ``device`` under the
    environment ``knobs``: its validation AUROC per grid point, and per
    grid point one fit on all rows with each level's histogram
    recorded."""
    from transmogrifai_tpu_torch import models as TM
    fam = TM.MODEL_FAMILIES[family]
    res = tree_cv(family, X, y, device, knobs, fault)
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


def split_knobs(hyper):
    """(lambda, least child weight, least gain) of a tree grid point:
    the boosted families' knobs, else the single tree's and the
    forest's (whose grower takes lambda 1e-6)."""
    if "regLambda" in hyper:
        return (hyper["regLambda"], hyper["minChildWeight"],
                hyper["minSplitGain"])
    return (1e-6, hyper.get("minInstancesPerNode", 1.0),
            hyper.get("minInfoGain", 0.0))


def _node_gains(hist, node, m, lam, min_w, B):
    """The gain of every (feature, bin) split of ``node``, in f64, from
    one level's (1, m*S, d*B) histogram of C classes (stats g_1..g_C,
    h_1..h_C, w; C = 1 for a boosted logistic tree): the grower's
    formula summed over the classes, -inf where a child would weigh
    under ``min_w``; and each gain's scale, the sum of its terms'
    magnitudes (what f32 rounding of the histogram moves a gain in
    proportion to)."""
    h = hist[0].double()
    d = h.shape[1] // B
    S = h.shape[0] // m
    C = (S - 1) // 2
    cum = h.reshape(m, S, d, B)[node].cumsum(-1)              # (S, d, B)
    GL, HL = cum[:C, :, :-1], cum[C:2 * C, :, :-1]
    WL = cum[2 * C, :, :-1]
    G, H, W = cum[:C, :, -1:], cum[C:2 * C, :, -1:], cum[2 * C, :, -1:]

    def score(g, hh):
        return g * g / (hh + lam + 1e-12)
    left, right, parent = score(GL, HL), score(G - GL, H - HL), score(G, H)
    ok = (WL >= min_w) & (W - WL >= min_w)
    gain = torch.where(ok, (left + right - parent).sum(0),
                       torch.full_like(WL, -np.inf))
    return gain, (left.abs() + right.abs() + parent.abs()).sum(0)


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
    lam, min_w, least_gain = split_knobs(hyper)

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
        gains, scale = _node_gains(h, node, 1 << level, lam, min_w, B)
        # a leaf's "gain" is the least gain, the bar a split must clear
        val = [float(least_gain) if sp is None
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


def tree_compare(family, card, cpu, X):
    """Card side against CPU side (:func:`tree_side`) of one tree
    ``family``: the largest AUROC difference over grid points, and each
    grid point's first divergence with the largest gain gap and
    histogram difference over them."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.models import trees
    fam = TM.MODEL_FAMILIES[family]
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
           "family_wall_s": model.wall_seconds["families"],
           "refit_wall_s": model.wall_seconds["refit"],
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
                                 2, device="cuda")
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
    exact = {"TM_KERNEL_EXACT": "1"}
    t2 = time.perf_counter()
    card = tree_side("GBTClassifier", Xs, ys, device, exact)
    t3 = time.perf_counter()
    cpu = tree_side("GBTClassifier", Xs, ys, "cpu", exact)
    t4 = time.perf_counter()
    gbt = tree_compare("GBTClassifier", card, cpu, Xs)
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
        pending = cv.dispatch_many(entries, X, y, w, k, device=device)
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
        if set(model.wall_seconds["families"]) != set(families):
            raise AssertionError(f"{problem}: families validated "
                                 f"{sorted(model.wall_seconds['families'])}"
                                 f" of {families}")
        out[problem] = {
            "rows": rows, "families": families, "fit_wall_s": wall,
            "family_wall_s": model.wall_seconds["families"],
            "refit_wall_s": model.wall_seconds["refit"],
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
# phase 7b: multi-device on ranks that share one card
# ---------------------------------------------------------------------------

MESH_RANKS = 4
#: the grid meshes the binary default list is fitted on
MESH_GRID_SIZES = (1, 2, 4)
#: the CPU tests' tolerances: sharded statistics against one rank
#: (Spearman's own), the sharded sparse fits against the one-device fit
MESH_STATS_TOL = (1e-4, 1e-5)
MESH_SPEARMAN_TOL = (1e-3, 1e-4)
MESH_SPARSE_TOL = (1e-4, 1e-6)
#: the sharded sparse fits: the CTR phase's widths (2^20 buckets; 26
#: hashed fields and 13 numerics from ctr_chunk), one 1M-row chunk, one
#: epoch at the stream's batch, lazy L2 on (the touched union runs)
MESH_CTR_ROWS = 1_000_000
MESH_CTR_BATCH = 65_536
MESH_CTR_BUCKETS = 1 << 20
MESH_FM_K = 8
MESH_SOFTMAX_CLASSES = 3
MESH_L2 = 1e-6


def _ring_counts(tk):
    return tk.ring_allreduce.launches, tk.ring_allgather.launches


def mesh_stats_part(X, y, device, ranks=MESH_RANKS):
    """``parallel.sharded_statistics`` over ``ranks`` ranks of one device
    against the one-rank ``compute_statistics`` (the CPU tests'
    tolerances) and numpy f64 (``checker_oracle``); the ring's result
    bitwise the plain version's (TM_MESH_RDMA_RING=0); its launches
    those the code derives (2 sums and 2 gathers, one a rank each)."""
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.ops.sanity_checker import compute_statistics
    dev = torch.device(device)
    sync = _sync_of(dev)
    mesh = par.data_mesh([dev] * ranks)
    compute_statistics(X, y, dev)               # warm: both timed warm
    par.sharded_statistics(X, y, mesh)
    sync()
    t0 = time.perf_counter()
    one = compute_statistics(X, y, dev)
    one_wall = time.perf_counter() - t0
    sync()
    tk.ring_allreduce.launches = tk.ring_allgather.launches = 0
    t0 = time.perf_counter()
    ring = par.sharded_statistics(X, y, mesh)
    sync()
    wall = time.perf_counter() - t0
    reduce_n, gather_n = _ring_counts(tk)
    expected = 2 * ranks if dev.type == "cuda" else 0
    if (reduce_n, gather_n) != (expected, expected):
        raise AssertionError(f"sharded_statistics launched the ring "
                             f"{reduce_n} (sum) / {gather_n} (gather) "
                             f"times, the code derives {expected} each")
    with env(TM_MESH_RDMA_RING="0"):
        plain = par.sharded_statistics(X, y, mesh)
    errs = {}
    for k in one:
        if not np.array_equal(ring[k], plain[k], equal_nan=True):
            raise AssertionError(f"sharded statistic {k}: the ring differs "
                                 f"from the plain version")
        rtol, atol = MESH_SPEARMAN_TOL if k == "spearman" else MESH_STATS_TOL
        np.testing.assert_allclose(ring[k], one[k], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=k)
        both = np.isfinite(ring[k]) & np.isfinite(one[k])
        errs[k] = float(np.abs(ring[k] - one[k])[both].max()) \
            if both.any() else 0.0
    return {"rows": int(X.shape[0]), "features": int(X.shape[1]),
            "ranks": ranks, "ring_equals_plain": True,
            "max_abs_err_vs_one_rank": errs,
            "oracle": checker_oracle(X, y, ring, dev),
            "ring_allreduce_launches": reduce_n,
            "ring_allgather_launches": gather_n,
            "expected_launches_each": expected,
            "wall_s": wall, "one_rank_wall_s": one_wall}


def mesh_checker_part(X, y, device, seed, ranks=MESH_RANKS):
    """``SanityChecker(mesh=)`` over ``ranks`` ranks on the statistics'
    matrix with a planted leak (the label plus 1% noise) and a constant
    column: the same drops and kept slots as with no mesh, both planted
    columns dropped."""
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.ops.sanity_checker import SanityChecker
    rng = np.random.default_rng(seed + 7)
    d = X.shape[1]
    leak = (y + 0.01 * rng.normal(size=len(y))).astype(np.float32)
    Xc = np.concatenate([X, np.full((len(y), 1), 2.5, np.float32),
                         leak[:, None]], axis=1)
    ds = Dataset({"y": y.astype(np.float64), "x": Xc},
                 {"y": ft.RealNN, "x": ft.OPVector})
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    sync = _sync_of(device)
    walls, models = {}, {}
    for name, kw in (("no_mesh", {"device": device}),
                     ("mesh", {"mesh": par.data_mesh([device] * ranks)})):
        sync()
        t0 = time.perf_counter()
        models[name] = SanityChecker(**kw).set_input(lbl, vec).fit(ds)
        sync()
        walls[name] = time.perf_counter() - t0
    a, b = models["no_mesh"], models["mesh"]
    if (a.summary["dropped"] != b.summary["dropped"]
            or a.params["keep_indices"] != b.params["keep_indices"]):
        raise AssertionError(f"SanityChecker(mesh=) drops "
                             f"{b.summary['dropped']}, no mesh "
                             f"{a.summary['dropped']}")
    keep = b.params["keep_indices"]
    if d in keep or d + 1 in keep:
        raise AssertionError(f"the planted constant ({d}) or leak "
                             f"({d + 1}) column was kept")
    return {"features_in": d + 2, "dropped": b.summary["dropped"],
            "kept": len(keep), "drops_equal": True,
            "wall_s": walls["mesh"], "no_mesh_wall_s": walls["no_mesh"]}


def _event_ms(fit, device):
    """(result, host wall s, CUDA-event ms) of one fit; ms None off the
    card."""
    sync = _sync_of(device)
    cuda = torch.device(device).type == "cuda"
    sync()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = fit()
    sync()
    wall = time.perf_counter() - t0
    if not cuda:
        return out, wall, None
    end.record()
    end.synchronize()
    return out, wall, start.elapsed_time(end)


def _step_ms(fit1, fit3, device, steps, repeats=2):
    """Device ms a step of a fit: its 3-epoch fit's CUDA-event time less
    its 1-epoch fit's, over the 2 x ``steps`` steps between them (the
    chunk's upload and the setup drop out), each the least of
    ``repeats`` warm runs."""
    one = min(_event_ms(fit1, device)[2] for _ in range(repeats))
    three = min(_event_ms(fit3, device)[2] for _ in range(repeats))
    return (three - one) / (2 * steps)


def mesh_sparse_part(seed, device, ranks=MESH_RANKS, rows=MESH_CTR_ROWS,
                     batch=MESH_CTR_BATCH, buckets=MESH_CTR_BUCKETS):
    """The sharded LR, FM (k = 8) and 3-class softmax fits over ``ranks``
    ranks at the CTR widths on one chunk, one epoch: each held to the
    one-device fit (MESH_SPARSE_TOL) and the ring's bitwise the plain
    version's; the ring launched once a rank a step (steps x epochs x
    ranks x 1 call); the fit's wall beside the one-device fit's; on the
    card the ms a step of each (``_step_ms``) and the ring's device ms a
    step (torch.profiler, the union of the ranks'
    kernels) beside its bound (``ring_cost`` at the step's buffer)."""
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.models import sparse as TS
    dev = torch.device(device)
    c = ctr_chunk(seed, rows, buckets)
    idx, num, y, w = c["idx"], c["num"], c["y"], c["w"]
    y3 = ((idx[:, 0] % 7 < 3).astype(np.int64)
          + (num[:, 0] > 0.5)).astype(np.float32)
    mesh = par.data_mesh([dev] * ranks)
    steps = -(-rows // batch)

    def fits(fam, epochs=1):
        kw = dict(lr=0.05, l2=MESH_L2, epochs=epochs, batch_size=batch)
        if fam == "lr":
            return (lambda: TS.fit_sparse_lr(idx, num, y, w, buckets,
                                             device=dev, **kw),
                    lambda: TS.fit_sparse_lr_sharded(idx, num, y, w,
                                                     buckets, mesh=mesh,
                                                     **kw))
        if fam == "fm":
            return (lambda: TS.fit_sparse_fm(idx, num, y, w, buckets,
                                             k=MESH_FM_K, seed=seed,
                                             device=dev, **kw),
                    lambda: TS.fit_sparse_fm_sharded(
                        idx, num, y, w, buckets, mesh=mesh, k=MESH_FM_K,
                        seed=seed, **kw))
        return (lambda: TS.fit_sparse_softmax(
                    idx, num, y3, w, buckets, MESH_SOFTMAX_CLASSES,
                    device=dev, **kw),
                lambda: TS.fit_sparse_softmax_sharded(
                    idx, num, y3, w, buckets, MESH_SOFTMAX_CLASSES,
                    mesh=mesh, **kw))

    d = num.shape[1]
    numel = {"lr": 1 + buckets + d + 1,
             "fm": 1 + buckets * (1 + MESH_FM_K) + d + 1,
             "softmax": 1 + MESH_SOFTMAX_CLASSES * (buckets + d + 1)}
    out = {"rows": rows, "batch": batch, "steps": steps, "epochs": 1,
           "ranks": ranks, "buckets": buckets, "fields": int(idx.shape[1]),
           "numerics": d, "families": {}}
    cuda = dev.type == "cuda"
    for fam in ("lr", "fm", "softmax"):
        single_fit, sharded_fit = fits(fam)
        single, s_wall, s_ms = _event_ms(single_fit, dev)
        tk.ring_allreduce.launches = 0
        ring, r_wall, r_ms = _event_ms(sharded_fit, dev)
        launches = tk.ring_allreduce.launches
        expected = steps * 1 * ranks * 1 if cuda else 0
        if launches != expected:
            raise AssertionError(f"sharded {fam}: {launches} ring "
                                 f"launches, the code derives {expected} "
                                 f"({steps} steps x 1 epoch x {ranks} "
                                 f"ranks x 1 call)")
        with env(TM_MESH_RDMA_RING="0"):
            plain = sharded_fit()
        err = 0.0
        for k in single:
            if not np.array_equal(ring[k], plain[k]):
                raise AssertionError(f"sharded {fam} {k}: the ring differs "
                                     f"from the plain version")
            np.testing.assert_allclose(
                ring[k], single[k], rtol=MESH_SPARSE_TOL[0],
                atol=MESH_SPARSE_TOL[1],
                err_msg=f"sharded {fam} {k} against the one-device fit")
            err = max(err, float(np.abs(ring[k] - single[k]).max()))
        n_el = numel[fam] + (buckets if MESH_L2 else 0)
        cost = tk.ring_cost(ranks, n_el, same_card=True)
        row = {"max_abs_err": err, "ring_equals_plain": True,
               "ring_launches": launches, "expected_ring_launches": expected,
               "wall_s": r_wall, "single_wall_s": s_wall,
               "step_buffer_floats": n_el,
               "ring_bound_ms": cost["bound_ms"],
               "ring_bound_by": cost["bound_by"]}
        if cuda:
            row["step_ms"] = _step_ms(fits(fam, 1)[1], fits(fam, 3)[1],
                                      dev, steps)
            row["single_step_ms"] = _step_ms(fits(fam, 1)[0],
                                             fits(fam, 3)[0], dev, steps)
            prof, _ = profiled(sharded_fit, host=False)
            row["ring_step_ms"] = _kernel_span_ms(prof, "ring_kernel", steps)
        out["families"][fam] = row
    return out


def mesh_grid_part(seed, device, rows=TRAIN_ROWS, sizes=MESH_GRID_SIZES,
                   candidates=None):
    """The binary default list (``candidates`` None) at ``rows`` rows of
    the training phase's data through ``set_mesh(get_mesh([device] *
    k))`` for each k in ``sizes``: grid metrics and winner bitwise the
    first size's; per-rank items (``SWEEP_STATS``) summing to the real
    items; histogram launches those the code derives: each rank grows
    every level of its shard (padded shards are never empty), so k x the
    folded levels, plus the winner's refit; the wall at each size."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.profiling import SWEEP_STATS, SweepStats
    dev = torch.device(device)
    sync = _sync_of(dev)
    X, y = training_data(seed, rows)
    cuda = dev.type == "cuda"
    runs = {}
    for k in sizes:
        ds, sel = _selector(X, y, candidates, dev)
        sel.set_mesh(par.get_mesh([dev] * k))
        sync()
        tk.histogram_grid.launches = 0
        before = SWEEP_STATS.snapshot()
        t0 = time.perf_counter()
        model = sel.fit(ds)
        sync()
        wall = time.perf_counter() - t0
        launches = tk.histogram_grid.launches
        delta = SweepStats.delta(before, SWEEP_STATS.snapshot())
        summ = model.summary
        families = [name for name, _ in sel.params["candidates"]]
        tree = [f for f in families
                if hasattr(TM.MODEL_FAMILIES[f], "levels_per_fit")]
        winner = summ["bestModel"]["family"]
        refit = (TM.MODEL_FAMILIES[winner].levels_per_fit()
                 if winner in tree else 0)
        folded = sum(TM.MODEL_FAMILIES[f].levels_per_fit() for f in tree)
        expected = k * folded + refit if cuda else 0
        if launches != expected:
            raise AssertionError(f"{k} ranks: {launches} histogram "
                                 f"launches, the code derives {expected} "
                                 f"({k} x {folded} folded levels + "
                                 f"{refit} refit)")
        items = {lab: c["items"] for lab, c in delta["devices"].items()}
        real = sum(3 * len(r["grid"]) for r in summ["validationResults"])
        if sum(items.values()) != real:
            raise AssertionError(f"{k} ranks: rank items {items} do not "
                                 f"sum to the {real} real items")
        runs[k] = {"wall_s": wall, "histogram_launches": launches,
                   "expected_launches": expected,
                   "one_rank_levels": folded + refit, "items": items,
                   "winner": winner, "grid": _grid_metrics(summ)}
    base = runs[sizes[0]]
    for k in sizes[1:]:
        if runs[k]["grid"] != base["grid"] or \
                runs[k]["winner"] != base["winner"]:
            raise AssertionError(f"grid metrics or winner on {k} ranks "
                                 f"differ from {sizes[0]} rank(s)")
    return {"rows": rows, "sizes": list(sizes), "winner": base["winner"],
            "grid_bitwise": True,
            "runs": {str(k): {key: v for key, v in r.items()
                              if key != "grid"} for k, r in runs.items()}}


def mesh_phase(seed: int, device="cuda", rows: int = TRAIN_ROWS,
               ranks: int = MESH_RANKS, ctr_rows: int = MESH_CTR_ROWS,
               ctr_batch: int = MESH_CTR_BATCH,
               buckets: int = MESH_CTR_BUCKETS,
               sizes=MESH_GRID_SIZES, list_rows: int = TRAIN_ROWS,
               candidates=None):
    """Multi-device on ranks that share ``device``: the sharded
    statistics and SanityChecker(mesh=), the sharded sparse fits and the
    selector's grid sharding (the smaller sizes exist for a CPU
    rehearsal)."""
    t0 = time.perf_counter()
    X, y = training_data(seed, rows)
    out = {"stats": mesh_stats_part(X, y, device, ranks)}
    out["checker"] = mesh_checker_part(X, y, device, seed, ranks)
    out["sparse"] = mesh_sparse_part(seed, device, ranks, ctr_rows,
                                     ctr_batch, buckets)
    out["grid"] = mesh_grid_part(seed, device, list_rows, sizes, candidates)
    out["ring_allreduce_launches"] = (
        out["stats"]["ring_allreduce_launches"]
        + sum(f["ring_launches"] for f in out["sparse"]["families"].values()))
    out["ring_allgather_launches"] = out["stats"]["ring_allgather_launches"]
    out["histogram_launches"] = sum(
        r["histogram_launches"] for r in out["grid"]["runs"].values())
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 7c: the 2-D grid x data mesh and the multi-process launch
# ---------------------------------------------------------------------------

#: the 2-D mesh: grid rows x data ranks, every rank on the card
MESH2D_GRID = 2
MESH2D_DATA = 2
#: the 2-D CV metrics against the one-rank fit (the CPU tests'
#: tolerances): row sharding moves the linear fits' row sums, and the
#: boosted trees' non-integer gradient sums may part a split
MESH2D_LINEAR_TOL = (1e-4, 1e-6)
MESH2D_TREE_ATOL = 1e-2
#: tree families whose stats are integer-valued at unit weights (class
#: one-hots, bootstrap counts): their histograms and so their trees and
#: metrics are bitwise at any sharding
MESH2D_BITWISE = ("DecisionTreeClassifier", "RandomForestClassifier")
#: the sketch at the tree families' bin count
MESH2D_BINS = 32
#: one GBT level's histogram (G = 12 instances, m = 16 nodes, S = 3,
#: d = 28, B = 32) exchanged by each grid row with integer-valued parts
MESH2D_RING_SHAPE = (12, 16 * 3, 28 * 32)
#: the multi-process phase: processes x data ranks on the card, the LR +
#: GBT list through WorkflowRunner TRAIN with OpParams.distributed
MULTIHOST_PROCS = 2
MULTIHOST_RANKS = 2
MULTIHOST_CANDIDATES = [["LogisticRegression", None],
                        ["GBTClassifier", None]]
MULTIHOST_TIMEOUT_S = 300.0


def _indexed(dev) -> torch.device:
    """``dev`` with its card's index (``cuda`` -> ``cuda:<current>``), as
    ``parallel.mesh.visible_devices`` names cards: the ranks' labels then
    read ``cuda:0#r``."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def _ranks_on(dev, k: int):
    """For the block, ``TM_MESH_AXIS=grid,data`` and a device pool of k
    ranks that share ``dev`` (``parallel.mesh.visible_devices``, which
    every default mesh draws from), so the default mesh is a grid x data
    mesh on one card."""
    from transmogrifai_tpu_torch.parallel import mesh as tmesh
    real = tmesh.visible_devices
    tmesh.visible_devices = lambda: [_indexed(dev)] * k
    try:
        with env(TM_MESH_AXIS="grid,data"):
            yield
    finally:
        tmesh.visible_devices = real


def mesh2d_sketch_part(X, device, data=MESH2D_DATA, bins=MESH2D_BINS):
    """``trees.quantile_bin_edges`` with the rows sharded over ``data``
    ranks of the card (``parallel.spmd.run_ranks``; every fifth row at
    weight 0, a column with NaNs) against the unsharded call: bitwise on
    every rank, and the ring's gather launched once a rank."""
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.models import trees as TT
    from transmogrifai_tpu_torch.parallel import spmd
    dev = torch.device(device)
    sync = _sync_of(dev)
    X = X.copy()
    X[::7, 3] = np.nan
    n = X.shape[0]
    w = (np.arange(n) % 5 != 0).astype(np.float32)
    one = TT.quantile_bin_edges(torch.from_numpy(X).to(dev), bins,
                                torch.from_numpy(w).to(dev)).cpu()
    mesh = par.data_mesh([dev] * data)
    xs, ws = par.shard_rows(X, mesh), par.shard_rows(w, mesh)
    sync()
    tk.ring_allreduce.launches = tk.ring_allgather.launches = 0
    t0 = time.perf_counter()
    edges = spmd.run_ranks(
        mesh, lambda r: TT.quantile_bin_edges(xs[r], bins, ws[r]), n)
    sync()
    wall = time.perf_counter() - t0
    gathers = tk.ring_allgather.launches
    for r, e in enumerate(edges):
        if not torch.equal(e.cpu(), one):
            raise AssertionError(f"sketch on rank {r} of {data}: edges "
                                 f"differ from the unsharded call's")
    expected = data if dev.type == "cuda" else 0
    if gathers != expected:
        raise AssertionError(f"sharded sketch: {gathers} gather launches, "
                             f"the code derives {expected}")
    return {"rows": n, "ranks": data, "bins": bins, "bitwise": True,
            "ring_allgather_launches": gathers, "wall_s": wall}


def mesh2d_ring_part(device, seed, grid=MESH2D_GRID, data=MESH2D_DATA,
                     shape=MESH2D_RING_SHAPE):
    """The exchange of each grid row of a grid x data mesh on the card,
    both launched before either is read (two in flight: the ring chains
    them on the card), integer-valued parts at one GBT level's shape:
    every rank's sum bitwise the plain version's, no trap."""
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.models import kernels as tk
    dev = torch.device(device)
    sync = _sync_of(dev)
    mesh = par.get_mesh_2d([dev] * (grid * data), grid_size=grid)
    rng = np.random.default_rng(seed)
    parts = [[torch.from_numpy(rng.integers(-64, 64, size=shape)
                               .astype(np.float32)).to(dev)
              for _ in range(data)] for _ in range(grid)]
    sync()
    before = tk.ring_allreduce.launches
    t0 = time.perf_counter()
    outs = [tk.ring_allreduce(p, row) for p, row in zip(parts, mesh.rows)]
    for row in mesh.rows:
        row.join(*(o for out in outs for o in out))
    sync()
    wall = time.perf_counter() - t0
    launches = tk.ring_allreduce.launches - before
    for i, (p, out) in enumerate(zip(parts, outs)):
        for r, (o, want) in enumerate(zip(out, tk.ring_allreduce_torch(p))):
            if not torch.equal(o, want):
                raise AssertionError(f"grid row {i} rank {r}: the ring's "
                                     f"sum differs from the plain one")
    expected = grid * data if dev.type == "cuda" else 0
    if launches != expected:
        raise AssertionError(f"two rows' exchanges launched the ring "
                             f"{launches} times, not {expected}")
    return {"shape": list(shape), "grid": grid, "data": data,
            "ring_equals_plain": True, "launches": launches,
            "wall_s": wall}


def _family_gaps(summ, base):
    """Per family the largest |gap| of the CV metrics between two
    selector summaries."""
    a, b = _grid_metrics(summ), _grid_metrics(base)
    return {f: float(np.max(np.abs(np.asarray(a[f]) - np.asarray(b[f]))))
            for f in b}


def _hold_cv(label, summ, base):
    """A sharded fit's CV metrics against the one-rank fit's: linear
    families within MESH2D_LINEAR_TOL, DT and RF bitwise, the boosted
    trees within MESH2D_TREE_ATOL, the same winner."""
    from transmogrifai_tpu_torch import models as TM
    a, b = _grid_metrics(summ), _grid_metrics(base)
    for fam, want in b.items():
        got = np.asarray(a[fam])
        want = np.asarray(want)
        if fam in MESH2D_BITWISE:
            if not np.array_equal(got, want):
                raise AssertionError(f"{label}: {fam}'s CV metrics are not "
                                     f"bitwise the one-rank fit's")
        elif hasattr(TM.MODEL_FAMILIES[fam], "levels_per_fit"):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=MESH2D_TREE_ATOL,
                                       err_msg=f"{label}: {fam}")
        else:
            rtol, atol = MESH2D_LINEAR_TOL
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f"{label}: {fam}")
    if summ["bestModel"]["family"] != base["bestModel"]["family"]:
        raise AssertionError(f"{label}: winner {summ['bestModel']['family']}"
                             f", the one-rank fit's "
                             f"{base['bestModel']['family']}")


def _one_rank_fit(X, y, candidates, dev):
    """The selector on one rank (``get_mesh([dev])``): (summary, wall)."""
    from transmogrifai_tpu_torch import parallel as par
    sync = _sync_of(dev)
    ds, sel = _selector(X, y, candidates, dev)
    sel.set_mesh(par.get_mesh([dev]))
    sync()
    t0 = time.perf_counter()
    model = sel.fit(ds)
    sync()
    return model.summary, time.perf_counter() - t0


def mesh2d_list_part(seed, device, rows=TRAIN_ROWS, candidates=None,
                     grid=MESH2D_GRID, data=MESH2D_DATA):
    """The binary default list (``candidates`` None) at ``rows`` rows on
    a grid x data mesh of the card's ranks (``TM_MESH_AXIS=grid,data``
    over a pool of grid x data ranks on the card, :func:`_ranks_on`; the
    selector takes ``default_mesh()`` on its own on the card) against the one-rank fit (:func:`_hold_cv`);
    histogram launches those the code derives (every rank of every grid
    row grows every level of its row's shard: grid x data x the folded
    levels, plus the winner's refit on one device); the ring's launches;
    every rank attributed, the labels the 2-D runners'; the wall."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.profiling import SWEEP_STATS, SweepStats
    dev = torch.device(device)
    sync = _sync_of(dev)
    cuda = dev.type == "cuda"
    X, y = training_data(seed, rows)
    base, one_wall = _one_rank_fit(X, y, candidates, dev)
    with _ranks_on(dev, grid * data):
        mesh = par.default_mesh()
        if mesh.shape != {"grid": grid, "data": data}:
            raise AssertionError(f"the default mesh is {mesh.shape}")
        ds, sel = _selector(X, y, candidates, dev)
        if not cuda:                # the CPU resolves no default mesh
            sel.set_mesh(mesh)
        sync()
        tk.histogram_grid.launches = 0
        tk.ring_allreduce.launches = tk.ring_allgather.launches = 0
        before = SWEEP_STATS.snapshot()
        t0 = time.perf_counter()
        model = sel.fit(ds)
        sync()
        wall = time.perf_counter() - t0
    hist = tk.histogram_grid.launches
    reduce_n, gather_n = _ring_counts(tk)
    delta = SweepStats.delta(before, SWEEP_STATS.snapshot())
    summ = model.summary
    _hold_cv("grid x data", summ, base)
    families = [name for name, _ in sel.params["candidates"]]
    tree = [f for f in families
            if hasattr(TM.MODEL_FAMILIES[f], "levels_per_fit")]
    winner = summ["bestModel"]["family"]
    refit = (TM.MODEL_FAMILIES[winner].levels_per_fit()
             if winner in tree else 0)
    folded = sum(TM.MODEL_FAMILIES[f].levels_per_fit() for f in tree)
    expected = grid * data * folded + refit if cuda else 0
    if hist != expected:
        raise AssertionError(f"grid x data: {hist} histogram launches, the "
                             f"code derives {expected} ({grid} x {data} x "
                             f"{folded} folded levels + {refit} refit)")
    if cuda and not (reduce_n and gather_n):
        raise AssertionError(f"grid x data: the ring launched {reduce_n} "
                             f"sums and {gather_n} gathers")
    labels = mesh.labels()
    if cuda and not all("#" in lab for lab in labels):
        raise AssertionError(f"ranks sharing the card are labelled "
                             f"{labels}, not cuda:N#r")
    if sorted(delta["devices"]) != sorted(labels):
        raise AssertionError(f"attributed ranks {sorted(delta['devices'])} "
                             f"are not the mesh's {labels}")
    progs = sorted(delta["programs"])
    if not all(p.endswith("/2d") or p.startswith("folded2d/")
               for p in progs):
        raise AssertionError(f"grid x data dispatched {progs}, not the "
                             f"2-D runners")
    items = {lab: c["items"] for lab, c in delta["devices"].items()}
    real = sum(3 * len(r["grid"]) for r in summ["validationResults"])
    if sum(items.values()) != data * real:
        raise AssertionError(f"rank items {items} do not sum to {data} x "
                             f"the {real} real items")
    return {"rows": rows, "grid": grid, "data": data, "labels": labels,
            "winner": winner, "one_rank_wall_s": one_wall, "wall_s": wall,
            "histogram_launches": hist, "expected_histogram": expected,
            "ring_allreduce_launches": reduce_n,
            "ring_allgather_launches": gather_n, "items": items,
            "programs": progs, "max_gap": _family_gaps(summ, base)}


def mesh2d_phase(seed: int, device="cuda", rows: int = TRAIN_ROWS,
                 candidates=None, grid=MESH2D_GRID, data=MESH2D_DATA):
    """The 2-D grid x data mesh on ranks that share ``device``."""
    t0 = time.perf_counter()
    X, _ = training_data(seed, rows)
    out = {"sketch": mesh2d_sketch_part(X, device, data),
           "ring": mesh2d_ring_part(device, seed, grid, data),
           "list": mesh2d_list_part(seed, device, rows, candidates, grid,
                                    data)}
    # the main path's counts: the selector's fit alone (the sketch's and
    # the ring's own checks keep theirs in their parts)
    for k in ("histogram_launches", "ring_allreduce_launches",
              "ring_allgather_launches"):
        out[k] = out["list"][k]
    out["wall_s"] = time.perf_counter() - t0
    return out


def multihost_worker(argv=None) -> int:
    """One process of the multi-process phase (``python -c "import
    chip_smoke; chip_smoke.multihost_worker()" ADDR PID PROCS ROWS SEED
    DEVICE RANKS``): the selector over MULTIHOST_CANDIDATES through
    ``WorkflowRunner`` TRAIN with ``OpParams.distributed``, this
    process's device pool RANKS ranks on DEVICE; on the card the
    selector takes the default mesh, which in a multi-process world
    under ``TM_MESH_AXIS=grid,data`` (the parent sets it) is the hybrid
    mesh, processes x this process's data ranks. Prints one
    ``multihost-result:`` JSON line."""
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.parallel import multihost
    from transmogrifai_tpu_torch.runner import (OpParams, RunType,
                                                WorkflowRunner)
    from transmogrifai_tpu_torch.workflow import Workflow
    addr, pid, procs, rows, seed, device, ranks = (argv or sys.argv[1:])[:7]
    pid, procs, rows, seed = int(pid), int(procs), int(rows), int(seed)
    dev = torch.device(device)
    par.mesh.visible_devices = lambda: [_indexed(dev)] * int(ranks)
    sync = _sync_of(dev)
    dist = {"coordinatorAddress": addr, "numProcesses": procs,
            "processId": pid}
    X, y = training_data(seed, rows)
    ds, sel = _selector(X, y, MULTIHOST_CANDIDATES, dev)
    if dev.type != "cuda":
        # the CPU resolves no default mesh: join first and set it (the
        # runner's own join is then the idempotent second call)
        multihost.initialize_distributed(addr, procs, pid)
        sel.set_mesh(par.default_mesh())
    runner = WorkflowRunner(Workflow([sel.output]), train_reader=ds,
                            device=dev)
    tk.histogram_grid.launches = 0
    tk.ring_allreduce.launches = tk.ring_allgather.launches = 0
    t0 = time.perf_counter()
    res = runner.run(RunType.TRAIN, OpParams(distributed=dist))
    sync()
    wall = time.perf_counter() - t0
    mesh = par.default_mesh()
    summ = runner._model.selected_model().summary
    print("multihost-result: " + json.dumps({
        "pid": pid, "info": multihost.process_info(),
        "mesh": {"axes": list(mesh.axis_names), "shape": mesh.shape,
                 "labels": mesh.labels(), "local_rows": mesh.local_rows},
        "winner": res["bestModel"]["family"], "summary": {
            "bestModel": summ["bestModel"],
            "validationResults": summ["validationResults"]},
        "histogram_launches": tk.histogram_grid.launches,
        "ring_allreduce_launches": tk.ring_allreduce.launches,
        "ring_allgather_launches": tk.ring_allgather.launches,
        "wall_s": wall}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_phase(seed: int, device="cuda", rows: int = TRAIN_ROWS,
                    procs=MULTIHOST_PROCS, ranks=MULTIHOST_RANKS,
                    timeout_s=MULTIHOST_TIMEOUT_S, worker_env=None):
    """Two processes on the card joined by a localhost coordinator
    (``gloo``), each with a pool of ``ranks`` data ranks on the card,
    fit the LR + GBT list at ``rows`` rows through ``WorkflowRunner`` TRAIN with
    ``OpParams.distributed``: every process exits 0 within ``timeout_s``
    (a failure or a timeout in either fails the phase), the processes
    report the same CV metrics and winner, within the 2-D tolerances
    (:func:`_hold_cv`) of the one-process, one-rank fit; each process's
    histogram launches those the code derives (its grid row's ranks
    each grow every GBT level of the row's shard, plus its own refit of
    a tree winner)."""
    from transmogrifai_tpu_torch import models as TM
    dev = torch.device(device)
    t0 = time.perf_counter()
    X, y = training_data(seed, rows)
    base, one_wall = _one_rank_fit(X, y, MULTIHOST_CANDIDATES, dev)
    addr = f"127.0.0.1:{_free_port()}"
    root = _repo_file()
    wenv = {k: v for k, v in os.environ.items() if k != "TM_MESH_DEVICES"}
    wenv["TM_MESH_AXIS"] = "grid,data"
    wenv.update(worker_env or {})
    wenv["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in wenv.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.multihost_worker(sys.argv[1:]))")
    workers = [subprocess.Popen(
        [sys.executable, "-c", code, addr, str(p), str(procs), str(rows),
         str(seed), str(dev), str(ranks)], cwd=root, env=wenv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for p in range(procs)]
    outs = []
    try:
        deadline = time.monotonic() + timeout_s
        for w in workers:
            out, _ = w.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a multihost worker ran past {timeout_s} s")
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    results = []
    for p, (w, out) in enumerate(zip(workers, outs)):
        if w.returncode != 0:
            raise AssertionError(f"multihost worker {p} exited "
                                 f"{w.returncode}:\n{out[-3000:]}")
        line = [ln for ln in out.splitlines()
                if ln.startswith("multihost-result: ")]
        if not line:
            raise AssertionError(f"worker {p} printed no result:\n"
                                 f"{out[-3000:]}")
        results.append(json.loads(line[-1].split(": ", 1)[1]))
    first = results[0]
    for r in results:
        if r["mesh"]["shape"] != {"dcn_grid": procs, "data": ranks}:
            raise AssertionError(f"process {r['pid']}'s mesh is "
                                 f"{r['mesh']}")
        if r["info"]["num_processes"] != procs:
            raise AssertionError(f"process {r['pid']}: {r['info']}")
        if (_grid_metrics(r["summary"]) != _grid_metrics(first["summary"])
                or r["winner"] != first["winner"]):
            raise AssertionError("the processes report different CV "
                                 "metrics or winners")
        _hold_cv(f"process {r['pid']}", r["summary"], base)
    tree = [f for f, _ in MULTIHOST_CANDIDATES
            if hasattr(TM.MODEL_FAMILIES[f], "levels_per_fit")]
    folded = sum(TM.MODEL_FAMILIES[f].levels_per_fit() for f in tree)
    refit = (TM.MODEL_FAMILIES[first["winner"]].levels_per_fit()
             if first["winner"] in tree else 0)
    expected = ranks * folded + refit if dev.type == "cuda" else 0
    for r in results:
        if r["histogram_launches"] != expected:
            raise AssertionError(
                f"process {r['pid']}: {r['histogram_launches']} histogram "
                f"launches, the code derives {expected} ({ranks} x "
                f"{folded} folded levels + {refit} refit)")
    return {"rows": rows, "processes": procs, "ranks": ranks,
            "winner": first["winner"], "one_process_wall_s": one_wall,
            "max_gap": _family_gaps(first["summary"], base),
            "workers": [{k: r[k] for k in (
                "pid", "mesh", "info", "histogram_launches",
                "ring_allreduce_launches", "ring_allgather_launches",
                "wall_s")} for r in results],
            "histogram_launches": sum(r["histogram_launches"]
                                      for r in results),
            "ring_allreduce_launches": sum(r["ring_allreduce_launches"]
                                           for r in results),
            "ring_allgather_launches": sum(r["ring_allgather_launches"]
                                           for r in results),
            "wall_s": time.perf_counter() - t0}


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


def _titanic_workflow(candidates=None, checker=True):
    """examples/op_titanic_simple.py's workflow from the port's classes:
    typed columns, transmogrify, SanityChecker (unless ``checker`` is
    False), the binary selector with 3-fold CV over its candidates (or
    ``candidates``)."""
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
    checked = transmogrify(preds)
    if checker:
        checked = SanityChecker().set_input(survived, checked).output
    pred = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=3, candidates=candidates or TITANIC_CANDIDATES).set_input(
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
    analysis on the card's checked matrix (:func:`tree_near_ties`), the
    same winner unless RF is
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
        X, y = checked_matrix(card, reader, "survived")
        fam = "GBTClassifier"
        gbt = tree_near_ties(fam, X, y, device, "Titanic",
                             held=[("card", X, gm_card[fam]),
                                   ("cpu", X, gm_cpu[fam])])
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


def checked_matrix(model, data, label):
    """(the checker's output matrix of ``model`` on ``data``, the label
    column), f32 numpy."""
    full = model.transform(data)
    X = np.ascontiguousarray(full.column(_checker_of(model).output.name),
                             np.float32)
    return X, np.asarray(full.column(label), np.float32)


def tree_near_ties(family, X, y, device, what, held=()):
    """One tree ``family``'s selector in exact mode on (X, y), on
    ``device`` and on the CPU, each grid point refit with its histograms
    recorded: the AUROC per grid point within TITANIC_CV_ATOL, or else
    the trees may part only at a near tie (GBT_GAP_RTOL, GBT_HIST_RTOL)
    and the AUROC within GBT_PARITY_TOL. ``held``: (side, matrix,
    metrics) triples, a workflow's own CV metrics of ``family`` that the
    selector on that side ("card": ``device``; "cpu") must give again,
    exactly, on ``matrix``. Returns the comparison."""
    knobs = {"TM_KERNEL_EXACT": "1"}
    sides = {"card": tree_side(family, X, y, device, knobs),
             "cpu": tree_side(family, X, y, "cpu", knobs)}
    for side, Xh, want in held:
        got = (sides[side]["metrics"] if np.array_equal(Xh, X)
               else tree_cv(family, Xh, y, device if side == "card"
                            else "cpu", knobs)["gridMetrics"])
        if list(got) != list(want):
            raise AssertionError(f"{what} {family} metrics recomputed on "
                                 f"the {side} differ from the workflow's")
    cmp = tree_compare(family, sides["card"], sides["cpu"], X)
    if not (cmp["metric_max_diff"] <= TITANIC_CV_ATOL
            or (cmp["gain_gap_max"] <= GBT_GAP_RTOL
                and cmp["hist_diff_max"] <= GBT_HIST_RTOL
                and cmp["metric_max_diff"] <= GBT_PARITY_TOL)):
        raise AssertionError(
            f"{what} {family} card vs CPU parts at a split that is no "
            f"near tie or past {GBT_PARITY_TOL}: gain gap "
            f"{cmp['gain_gap_max']}, histograms {cmp['hist_diff_max']}, "
            f"AUROC {cmp['metric_max_diff']}: {cmp['divergence']}")
    return {k: cmp[k] for k in ("metric_max_diff", "gain_gap_max",
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
                model.selected_model().wall_seconds["families"],
            "holdout_auroc": summ["holdoutEvaluation"].get("AuROC"),
            "histogram_launches": launches, "expected_launches": expected,
            "loaded_scores_bitwise": True, "local_max_abs_err": local_err,
            "checker_oracle": oracle}


def fused_storm(reg, reqs, device) -> dict:
    """Serve ``reqs`` ([(model id, request columns)]) from THREADS
    client threads through one ServingEngine over ``reg`` with the fused
    plane on, every request traced. Gates: no fused fallback, no failed
    request, at least one fused batch, and on CUDA the kernel launched
    once a fused bucket slice the spans show (launches counted over the
    storm alone). Returns the results, each request's plane and the
    engine's numbers."""
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.profiling import percentile_nearest_rank
    from transmogrifai_tpu_torch.serving import EngineConfig, ServingEngine
    from transmogrifai_tpu_torch.telemetry.spans import TRACER
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
    if stats["fused_fallbacks"] != 0 or stats["failed"] != 0:
        raise AssertionError(f"engine fallbacks {stats['fused_fallbacks']}"
                             f", failed {stats['failed']}")
    if stats["fused_batches"] <= 0:
        raise AssertionError("the models never rode the fused plane")
    slices = sum(max(1, -(-s["attrs"]["rows"] // BUCKETS[-1]))
                 for s in fused_spans)
    if torch.device(device).type == "cuda" and moved != slices:
        raise AssertionError(f"the fused kernel launched {moved} times for "
                             f"{slices} fused bucket slices")
    lat_ms = sorted(x * 1e3 for x in lat)
    return {"results": results, "planes": [plane[t] for t in traces],
            "wall_s": wall,
            "p50_ms": percentile_nearest_rank(lat_ms, 0.50),
            "p99_ms": percentile_nearest_rank(lat_ms, 0.99),
            "fused_batches": stats["fused_batches"],
            "fused_requests": stats["fused_requests"],
            "fused_fallbacks": stats["fused_fallbacks"],
            "failed": stats["failed"],
            "kernel_launches": moved, "fused_slices": slices}


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
    from transmogrifai_tpu_torch.serving import ModelRegistry
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
    st = fused_storm(reg, reqs, device)
    bf16 = sk.serve_dtype(device) == torch.bfloat16
    matched = {"fused": 0, "classic": 0}
    worst = 0.0
    for (mname, data), res, how in zip(reqs, st["results"], st["planes"]):
        wm = models[mname]
        sel = wm.selected_model()
        recs = [{c: (None if np.isnan(data[c][i]) else
                     (bool(data[c][i]) if types[c].__name__ == "Binary"
                      else float(data[c][i]))) for c in cols}
                for i in range(len(data[cols[0]]))]
        full = wm.transform(recs)
        if how == "fused" and bf16:
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
                                 f"{how} plane differs from its "
                                 f"WorkflowModel by {err}")
        matched[how] += 1
    return {"models": EXPORT_MODELS, "requests": requests,
            "rows": sum(len(d["crim"]) for _, d in reqs),
            "wall_s": st["wall_s"], "p50_ms": st["p50_ms"],
            "p99_ms": st["p99_ms"], "matched": matched, "max_abs_err": worst,
            "fused_batches": st["fused_batches"],
            "fused_fallbacks": st["fused_fallbacks"],
            "kernel_launches": st["kernel_launches"],
            "fused_slices": st["fused_slices"]}


#: the fused plane's two forms: LR-only Titanic workflows at these
#: regParams (the same rows, so one pivot vocabulary) and one more on a
#: bootstrap (its widths may differ), exported and served on the table
#: form; N_BACKENDS model-stacking IR members on the generic form
FORM_REG_PARAMS = (0.001, 0.01, 0.1, 1.0)
#: rows of the pass each form is probed on, fused against classic
FORM_PASS_ROWS = PROBE_ROWS


def _titanic_reader():
    from transmogrifai_tpu_torch.readers import DataReaders
    return DataReaders.csv(_repo_file("examples", "data", "titanic.csv"),
                           _types(TITANIC_SCHEMA), key="id")


def _linear_cost(n, p, K, L, n_out) -> dict:
    """Bytes and f32 operations of one identity-table launch: X, mid and
    W read once, the output written once; a multiply and an add per
    (row, feature, head column)."""
    return {"bytes": 4.0 * (n * p + n + K * (p + 1) * L + n * n_out),
            "flops": 2.0 * n * (p + 1) * L}


def served_kernel_case(sk, scorer, args) -> dict:
    """The fused kernel against its plain version on one served bucket
    slice's own arguments (``FusedGroupScorer.kernel_inputs``), in the
    scorer's form, activation and operand dtype, timed beside its bound.
    No single PyTorch call computes either form with its activation, so
    the row has no library time."""
    act, dtype = scorer.act, scorer.dtype
    if scorer.form == "table":
        V, _mid, src, _op, _fill, W = args
        (n, C), (K, p) = V.shape, src.shape
        L = int(W.shape[2])
        shape = [int(n), int(C), int(p), int(K), L]
        kernel = lambda: sk.fused_prefix_scores(*args, act=act, dtype=dtype)  # noqa: E731
        plain = lambda: sk.fused_prefix_scores_torch(  # noqa: E731
            *args, act=act, dtype=dtype)
    else:
        X, W, mid = args
        (n, p), (K, _p1, L) = X.shape, W.shape
        shape = [int(n), int(p), int(K), int(L)]
        kernel = lambda: sk.fused_linear_scores(  # noqa: E731
            X, W, mid, act=act, dtype=dtype)
        plain = lambda: sk.apply_activation(  # noqa: E731
            act, sk.fused_linear_scores_torch(X, W, mid, dtype=dtype))
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    got_np, ref_np = got.cpu().numpy(), ref.cpu().numpy()
    if not np.isfinite(got_np).all():
        raise AssertionError(f"non-finite {scorer.form}-form output at "
                             f"{shape}")
    err = float(np.max(np.abs(got_np - ref_np)))
    if not (np.abs(got_np - ref_np) <= KERNEL_RTOL * (1.0 + np.abs(ref_np))
            ).all():
        raise AssertionError(f"the {scorer.form} form disagrees with its "
                             f"plain version at {shape}: max abs err {err}")
    n_out = int(got.shape[1])
    cost = (sk.fused_prefix_cost(*shape, n_out) if scorer.form == "table"
            else _linear_cost(*shape, n_out))
    bytes_ms = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = cost["flops"] / F32_FLOPS_PER_S * 1e3
    row = {"form": scorer.form, "shape": shape, "act": act,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": None}
    for prefix, fn in (("", kernel), ("plain_", plain)):
        row[prefix + "ms"], row[prefix + "device_events"] = device_ms(fn)
        row[prefix + "call_ms"] = call_ms(fn)
    return row


def _form_checks(sk, device, members, prepared, rng, rows=FORM_PASS_ROWS):
    """One form's card checks after its storm: the kernel against its
    plain version on the first bucket slice of a fused pass of ``rows``
    rows over ``members`` [(backend, spec)] (each row prepared by its own
    member: ``prepared[k]`` is member k's (n, boundary values)), and
    the pass's device operations, device us and host us beside the
    classic plane's pass over the same rows (each member's own device
    tail). On the CPU: the pass's scores only."""
    from transmogrifai_tpu_torch.serving.fusion import FusedGroupScorer
    scorer = FusedGroupScorer(members)
    K = len(members)
    mid = np.sort(rng.integers(0, K, rows)).astype(np.int32)
    own = [np.flatnonzero(mid == k) for k in range(K)]
    parts = [[v[idx % prepared[k][0]] for v in prepared[k][1]]
             for k, idx in enumerate(own)]
    vals = [np.concatenate([p[i] for p in parts])
            for i in range(len(parts[0]))]

    def fused():
        return scorer.finalize(scorer.launch(rows, vals, mid))

    def classic():
        return [b.finalize(b.launch(len(own[k]), parts[k]))
                for k, (b, _spec) in enumerate(members)]

    out = fused()
    if out.shape != (rows, scorer.n_out) or not np.isfinite(out).all():
        raise AssertionError(f"{scorer.form}-form pass gave {out.shape}, "
                             f"finite {bool(np.isfinite(out).all())}")
    res = {"form": scorer.form, "pass_models": K, "pass_rows": rows}
    if torch.device(device).type != "cuda":
        return res
    bucket = next(b for _s, _e, b in scorer._slices(rows))
    take = min(rows, bucket)
    res["kernel"] = served_kernel_case(sk, scorer, scorer.kernel_inputs(
        bucket, [v[:take] for v in vals], mid[:take]))
    res["fused_pass"] = pass_numbers(fused)
    res["classic_pass"] = pass_numbers(classic)
    return res


def table_form_part(seed: int, device, workdir, requests=EXPORT_REQUESTS):
    """Titanic on the table form: LR-only Titanic workflows at
    FORM_REG_PARAMS and one on a bootstrap, trained on ``device``,
    exported (``hostPrefix`` four OneHotModels), loaded with
    ``portable.load`` and served together by one ServingEngine with the
    fused plane on. Each request's boundary columns come from its own
    model's host prefix; every request within SERVE_ATOL of its own
    WorkflowModel under its plane's operand policy; the fused_storm
    gates; then the form's card checks (:func:`_form_checks`) over the
    members that pool with the first one (its pivot widths and fuse
    key: the bootstrap's checker may keep other columns)."""
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.serving import ModelRegistry
    from transmogrifai_tpu_torch.serving.fusion import stack_spec_of
    records = _titanic_reader().read()
    rng = np.random.default_rng(seed + 29)
    boot = [records[i] for i in rng.integers(0, len(records), len(records))]
    reg = ModelRegistry()
    models, cols, oracle = {}, {}, {}
    bf16 = sk.serve_dtype(device) == torch.bfloat16
    t0 = time.perf_counter()
    for k, r in enumerate(FORM_REG_PARAMS + (FORM_REG_PARAMS[1],)):
        wm = _titanic_workflow(
            candidates=[["LogisticRegression", {"regParam": [r]}]]).train(
                boot if k == len(FORM_REG_PARAMS) else records,
                device=device)
        art = os.path.join(workdir, f"titanic_{k}")
        wm.export_portable(art, buckets=BUCKETS)
        pm = portable.load(art, device=device)
        if pm.manifest["hostPrefix"] != ["OneHotModel"] * 4:
            raise AssertionError(f"Titanic export's host prefix "
                                 f"{pm.manifest['hostPrefix']}")
        name = f"t{k}"
        ds = wm.compile_scoring(device=device)._host_ds(records)
        cols[name] = {c: np.asarray(ds.column(c)) for c in pm.boundary
                      if c in ds}
        reg.register(name, pm, buckets=BUCKETS,
                     warm_sample={c: v[:1] for c, v in cols[name].items()})
        spec = stack_spec_of(reg.get(name).backend)
        if spec is None or spec.form != "table":
            raise AssertionError(f"Titanic export {name} is not served on "
                                 f"the table form: {spec and spec.form}")
        # the model's own scores of every row, on both planes' policies
        sel = wm.selected_model()
        full = wm.transform(records)
        X = full.column(sel.input_names[1]).astype(np.float32)
        beta = sel.model_params["beta"].cpu().numpy()
        z = (round_bf16(X).astype(np.float64)
             @ round_bf16(beta[:-1]).astype(np.float64) + float(beta[-1]))
        p1 = _probs(wm, full)
        oracle[name] = {"fused": _pair(z),
                        "classic": np.stack([1.0 - p1, p1], axis=1)}
        models[name] = wm
    train_s = time.perf_counter() - t0
    widths = {n: [np.shape(v)[1:] for v in c.values()]
              for n, c in cols.items()}
    reqs, picks = [], []
    for _ in range(requests):
        name = f"t{int(rng.integers(0, len(models)))}"
        rows = rng.integers(0, len(records), int(rng.integers(1, 9)))
        reqs.append((name, {c: v[rows] for c, v in cols[name].items()}))
        picks.append(rows)
    st = fused_storm(reg, reqs, device)
    matched = {"fused": 0, "classic": 0}
    worst = 0.0
    for (name, _data), rows, res, how in zip(reqs, picks, st["results"],
                                            st["planes"]):
        policy = "fused" if how == "fused" and bf16 else "classic"
        want = oracle[name][policy][rows]
        got = np.asarray(res[reg.get(name).backend.result_names[0]],
                         np.float64)
        err = float(np.abs(got - want).max())
        worst = max(worst, err)
        if not err <= SERVE_ATOL:
            raise AssertionError(f"Titanic request for {name} on the {how} "
                                 f"plane differs from its WorkflowModel by "
                                 f"{err}")
        matched[how] += 1
    specs = {n: stack_spec_of(reg.get(n).backend) for n in models}
    same = [n for n in sorted(models) if widths[n] == widths["t0"]
            and specs[n].fuse_key() == specs["t0"].fuse_key()]
    members = [(reg.get(n).backend, specs[n]) for n in same]
    prepared = [members[k][0].prepare(cols[n]) for k, n in enumerate(same)]
    checks = _form_checks(sk, device, members, prepared, rng)
    out = {k: v for k, v in st.items() if k not in ("results", "planes")}
    out.update(models=len(models), requests=requests, train_s=train_s,
               boundary_slots=int(sum(np.prod(w, dtype=np.int64)
                                      for w in widths["t0"])),
               bootstrap_pools=same[-1] == f"t{len(FORM_REG_PARAMS)}",
               bootstrap_same_widths=(widths[f"t{len(FORM_REG_PARAMS)}"]
                                      == widths["t0"]),
               head_widths={n: specs[n].p for n in sorted(specs)},
               matched=matched, max_abs_err=worst, **checks)
    return out


def generic_form_part(seed: int, device, requests=EXPORT_REQUESTS):
    """Model-stacking members on the generic form: N_BACKENDS
    :func:`make_stacked_ir` members loaded through
    ``portable.from_portable`` on ``device`` and served together by one
    ServingEngine with the fused plane on; every request within
    SERVE_ATOL of :func:`stacked_oracle` under its plane's operand
    policy; the fused_storm gates; then the form's card checks."""
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.serving import ModelRegistry
    from transmogrifai_tpu_torch.serving.fusion import stack_spec_of
    rng = np.random.default_rng(seed + 31)
    reg = ModelRegistry()
    pars, members = {}, []
    warm = {f"x{i}": np.zeros(1) for i in range(N_COLUMNS)}
    for k in range(N_BACKENDS):
        name = f"g{k}"
        manifest, arrays, pars[name] = make_stacked_ir(rng, f"pred_{name}")
        reg.register(name, portable.from_portable(manifest, arrays, device),
                     buckets=BUCKETS, warm_sample=warm)
        backend = reg.get(name).backend
        spec = stack_spec_of(backend)
        if spec is None or spec.form != "generic":
            raise AssertionError(f"stacking member {name} is not served on "
                                 f"the generic form: {spec and spec.form}")
        members.append((backend, spec))
    reqs = []
    for _ in range(requests):
        n = int(rng.integers(1, 9))
        reqs.append((f"g{int(rng.integers(0, N_BACKENDS))}",
                     {f"x{i}": np.where(rng.random(n) < 0.05, np.nan,
                                        rng.normal(size=n))
                      for i in range(N_COLUMNS)}))
    st = fused_storm(reg, reqs, device)
    bf16 = sk.serve_dtype(device) == torch.bfloat16
    matched = {"fused": 0, "classic": 0}
    worst = 0.0
    for (name, data), res, how in zip(reqs, st["results"], st["planes"]):
        got = np.asarray(res[f"pred_{name}"], np.float64)
        err = min(float(np.abs(got - want).max()) for want in
                  stacked_oracle(data, pars[name], bf16 and how == "fused"))
        worst = max(worst, err)
        if not err <= SERVE_ATOL:
            raise AssertionError(f"stacking request for {name} on the {how} "
                                 f"plane differs from its numpy score by "
                                 f"{err}")
        matched[how] += 1
    cols = {f"x{i}": np.where(rng.random(FORM_PASS_ROWS) < 0.05, np.nan,
                              rng.normal(size=FORM_PASS_ROWS))
            for i in range(N_COLUMNS)}
    prepared = [b.prepare(cols) for b, _spec in members]
    checks = _form_checks(sk, device, members, prepared, rng)
    out = {k: v for k, v in st.items() if k not in ("results", "planes")}
    out.update(models=N_BACKENDS, requests=requests, matched=matched,
               max_abs_err=worst, **checks)
    return out


def form_lines(wf) -> list:
    """One line per form of the fused plane: the kernel against its
    plain version at the served shape, and a fused pass's device
    operations, device us and host us beside the classic plane's pass
    for the same requests."""
    out = []
    for key in ("table_form", "generic_form"):
        f = wf[key]
        k, fp, cp = f["kernel"], f["fused_pass"], f["classic_pass"]
        out.append(
            f"phase workflow: {f['form']} form: {f['pass_models']} models, "
            f"{f['pass_rows']} rows: fused pass "
            f"{fp['device_ops_per_pass']!r} "
            f"device ops, {fp['device_us_per_pass']!r} device us, "
            f"{fp['host_us_per_pass']!r} host us; classic pass "
            f"{cp['device_ops_per_pass']!r} device ops, "
            f"{cp['device_us_per_pass']!r} device us, "
            f"{cp['host_us_per_pass']!r} host us; kernel {k['shape']} "
            f"{k['dtype']} {k['ms']!r} ms (plain {k['plain_ms']!r}, bound "
            f"{k['bound_ms']!r} by {k['bound_by']}), max abs err "
            f"{k['max_abs_err']!r}; {f['kernel_launches']} launches for "
            f"{f['fused_slices']} fused slices")
    return out


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
    runner (held to the port's CPU run), the at-scale CSV workflow, four
    exported Boston workflows served through the fused plane, five
    exported Titanic workflows on its table form and four
    model-stacking members on its generic form. The histogram and fused
    kernel launches of the whole phase are returned for the kernels
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
        table = table_form_part(seed, device, workdir)
        generic = generic_form_part(seed, device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"native_csv": native.available(), "titanic": titanic,
            "scale": scale, "export": export, "table_form": table,
            "generic_form": generic,
            "histogram_launches": (titanic["histogram_launches"]
                                   + scale["histogram_launches"]),
            "fused_launches": (export["kernel_launches"]
                               + table["kernel_launches"]
                               + generic["kernel_launches"])}


# ---------------------------------------------------------------------------
# phase 8b: the runner's process-level services (debugNans, the build cache)
# ---------------------------------------------------------------------------

#: the candidates of the Titanic TRAIN that runs under debugNans without
#: the checker (it completes in both packages)
NANS_CANDIDATES = [["LogisticRegression", None], ["GBTClassifier", None]]


def debug_nans_part(device):
    """``OpParams.debugNans`` on ``device``. The Titanic TRAIN raises
    ``FloatingPointError`` in the SanityChecker, naming ``full_like``
    (its deliberate NaN correlation for a constant column), where the
    JAX package raises on the CPU for the same data; without the checker
    (LR and GBT) it completes, as the JAX package's does
    (``tests/test_torch_debug_nans.py`` holds the two packages to each
    other on these inputs); a 0/0 planted on the card under
    ``debug_nans`` raises naming ``div``. The completing TRAIN's wall
    with and without the checks."""
    from transmogrifai_tpu_torch.profiling import debug_nans
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.runner import (OpParams, RunType,
                                                WorkflowRunner)
    dev = torch.device(device)
    reader = DataReaders.csv(_repo_file("examples", "data", "titanic.csv"),
                             _types(TITANIC_SCHEMA), key="id")
    with_checker = WorkflowRunner(_titanic_workflow(), train_reader=reader,
                                  device=dev)
    try:
        with_checker.run(RunType.TRAIN, OpParams(debug_nans=True))
    except FloatingPointError as e:
        checker_error = str(e)
    else:
        raise AssertionError("debugNans: the Titanic TRAIN completed; the "
                             "JAX package raises in its checker")
    if "full_like" not in checker_error:
        raise AssertionError(f"debugNans raised {checker_error!r}, not at "
                             f"the checker's full_like")
    walls = {}
    for on in (False, True):
        runner = WorkflowRunner(
            _titanic_workflow(NANS_CANDIDATES, checker=False),
            train_reader=reader, device=dev)
        t0 = time.perf_counter()
        runner.run(RunType.TRAIN, OpParams(debug_nans=on))
        walls["on" if on else "off"] = time.perf_counter() - t0
    zero = torch.zeros(4, device=dev)
    try:
        with debug_nans():
            zero / zero
    except FloatingPointError as e:
        planted = str(e)
    else:
        raise AssertionError("debugNans: a planted 0/0 did not raise")
    if "div" not in planted:
        raise AssertionError(f"the planted 0/0 raised {planted!r}")
    return {"titanic_with_checker": checker_error,
            "titanic_without_checker": "completed",
            "planted": planted, "train_wall_s": walls}


def cache_worker(argv=None) -> int:
    """A fresh process (``python -c "import chip_smoke;
    chip_smoke.cache_worker()" DIR DEVICE``): a GBT TRAIN on 2,000
    training-phase rows through ``WorkflowRunner`` with
    ``compilationCacheLocation`` DIR. Prints one ``cache-result:`` JSON
    line: the build directory during the run, the one after it, and the
    caller's choice after it (None)."""
    from transmogrifai_tpu_torch import _compile_cache
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.runner import (OpParams, RunType,
                                                WorkflowRunner)
    from transmogrifai_tpu_torch.workflow import Workflow
    where, device = (argv or sys.argv[1:])[:2]
    seen = {}
    load = tk._cuda_build.load_library

    def spy(name):
        seen[name] = _compile_cache.build_dir()
        return load(name)
    tk._cuda_build.load_library = spy
    X, y = training_data(0, 2_000)
    ds, sel = _selector(X, y, [["GBTClassifier", None]], torch.device(device))
    WorkflowRunner(Workflow([sel.output]), train_reader=ds,
                   device=device).run(
        RunType.TRAIN, OpParams(compilation_cache_location=where))
    print("cache-result: " + json.dumps({
        "during": seen, "after": _compile_cache.build_dir(),
        "chosen_after": _compile_cache.chosen_build_dir(),
        "launches": tk.histogram_grid.launches}), flush=True)
    return 0


def build_cache_part(device, workdir, timeout_s=300.0):
    """``OpParams.compilationCacheLocation``: a fresh process's TRAIN on
    ``device`` builds the one kernel it launches (the histogram) into
    the run's directory, and the build directory is the default again
    after the run; the default directory gains no file."""
    from transmogrifai_tpu_torch import _compile_cache
    dev = torch.device(device)
    where = os.path.join(workdir, "kernel_cache")
    default = _compile_cache.build_dir()
    before = sorted(os.listdir(default)) if os.path.isdir(default) else []
    root = _repo_file()
    wenv = dict(os.environ)
    wenv["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in wenv.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.cache_worker(sys.argv[1:]))", where,
         str(dev)], cwd=root, env=wenv, capture_output=True, text=True,
        timeout=timeout_s)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the cache worker exited {res.returncode}:\n"
                             f"{(res.stdout + res.stderr)[-3000:]}")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("cache-result: ")]
    if not line:
        raise AssertionError(f"the cache worker printed no result:\n"
                             f"{res.stdout[-3000:]}")
    out = json.loads(line[-1].split(": ", 1)[1])
    built = sorted(os.listdir(where)) if os.path.isdir(where) else []
    cuda = dev.type == "cuda"
    want = ["tree_histogram"] if cuda else []
    if sorted(out["during"]) != want or any(
            d != os.path.abspath(where) for d in out["during"].values()):
        raise AssertionError(f"the run built {out['during']}, not {want} "
                             f"into {where}")
    if [b.split("-")[0][3:] for b in built] != want:
        raise AssertionError(f"the run's directory holds {built}")
    if out["chosen_after"] is not None or out["after"] != default:
        raise AssertionError(f"the build directory after the run is "
                             f"{out['after']}, not {default}")
    after = sorted(os.listdir(default)) if os.path.isdir(default) else []
    if after != before:
        raise AssertionError("the run built into the default directory")
    return {"built": built, "restored_to": out["after"],
            "histogram_launches": out["launches"], "wall_s": wall}


def services_phase(device="cuda", workdir=None):
    """The runner's debugNans and compilationCacheLocation."""
    import tempfile
    t0 = time.perf_counter()
    workdir = workdir or tempfile.mkdtemp(prefix="tm_services_phase_")
    out = {"debug_nans": debug_nans_part(device),
           "build_cache": build_cache_part(device, workdir)}
    out["wall_s"] = time.perf_counter() - t0
    return out


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
           "family_wall_s": m1.wall_seconds["families"],
           "family_wall_s_run2": m2.wall_seconds["families"],
           "refit_wall_s": [m1.wall_seconds["refit"],
                            m2.wall_seconds["refit"]],
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
    # the walls stay on the trained model (a saved one holds none)
    walls_s = model.selected_model().wall_seconds
    return {"rows": rows, "chunk_rows": chunk_rows, "buckets": buckets,
            "records_wall_s": gen_wall, "train_cold_wall_s": walls[0],
            "train_warm_wall_s": walls[1], "evaluate_wall_s": eval_wall,
            "auroc": auc, "best": train["bestModel"],
            "field_contributions": dict(zip(vec.input_names,
                                            train["fieldContributions"])),
            "family_wall_s": walls_s["families"],
            "refit_wall_s": walls_s["refit"],
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
# features: every feature type through transmogrify

#: the JAX bench's wide CRM workflow (bench.py:579-657), at the card's
#: row count (the bench's 12,000 rows, TM_BENCH_WF_ROWS, is a CPU size)
FEAT_CRM_ROWS = 50_000
#: part 1 ran 104 s at 50,000 rows on the card (data, two trains, two
#: save/load/score passes and 2 x 1,000 LocalScorer rows), past the
#: ~90 s it may take, so it runs cut to FEAT_CRM_RUN_ROWS (printed)
FEAT_CRM_RUN_ROWS = 40_000
FEAT_CRM_MIN_ROWS = 12_000      # the least part 1 may be cut to
FEAT_EVERY_ROWS = 50_000         # cut from 100,000 for the fleet phase
FEAT_PARITY_ROWS = 2_500        # card vs CPU in exact mode (cut from 5,000)
FEAT_LOCAL_ROWS = 1_000         # LocalScorer rows against the bulk scores
FEAT_LOCAL_ATOL = 1e-5
FEAT_MIN_AUROC = 0.7            # the every-type label is learnable
#: OpLDA alone, at the TextArea default's widths (k = 8, V = 256)
LDA_DOCS, LDA_VOCAB, LDA_K = 100_000, 256, 8
LDA_EM_ITERS, LDA_E_ITERS = 30, 20
#: lambda card vs CPU: tests/test_torch_text_advanced.py's tolerance
#: (rtol, and atol as a share of max|lambda|)
LDA_LAM_RTOL, LDA_LAM_ATOL_SCALE = 1e-4, 1e-6
ARTIFACT_RTOL = 1e-4            # the checked-in JAX artifact's scores
#: examples/op_house_log.py's bar: median relative dollar error
HOUSE_MAX_REL_ERR = 0.15
HOUSE_ROWS = 400
#: the every-type parity gate's candidates (RF's draws differ by device)
PARITY_CANDIDATES = [
    ["LogisticRegression", {"regParam": [0.01, 0.1]}],
    ["DecisionTreeClassifier", None], ["GBTClassifier", None]]
JAX_ARTIFACT = ("tests", "data", "jax_features_model")


def _sub(pkg, name: str):
    """Submodule ``name`` of the package ``pkg`` (the port here; the
    tests hand in the JAX package to build the same workflow there)."""
    import importlib
    return importlib.import_module(f"{pkg.__name__}.{name}")


def crm_data(pkg, n: int, seed: int = 0):
    """``bench.py::_workflow_train_data`` at ``n`` rows: 12 Real and 6
    Binary columns (5% missing), 8 PickLists of 30 levels, 6
    MultiPickLists over 60 tags, 4 Dates, 8 RealMaps of 32 keys, 4
    TextMaps of 24 keys x 8 values, 2 BinaryMaps of 32 keys and 4
    DateMaps of 16 keys (25% key presence), 2 hashed Texts and the
    label as written: 56 predictors. The bench's generator seed is 3."""
    ft = pkg.types
    rng = np.random.default_rng(3 + seed)
    cols, schema = {}, {}
    for i in range(12):
        cols[f"r{i}"] = np.where(rng.random(n) < 0.05, np.nan,
                                 rng.normal(size=n))
        schema[f"r{i}"] = ft.Real
    for i in range(6):
        b = (rng.random(n) < 0.4).astype(np.float64)
        cols[f"b{i}"] = np.where(rng.random(n) < 0.05, np.nan, b)
        schema[f"b{i}"] = ft.Binary
    cats = [f"cat{j:02d}" for j in range(30)]
    for i in range(8):
        v = np.asarray(cats, object)[rng.integers(0, 30, n)]
        v[rng.random(n) < 0.05] = None
        cols[f"c{i}"] = list(v)
        schema[f"c{i}"] = ft.PickList
    tags = [f"tag{j}" for j in range(60)]
    for i in range(6):
        sizes = rng.integers(0, 6, n)
        picks = rng.integers(0, 60, int(sizes.sum()))
        out, at = [], 0
        for s in sizes:
            out.append(frozenset(tags[p] for p in picks[at:at + s]))
            at += s
        cols[f"m{i}"] = out
        schema[f"m{i}"] = ft.MultiPickList
    for i in range(4):
        cols[f"d{i}"] = rng.integers(int(1.5e12), int(1.7e12), n
                                     ).astype(np.float64)
        schema[f"d{i}"] = ft.Date
    map_keys = [f"k{j:02d}" for j in range(32)]

    def map_col(n_keys, make_value, presence=0.25):
        present = rng.random((n, n_keys)) < presence
        vals = rng.random((n, n_keys))
        return [{map_keys[j]: make_value(vals[r, j])
                 for j in range(n_keys) if present[r, j]}
                for r in range(n)]

    for i in range(8):
        cols[f"rm{i}"] = map_col(32, float)
        schema[f"rm{i}"] = ft.RealMap
    for i in range(4):
        cols[f"tm{i}"] = map_col(24, lambda v: f"v{int(v * 8)}")
        schema[f"tm{i}"] = ft.TextMap
    for i in range(2):
        cols[f"bm{i}"] = map_col(32, lambda v: bool(v < 0.5))
        schema[f"bm{i}"] = ft.BinaryMap
    for i in range(4):
        cols[f"dm{i}"] = map_col(
            16, lambda v: float(int(1.5e12 + v * 2e11)))
        schema[f"dm{i}"] = ft.DateMap
    for i in range(2):
        cols[f"t{i}"] = [f"token{int(v):06d} token{int(w):06d}"
                         for v, w in zip(rng.integers(0, 50_000, n),
                                         rng.integers(0, 50_000, n))]
        schema[f"t{i}"] = ft.Text
    drive = np.nan_to_num(cols["r0"]) - np.nan_to_num(cols["r1"]) \
        + np.nan_to_num(cols["b0"])
    cols["label"] = (rng.random(n) < 1 / (1 + np.exp(-drive))
                     ).astype(np.float64)
    schema["label"] = ft.RealNN
    return pkg.Dataset.from_dict(cols, schema)


def crm_workflow(pkg, ds, default_list: bool, candidates=None):
    """``bench.py::_workflow_train_build(automl=True)`` (transmogrify,
    SanityChecker, 2-fold LR) or, with ``default_list``, the same
    features through ``with_cross_validation()``'s default candidate
    list with ``with_raw_feature_filter(min_fill_rate=0.001)`` as
    ``bench.py:2770`` adds it (``candidates``: another list, for a CPU
    rehearsal). Returns (workflow, selector)."""
    ft, ops = pkg.types, _sub(pkg, "ops")
    M, W = _sub(pkg, "models"), _sub(pkg, "workflow")
    pkg.reset_uids()
    label = pkg.FeatureBuilder.of(ft.RealNN, "label").from_column() \
        .as_response()
    preds = [pkg.FeatureBuilder.of(t, name).from_column().as_predictor()
             for name, t in ds.schema.items() if name != "label"]
    checked = ops.SanityChecker().set_input(label,
                                            ops.transmogrify(preds)).output
    if default_list:
        sel = M.BinaryClassificationModelSelector.with_cross_validation(
            candidates=candidates)
        wf = W.Workflow([sel.set_input(label, checked).output]) \
            .with_raw_feature_filter(min_fill_rate=0.001)
    else:
        sel = M.BinaryClassificationModelSelector.with_cross_validation(
            n_folds=2, candidates=[["LogisticRegression",
                                    {"regParam": [0.01],
                                     "elasticNetParam": [0.0]}]])
        wf = W.Workflow([sel.set_input(label, checked).output])
    return wf, sel


_DOMAINS = ("corp.com", "free.net", "mail.org")
_FIRST = ("James", "Mary", "Robert", "Elena", "Carlos", "Yuki", "Omar",
          "Linda")
_LAST = ("Smith", "Garcia", "Lee", "Brown", "Davis", "Wilson")


def every_type_data(pkg, n: int, seed: int = 0):
    """One column of each type the CRM set lacks, from the package's
    ``testkit`` (its seeded generators, one draw a row;
    ``TestFeatureBuilder``): Email, URL, Phone, Base64, DateList,
    TextArea, TextList, Geolocation and the map types IntegralMap,
    CurrencyMap, DateTimeMap, PickListMap, MultiPickListMap, TextAreaMap
    and GeolocationMap, and a seller-name Text. The label depends on the email's domain, the TextArea's topic
    (one of LDA_K, 30 words each) and the IntegralMap's key ``a``.
    Returns (Dataset, {name: Feature})."""
    tk, ft = _sub(pkg, "testkit"), pkg.types
    rng = np.random.default_rng(100 + seed)
    dom = rng.integers(0, 3, n)
    topic = rng.integers(0, LDA_K, n)
    a = rng.integers(-5, 6, n)
    has_a = rng.random(n) < 0.8
    # LDA_K topics of 30 words each; a document draws 12 of its topic's
    vocab = np.asarray([f"t{t}w{j}" for t in range(LDA_K)
                        for j in range(30)], object)
    words = vocab[topic[:, None] * 30 + rng.integers(0, 30, (n, 12))]
    logit = (2.0 * (dom == 0) - 1.5 * (dom == 2)
             + 1.8 * (topic < LDA_K // 2) + 0.5 * np.where(has_a, a, 0)
             - 0.9)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(float)
    s = 1000 * seed
    imap = tk.RandomMap.of(tk.RandomIntegral.integers(
        -5, 6, wtype=ft.Integral, seed=s + 1), min_size=0, max_size=3,
        seed=s + 2).take(n)
    for i in range(n):
        imap[i] = {k: v for k, v in imap[i].items() if k != "a"}
        if has_a[i]:
            imap[i]["a"] = int(a[i])
    cols = {
        "email": (ft.Email, [f"user{i % 997}@{_DOMAINS[d]}"
                             for i, d in enumerate(dom)]),
        "site": (ft.URL, tk.RandomText.urls(seed=s + 3)
                 .with_probability_of_empty(0.1).take(n)),
        "phone": (ft.Phone, tk.RandomText.phones(seed=s + 4)
                  .with_probability_of_empty(0.1).take(n)),
        "blob": (ft.Base64, tk.RandomText.base64(seed=s + 5).take(n)),
        "visits": (ft.DateList, tk.RandomList.of_dates(seed=s + 6).take(n)),
        "notes": (ft.TextArea, [" ".join(r) for r in words]),
        "tags": (ft.TextList, tk.RandomList.of_texts(seed=s + 7).take(n)),
        "where": (ft.Geolocation, tk.RandomGeolocation.of(
            seed=s + 8).with_probability_of_empty(0.1).take(n)),
        "imap": (ft.IntegralMap, imap),
        "cmap": (ft.CurrencyMap, tk.RandomMap.of(
            tk.RandomReal.lognormal(wtype=ft.Currency, seed=s + 9),
            seed=s + 10).take(n)),
        "tmap": (ft.DateTimeMap, tk.RandomMap.of(
            tk.RandomIntegral.dates(seed=s + 11), wtype=ft.DateTimeMap,
            seed=s + 12).take(n)),
        "pmap": (ft.PickListMap, tk.RandomMap.of(
            tk.RandomText.picklists(["x", "y", "z"], seed=s + 13),
            seed=s + 14).take(n)),
        "mmap": (ft.MultiPickListMap, tk.RandomMap.of(
            tk.RandomMultiPickList.of(["p", "q", "r", "s"], seed=s + 15),
            seed=s + 16).take(n)),
        "amap": (ft.TextAreaMap, tk.RandomMap.of(
            tk.RandomText.text_areas(seed=s + 17), seed=s + 18).take(n)),
        "gmap": (ft.GeolocationMap, tk.RandomMap.of(
            tk.RandomGeolocation.of(seed=s + 19), seed=s + 20).take(n)),
        "seller": (ft.Text, [f"{_FIRST[i % 8]} {_LAST[(i // 8) % 6]}"
                             for i in range(n)]),
        "label": (ft.RealNN, list(y)),
    }
    return tk.TestFeatureBuilder.of(cols, response="label")


def every_type_workflow(pkg, feats, candidates=None, folds: int = 3,
                        textarea: str = "lda"):
    """transmogrify over every column but the seller, whose name column
    goes through ``SmartTextVectorizer(sensitive_feature_mode="remove")``
    into the same combiner; SanityChecker; the binary selector (3-fold
    CV; ``candidates`` None: the default list; ``textarea``: the
    TextArea route, ``transmogrify``'s). Returns (workflow, selector)."""
    ops, M, W = _sub(pkg, "ops"), _sub(pkg, "models"), _sub(pkg, "workflow")
    seller = ops.SmartTextVectorizer(sensitive_feature_mode="remove") \
        .set_input(feats["seller"]).output
    fv = ops.transmogrify([f for n, f in feats.items()
                           if n not in ("label", "seller")],
                          textarea=textarea)
    both = ops.VectorsCombiner().set_input(seller, fv).output
    checked = ops.SanityChecker().set_input(feats["label"], both).output
    sel = M.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=folds, candidates=candidates)
    return W.Workflow([sel.set_input(feats["label"], checked).output]), sel


def _stage_walls(model) -> dict:
    """Fit seconds by kind from ``stageTimings``: the SanityChecker, the
    selector, and every other stage (the feature layer)."""
    walls = {"feature_layer": 0.0, "checker": 0.0, "selector": 0.0}
    for st in model.train_summaries["stageTimings"]["stages"]:
        kind = {"SanityCheckerModel": "checker",
                "SelectedModel": "selector"}.get(st["operation"],
                                                 "feature_layer")
        walls[kind] += st["fit_s"]
    return walls


def _trained(wf, ds, device):
    """Train ``wf`` on ``device``: (model, wall s, device busy s, device
    events). On the card the train runs under torch.profiler (CUDA
    activity only) for the busy share; on the CPU there is none."""
    held = []
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        held.append(wf.train(ds, device=device))
        return held[0], time.perf_counter() - t0, None, None
    busy_s, events, wall = _device_busy(
        lambda: held.append(wf.train(ds, device=device)))
    return held[-1], wall, busy_s, events


def _first_probs(model, ds):
    return _probs(model, model.score(ds))


def _save_load_score(model, ds, device, workdir, name, local_rows=0):
    """Save, load on ``device`` and score ``ds`` in bulk: the loaded
    model's scores must equal the trained one's bitwise; LocalScorer on
    ``local_rows`` label-free rows within FEAT_LOCAL_ATOL of them."""
    from transmogrifai_tpu_torch.local import LocalScorer
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    sync = _sync_of(device)
    first = _first_probs(model, ds)
    path = os.path.join(workdir, name)
    t0 = time.perf_counter()
    model.save(path)
    loaded = WorkflowModel.load(path, device=device)
    save_load = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    scored = loaded.score(ds)
    sync()
    score_wall = time.perf_counter() - t0
    again = _probs(loaded, scored)
    if not np.array_equal(again, first):
        raise AssertionError(f"{name}: the loaded model's scores differ "
                             f"from the trained one's")
    if not (np.isfinite(first).all() and (first >= 0).all()
            and (first <= 1).all()):
        raise AssertionError(f"{name}: scores malformed")
    label = next(f.name for f in loaded.raw_features if f.is_response)
    local = LocalScorer(loaded, device=device)
    res = loaded.result_features[0].name
    k = min(local_rows, ds.n_rows)
    t0 = time.perf_counter()
    lp = np.asarray([local({c: v for c, v in r.items() if c != label})
                     [res]["probability_1"] for r in ds.head(k).rows()])
    local_wall = time.perf_counter() - t0
    local_err = float(np.abs(lp - first[:k]).max()) if k else None
    if k and not local_err <= FEAT_LOCAL_ATOL:
        raise AssertionError(f"{name}: LocalScorer differs from the bulk "
                             f"scores by {local_err}")
    return {"save_load_wall_s": save_load, "score_wall_s": score_wall,
            "score_rows_per_s": ds.n_rows / score_wall,
            "loaded_scores_bitwise": True, "local_rows": k,
            "local_wall_s": local_wall,
            "local_max_abs_err": local_err}, first


def _train_report(model, sel, wall, busy_s, events, launches, device):
    summ = model.selected_model().summary
    families = [c[0] for c in sel.params["candidates"]]
    cuda = torch.device(device).type == "cuda"
    expected = _expected_levels(summ, families) if cuda else 0
    if launches != expected:
        raise AssertionError(f"{launches} histogram launches, the "
                             f"selector grew {expected} tree levels")
    checker = _checker_of(model)
    return {"train_wall_s": wall, **{f"{k}_fit_s": v for k, v in
                                     _stage_walls(model).items()},
            "device_busy_s": busy_s, "device_events": events,
            "device_busy_share": None if busy_s is None else busy_s / wall,
            "histogram_launches": launches, "expected_launches": expected,
            "features_in": checker.summary["featuresIn"],
            "kept_slots": len(checker.params["keep_indices"]),
            "winner": summ["bestModel"],
            "holdout_auroc": summ["holdoutEvaluation"].get("AuROC"),
            "family_wall_s": model.selected_model().wall_seconds[
                "families"]}


def crm_part(seed, device, workdir, rows=FEAT_CRM_ROWS, cut_from=None,
             candidates=None):
    """Part 1: the bench's wide CRM workflow at ``rows`` rows, trained
    twice on ``device`` — the bench's AutoML build and the default list
    with the raw feature filter — each saved, loaded and scored."""
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.models import kernels as tk
    if torch.device(device).type == "cuda" and rows < FEAT_CRM_MIN_ROWS:
        raise ValueError(f"the CRM workflow runs at >= {FEAT_CRM_MIN_ROWS} "
                         f"rows on the card, not {rows}")
    t0 = time.perf_counter()
    ds = crm_data(P, rows, seed)
    data_wall = time.perf_counter() - t0
    out = {"rows": rows, "rows_cut_from": cut_from,
           "predictors": len(ds.schema) - 1, "data_wall_s": data_wall}
    for name, default_list in (("automl", False), ("default_list", True)):
        wf, sel = crm_workflow(P, ds, default_list, candidates)
        shapes = []
        tk.histogram_grid.launches = 0
        with hist_hook(shapes=shapes):
            model, wall, busy_s, events = _trained(wf, ds, device)
        rep = _train_report(model, sel, wall, busy_s, events,
                            tk.histogram_grid.launches, device)
        rep["hist_check"] = path_hist_check(shapes, f"crm_{name}", seed)
        scoring, _ = _save_load_score(model, ds, device, workdir,
                                      f"crm_{name}", FEAT_LOCAL_ROWS)
        rep.update(scoring)
        if default_list:
            rff = model.train_summaries.get("rawFeatureFilter")
            if rff is None:
                raise AssertionError("the raw feature filter left no "
                                     "rawFeatureFilter summary")
            rep["raw_filter_excluded"] = sorted(rff["exclusionReasons"])
        out[name] = rep
    if out["predictors"] != 56:
        raise AssertionError(f"{out['predictors']} CRM predictors, not 56")
    return out


def _lda_stage(model):
    return next(st for st in model.stages
                if type(st).__name__ == "LDAModel")


def _sensitive(model):
    info = model.model_insights().get("sensitiveFeatureInformation") or []
    hit = [s for s in info if s.get("name") == "seller"
           or s.get("featureName") == "seller"]
    if not hit:
        raise AssertionError(f"the seller column was not reported "
                             f"sensitive: {info}")
    return hit


def every_part(seed, device, workdir, rows=FEAT_EVERY_ROWS, candidates=None):
    """Part 2: every type through transmogrify -> SanityChecker -> the
    default binary list -> save/load -> scoring on ``device``."""
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.models import kernels as tk
    P.reset_uids()
    t0 = time.perf_counter()
    ds, feats = every_type_data(P, rows, seed)
    data_wall = time.perf_counter() - t0
    wf, sel = every_type_workflow(P, feats, candidates)
    shapes = []
    tk.histogram_grid.launches = 0
    with hist_hook(shapes=shapes):
        model, wall, busy_s, events = _trained(wf, ds, device)
    rep = _train_report(model, sel, wall, busy_s, events,
                        tk.histogram_grid.launches, device)
    rep["hist_check"] = path_hist_check(shapes, "every_type", seed)
    if not rep["holdout_auroc"] >= FEAT_MIN_AUROC:
        raise AssertionError(f"every-type holdout AUROC "
                             f"{rep['holdout_auroc']} < {FEAT_MIN_AUROC}")
    scoring, _ = _save_load_score(model, ds, device, workdir, "every")
    rep.update(scoring)
    rep.update(rows=rows, data_wall_s=data_wall,
               sensitive=_sensitive(model),
               lda_vocab=len(_lda_stage(model).params["vocab"]))
    return rep


def _lda_counts(seed, n=LDA_DOCS, V=LDA_VOCAB, k=LDA_K, length=40):
    """A (n, V) count matrix of ``k`` planted topics, from numpy."""
    rng = np.random.default_rng(200 + seed)
    topics = rng.dirichlet(np.full(V, 0.05), size=k)
    doc_topic = rng.integers(0, k, n)
    counts = np.zeros((n, V), np.float32)
    for t in range(k):
        rows = np.nonzero(doc_topic == t)[0]
        counts[rows] = rng.multinomial(length, topics[t], size=len(rows))
    return counts


def lda_cost(n, V, k, em_iters=LDA_EM_ITERS, e_iters=LDA_E_ITERS):
    """(bytes, flops) the fit must spend: the count matrix read once per
    E-step iteration (a fused step reads it once for both products) and
    once more for each EM step's sufficient statistics, and the
    E-steps' two (n, K) x (K, V) products plus each EM step's
    sufficient statistics. (Counting two reads per E-step iteration
    would about double these bytes.)"""
    steps = em_iters * e_iters
    byts = em_iters * (e_iters + 1) * n * V * 4
    flops = steps * 4 * n * k * V + em_iters * 4 * n * k * V
    return byts, flops


def lda_part(seed, device, docs=LDA_DOCS):
    """``fit_lda`` alone at (LDA_DOCS, LDA_VOCAB, LDA_K): wall, device
    time and operations (torch.profiler) beside its bound, and on the
    card a fit under ``set_sync_debug_mode("error")`` (no host sync)."""
    from transmogrifai_tpu_torch.ops import lda as L
    from transmogrifai_tpu_torch.workflow import to_device
    counts = to_device(_lda_counts(seed, docs), torch.device(device))
    sync = _sync_of(device)

    def fit():
        return L.fit_lda(counts, LDA_K, 0.1, 0.01, LDA_EM_ITERS,
                         LDA_E_ITERS, seed)
    lam = fit()                               # warm (library handles)
    sync()
    t0 = time.perf_counter()
    lam = fit()
    sync()
    wall = time.perf_counter() - t0
    if not (torch.isfinite(lam).all() and (lam > 0).all()):
        raise AssertionError("fit_lda's lambda is not finite and positive")
    byts, flops = lda_cost(*counts.shape, LDA_K)
    out = {"shape": [int(counts.shape[0]), int(counts.shape[1]), LDA_K],
           "em_iters": LDA_EM_ITERS, "e_iters": LDA_E_ITERS,
           "wall_ms": wall * 1e3,
           "bound_ms": max(byts / HBM_BYTES_PER_S,
                           flops / F32_FLOPS_PER_S) * 1e3,
           "bound_by": ("bytes" if byts / HBM_BYTES_PER_S
                        >= flops / F32_FLOPS_PER_S else "operations"),
           "bytes": byts, "flops": flops}
    if torch.device(device).type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
        try:
            fit()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        prof, _ = profiled(fit, host=False)
        busy_us, events = _device_time_us(prof)
        out.update(device_ms=busy_us / 1e3, device_ops=events,
                   sync_free=True)
    return out


def parity_part(seed, device, rows=FEAT_PARITY_ROWS, check=None):
    """The every-type workflow at ``rows`` rows in exact mode on
    ``device`` and on the CPU (PARITY_CANDIDATES): the same LDA
    vocabulary and kept slots, lambda within the test's tolerance, LR's
    CV metrics within LINEAR_CPU_TOL. The topics differ card vs CPU in
    their last bits, which can move a tree split at a bin edge, so the
    two workflows' DT and GBT CV metrics are held to GBT_PARITY_TOL;
    then DT and GBT on the card's checked matrix, card against CPU, as
    Titanic's GBT is held (:func:`tree_near_ties`), each side's selector
    recomputed on its own workflow's matrix to that workflow's metrics.
    ``check`` (a test's planted fault) may rewrite the card model's
    lambda first."""
    import transmogrifai_tpu_torch as P
    models = {}
    for side in (device, "cpu"):
        P.reset_uids()
        ds, feats = every_type_data(P, rows, seed)
        wf, _ = every_type_workflow(P, feats, PARITY_CANDIDATES)
        with env(TM_KERNEL_EXACT="1"):
            models[side] = wf.train(ds, device=side)
    card, cpu = models[device], models["cpu"]
    la, lb = _lda_stage(card), _lda_stage(cpu)
    if la.params["vocab"] != lb.params["vocab"]:
        raise AssertionError("LDA vocabularies differ card vs CPU")
    lam_card, lam_cpu = la.lam.cpu().numpy(), lb.lam.cpu().numpy()
    if check is not None:
        lam_card = check(lam_card)
    lam_gap = np.abs(lam_card - lam_cpu)
    lam_ok = lam_gap <= (LDA_LAM_RTOL * np.abs(lam_cpu)
                         + LDA_LAM_ATOL_SCALE * np.abs(lam_cpu).max())
    if not lam_ok.all():
        raise AssertionError(f"LDA lambda card vs CPU past the tolerance: "
                             f"max gap {float(lam_gap.max())}")
    kc, kp = (_checker_of(m).params["keep_indices"] for m in (card, cpu))
    if kc != kp:
        raise AssertionError("kept slots differ card vs CPU")
    gm_card, gm_cpu = (_grid_metrics(m.selected_model().summary)
                       for m in (card, cpu))
    gaps = {f: float(np.abs(np.subtract(gm_card[f], gm_cpu[f])).max())
            for f in gm_card}
    if not gaps["LogisticRegression"] <= LINEAR_CPU_TOL["binary"]:
        raise AssertionError(f"LR CV metrics card vs CPU differ by "
                             f"{gaps['LogisticRegression']}")
    trees = {}
    with env(TM_KERNEL_EXACT="1"):
        Xc, y = checked_matrix(card, ds, "label")
        Xp, _ = checked_matrix(cpu, ds, "label")
    for fam in ("DecisionTreeClassifier", "GBTClassifier"):
        if not gaps[fam] <= GBT_PARITY_TOL:
            raise AssertionError(f"{fam} CV metrics card vs CPU differ by "
                                 f"{gaps[fam]}")
        trees[fam] = tree_near_ties(fam, Xc, y, device, "every-type",
                                    held=[("card", Xc, gm_card[fam]),
                                          ("cpu", Xp, gm_cpu[fam])])
    return {"rows": rows, "lda_vocab": len(la.params["vocab"]),
            "lam_max_abs_gap": float(lam_gap.max()),
            "lam_max_rel_gap": float((lam_gap / np.abs(lam_cpu)).max()),
            "kept_slots": len(kc), "cv_gap": gaps,
            "matrix_max_abs_gap": float(np.abs(Xc - Xp).max()),
            "trees_on_card_matrix": trees,
            "winner_card": card.selected_model().summary["bestModel"],
            "winner_cpu": cpu.selected_model().summary["bestModel"]}


def house_dataset(n=HOUSE_ROWS, seed=0):
    """``examples/op_house_log.py::make_dataset`` with the port's
    Dataset."""
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import types as ft
    rng = np.random.default_rng(seed)
    sqft = rng.uniform(40, 400, n)
    rooms = rng.integers(1, 8, n).astype(float)
    age = rng.uniform(0, 80, n)
    first = ["James", "Mary", "Robert", "Elena", "Carlos", "Yuki",
             "Omar", "Linda"]
    last = ["Smith", "Garcia", "Lee", "Brown", "Davis", "Wilson"]
    seller = [f"{first[i % 8]} {last[i % 6]}" for i in range(n)]
    price = np.exp(10.0 + 0.004 * sqft + 0.08 * rooms - 0.003 * age
                   + 0.08 * rng.normal(size=n))
    return Dataset(
        {"sqft": sqft, "rooms": rooms, "age": age,
         "seller": np.asarray(seller, dtype=object), "price": price},
        {"sqft": ft.Real, "rooms": ft.Integral, "age": ft.Real,
         "seller": ft.Text, "price": ft.RealNN})


def house_workflow():
    """``examples/op_house_log.py::build_workflow`` with the port's
    imports."""
    from transmogrifai_tpu_torch import FeatureBuilder, models as M
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.ops import (PredictionDescaler,
                                             ScalerTransformer)
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.ops.vectorizers import (SmartTextVectorizer,
                                                         VectorsCombiner)
    from transmogrifai_tpu_torch.workflow import Workflow
    price = FeatureBuilder.of(ft.RealNN, "price").from_column() \
        .as_response()
    nums = [FeatureBuilder.of(t, n).from_column().as_predictor()
            for n, t in (("sqft", ft.Real), ("rooms", ft.Integral),
                         ("age", ft.Real))]
    seller = FeatureBuilder.of(ft.Text, "seller").from_column() \
        .as_predictor()
    log_price = ScalerTransformer(scaling_type="log") \
        .set_input(price).output
    seller_vec = SmartTextVectorizer(sensitive_feature_mode="remove") \
        .set_input(seller).output
    fv = VectorsCombiner().set_input(
        seller_vec, transmogrify(nums)).output
    pred = M.RegressionModelSelector.with_train_validation_split(
        train_ratio=0.75,
        candidates=[["LinearRegression", {"regParam": [0.001, 0.01]}],
                    ["GBTRegressor", None]],
    ).set_input(log_price, fv).output
    served = PredictionDescaler().set_input(pred, log_price).output
    return Workflow([served]), served


def house_part(device):
    """Part 3: ``examples/op_house_log.py`` through the port on
    ``device``: the seller column detected and removed (its verdict in
    ``sensitiveFeatureInformation``), predictions descaled to dollars
    (the example's median relative error bar), label-free row scoring."""
    from transmogrifai_tpu_torch.features import reset_uids
    from transmogrifai_tpu_torch.local import LocalScorer
    from transmogrifai_tpu_torch.models import kernels as tk
    reset_uids()
    ds = house_dataset()
    wf, served = house_workflow()
    tk.histogram_grid.launches = 0
    t0 = time.perf_counter()
    model = wf.train(ds, device=device)
    _sync_of(device)()
    wall = time.perf_counter() - t0
    launches = tk.histogram_grid.launches
    out = np.asarray(model.score(ds).column(served.name), np.float64)
    y = np.asarray(ds.column("price"), np.float64)
    rel = float(np.median(np.abs(out - y) / y))
    if not rel < HOUSE_MAX_REL_ERR:
        raise AssertionError(f"op_house_log median relative dollar error "
                             f"{rel} >= {HOUSE_MAX_REL_ERR}")
    sens = _sensitive(model)
    seller_vec = next(st for st in model.stages
                      if type(st).__name__ == "SmartTextModel")
    width = len(seller_vec.manifest())
    if width:
        raise AssertionError(f"the seller column kept {width} slots")
    row = {k: v for k, v in next(iter(ds.head(1).rows())).items()
           if k != "price"}
    local = LocalScorer(model, device=device)(row)[served.name]
    if not (np.isfinite(local) and abs(local - out[0]) <= 1e-3 * out[0]):
        raise AssertionError(f"label-free row score {local} vs bulk "
                             f"{out[0]}")
    return {"train_wall_s": wall, "median_rel_dollar_error": rel,
            "sensitive": sens, "seller_slots": width,
            "label_free_row_score": float(local),
            "histogram_launches": launches,
            "winner": model.selected_model().summary["bestModel"]}


def artifact_part(device):
    """Part 4: the workflow the JAX package saved on the CPU
    (``tests/data/jax_features_model``: parsers, a map vectorizer,
    OpLDA, a RawFeatureFilter summary) loaded by the port on
    ``device``; its scores against the JAX package's stored beside it
    (ARTIFACT_RTOL)."""
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    base = _repo_file(*JAX_ARTIFACT)
    model = WorkflowModel.load(os.path.join(base, "model"), device=device)
    with open(os.path.join(base, "rows.json")) as f:
        rows = json.load(f)
    with open(os.path.join(base, "scores.json")) as f:
        want = np.asarray(json.load(f), np.float64)
    got = _first_probs(model, rows)
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-12)))
    if not err <= ARTIFACT_RTOL:
        raise AssertionError(f"the JAX artifact's scores differ by rtol "
                             f"{err}")
    kinds = sorted({type(st).__name__ for st in model.stages})
    for need in ("LDAModel", "EmailToPickList", "RealMapModel"):
        if need not in kinds:
            raise AssertionError(f"the JAX artifact holds no {need}")
    if "rawFeatureFilter" not in model.train_summaries:
        raise AssertionError("the JAX artifact has no rawFeatureFilter "
                             "summary")
    return {"rows": len(rows), "max_rel_err": err, "stages": kinds}


def _part_done(name: str, t0: float) -> float:
    wall = time.perf_counter() - t0
    print(f"phase features: part {name} done in {wall:.3f} s", flush=True)
    return wall


def features_phase(seed: int, device="cuda", crm_rows=FEAT_CRM_RUN_ROWS,
                   every_rows=FEAT_EVERY_ROWS, parity_rows=FEAT_PARITY_ROWS,
                   lda_docs=LDA_DOCS, candidates=None, check=None):
    """Every feature type through transmogrify on ``device``: the wide
    CRM workflow, the every-type workflow, OpLDA alone, the every-type
    card-vs-CPU gate, op_house_log and the JAX artifact. The sizes and
    ``candidates`` (in place of the two default lists) exist for a CPU
    rehearsal."""
    import shutil
    import tempfile
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    workdir = tempfile.mkdtemp(prefix="tm_features_phase_")
    before = {"fused_linear_scores": sk.fused_linear_scores.launches,
              "ring_allreduce": tk.ring_allreduce.launches}
    walls = {}
    try:
        t0 = time.perf_counter()
        cut = crm_rows if crm_rows < FEAT_CRM_ROWS else None
        crm = crm_part(seed, device, workdir, crm_rows,
                       cut_from=FEAT_CRM_ROWS if cut else None,
                       candidates=candidates)
        walls["crm"] = _part_done("crm", t0)
        t0 = time.perf_counter()
        every = every_part(seed, device, workdir, every_rows, candidates)
        walls["every_type"] = _part_done("every_type", t0)
        t0 = time.perf_counter()
        lda_out = lda_part(seed, device, lda_docs)
        walls["lda"] = _part_done("lda", t0)
        t0 = time.perf_counter()
        parity = parity_part(seed, device, parity_rows, check=check)
        walls["parity"] = _part_done("parity", t0)
        t0 = time.perf_counter()
        house = house_part(device)
        walls["house"] = _part_done("house", t0)
        t0 = time.perf_counter()
        art = artifact_part(device)
        walls["artifact"] = _part_done("artifact", t0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    others = {"fused_linear_scores": sk.fused_linear_scores.launches
              - before["fused_linear_scores"],
              "ring_allreduce": tk.ring_allreduce.launches
              - before["ring_allreduce"]}
    if any(others.values()):
        raise AssertionError(f"the features phase launched {others}")
    hist = (crm["automl"]["histogram_launches"]
            + crm["default_list"]["histogram_launches"]
            + every["histogram_launches"] + house["histogram_launches"])
    checks = [r["hist_check"] for r in (crm["automl"], crm["default_list"],
                                        every) if r["hist_check"]]
    return {"crm": crm, "every_type": every, "lda": lda_out,
            "parity": parity, "house": house, "artifact": art,
            "walls_s": walls, "histogram_launches": hist,
            "hist_checks": checks,
            "launches": dict(others, tree_histogram=hist)}


def features_lines(fe) -> list:
    """One line per reported number of the features phase, each taken
    from its result ``fe``."""
    out = []
    crm = fe["crm"]
    cut = (f" (cut from {crm['rows_cut_from']})"
           if crm["rows_cut_from"] else "")
    out.append(f"phase features: crm rows {crm['rows']}{cut}, "
               f"{crm['predictors']} predictors")
    for name in ("automl", "default_list"):
        r = crm[name]
        for label, key, unit in (
                ("vectorizer fits", "feature_layer_fit_s", "s"),
                ("checker", "checker_fit_s", "s"),
                ("selector", "selector_fit_s", "s"),
                ("Workflow.train", "train_wall_s", "s"),
                ("histogram launches", "histogram_launches", ""),
                ("device busy share", "device_busy_share", ""),
                ("save/load", "save_load_wall_s", "s"),
                ("bulk score", "score_rows_per_s", "rows/s"),
                ("LocalScorer max abs err", "local_max_abs_err",
                 f"(atol {FEAT_LOCAL_ATOL}, {r['local_rows']} rows)")):
            out.append(f"phase features: crm {name} {label}: "
                       f"{json.dumps(r[key])} {unit}".rstrip())
    ev = fe["every_type"]
    for label, value in (("rows", ev["rows"]),
                         ("data wall", ev["data_wall_s"]),
                         ("kept slots", ev["kept_slots"]),
                         ("winner", ev["winner"]),
                         ("holdout AUROC", ev["holdout_auroc"]),
                         ("sensitive", ev["sensitive"]),
                         ("histogram launches", ev["histogram_launches"]),
                         ("Workflow.train", ev["train_wall_s"]),
                         ("device busy share", ev["device_busy_share"])):
        out.append(f"phase features: every_type {label}: "
                   f"{json.dumps(value)}")
    for r in fe["hist_checks"]:
        out.append(f"phase features: tree_histogram at the {r['shape']} "
                   f"train's largest level (G, n, d, S, m, B) = "
                   f"{[r[k] for k in ('G', 'n', 'd', 'S', 'm', 'B')]} "
                   f"({r['levels']} levels, {r['distinct_shapes']} shapes), "
                   f"{r['dtype']} operands, against its plain version: max "
                   f"abs err {r['max_abs_err']} (each cell within "
                   f"{HIST_RTOL} of the sum of its |terms|)")
    la = fe["lda"]
    if la is not None:
        out.append(f"phase features: OpLDA fit {la['shape']} wall "
                   f"{la['wall_ms']} ms, device {la.get('device_ms')} ms "
                   f"in {la.get('device_ops')} operations, bound "
                   f"{la['bound_ms']} ms ({la['bound_by']}), no host sync: "
                   f"{la.get('sync_free')}")
    pa = fe["parity"]
    out.append(f"phase features: card vs CPU at {pa['rows']} rows "
               f"(TM_KERNEL_EXACT=1): lambda largest |gap| "
               f"{pa['lam_max_abs_gap']}, largest |gap|/|lambda| over "
               f"entries {pa['lam_max_rel_gap']} (each entry within rtol "
               f"{LDA_LAM_RTOL} + {LDA_LAM_ATOL_SCALE} x max|lambda|), "
               f"checked matrices {pa['matrix_max_abs_gap']} apart, "
               f"workflow CV gaps {json.dumps(pa['cv_gap'])} (LR "
               f"{LINEAR_CPU_TOL['binary']}, DT/GBT {GBT_PARITY_TOL})")
    for fam, t in pa["trees_on_card_matrix"].items():
        out.append(f"phase features: {fam} on the card's matrix, card vs "
                   f"CPU: AUROC gap {t['metric_max_diff']}, gain gap "
                   f"{t['gain_gap_max']}, histograms {t['hist_diff_max']} "
                   f"(AUROC {TITANIC_CV_ATOL}, or the near-tie contract: "
                   f"gain gap {GBT_GAP_RTOL}, histograms {GBT_HIST_RTOL}, "
                   f"AUROC {GBT_PARITY_TOL}); each side's metrics "
                   f"recomputed on its own matrix")
    ho = fe["house"]
    out.append(f"phase features: op_house_log median relative dollar "
               f"error {ho['median_rel_dollar_error']} (< "
               f"{HOUSE_MAX_REL_ERR}), seller slots {ho['seller_slots']}, "
               f"label-free row score {ho['label_free_row_score']}")
    ar = fe["artifact"]
    out.append(f"phase features: JAX artifact {ar['rows']} rows, max rel "
               f"err {ar['max_rel_err']} (rtol {ARTIFACT_RTOL})")
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 11: the serving tier — fleets on both transports, the CLI, continuum
# ---------------------------------------------------------------------------

#: the JAX bench's fleet_failover settings (bench.py:1154-1159, :1169):
#: replicas, open-loop Poisson rate, steady and post-kill seconds, the
#: "during failover" window after the kill, buckets, rows a request
FLEET_REPLICAS = 4
FLEET_RPS = 60.0
FLEET_STEADY_S = 5.0
FLEET_FAILOVER_S = 5.0
FLEET_WINDOW_S = 2.0
FLEET_BUCKETS = (64, 256)
FLEET_MAX_ROWS = 16
#: seconds of further load under torch.profiler (device activity only,
#: so the timed storm pays no tracing) for the busy share and the
#: profiler's count of kernel launches
FLEET_BUSY_S = 3.0
#: requests after the rollout (half to the default, v2)
FLEET_V2_REQUESTS = 96
#: the JAX bench's cross_host_load settings (bench.py:2304-2324, :2411),
#: without its emulated dispatch hang: the card does the work
XHOST_WORKERS = 2
XHOST_RPS = 250.0
XHOST_DURATION_S = 4.0
XHOST_DEADLINE_MS = 400.0
XHOST_MAX_ROWS = 8
#: "during failover" after the kill -9 (the run's second half: the
#: rest is "recovered")
XHOST_WINDOW_S = 1.0
#: the CLI and continuum legs: an LR workflow over the same 12 columns
FLEET_WF_ROWS = 4_000
CLI_REQUESTS = 64
CLI_CLIENTS = 8
CLI_REPLICAS = 2
#: served rows against the in-process WorkflowModel.score
CLI_ATOL = 1e-5
#: an answer against the same request scored alone through its plane's
#: scorer: bitwise, unless the kernel's bits depend on how micro-batches
#: are composed (then this bound, reported as a finding)
FLEET_REF_ATOL = 1e-6
FLEET_TIMEOUT_S = 120.0
#: /metricsz families the phase's scrapes must carry together
FLEET_METRIC_FAMILIES = ("tm_fleet_", "tm_transport_", "tm_continuum_")


def write_portable(path: str, manifest, arrays) -> None:
    """One portable artifact directory (manifest.json + params.npz,
    stamped complete), as ``export_portable`` writes it."""
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.resilience import atomic
    os.makedirs(path, exist_ok=True)
    atomic.atomic_write_json(os.path.join(path, "manifest.json"), manifest)
    flat = {}
    for sid, tree in arrays.items():
        for key, val in portable.flatten_tree(tree).items():
            flat[f"{sid}/{key}"] = np.asarray(val)
    atomic.atomic_write_npz(os.path.join(path, "params.npz"), flat)
    atomic.mark_complete(path)


#: the result column of the registry default (v1, then v2 after the
#: rollout): one name, so only the weights tell the versions apart
DEFAULT_RESULT = "pred_default"


def write_catalog(root: str, seed: int):
    """The serving phase's 100-id catalog (build_catalog's draws) as a
    registry root: m000..m003 portable artifacts and 96 aliases in
    registry.json, so both transports load it by path, plus the
    registry default ``v1`` (an LR model of the same layout, the first
    draw from ``seed`` + 1), which the rollout replaces. Returns
    {model id: (result name, oracle parameters)}, the default under
    ``None``."""
    from transmogrifai_tpu_torch.portable_export import (
        write_registry_manifest)
    rng = np.random.default_rng(seed)
    backends = {}
    for k in range(N_BACKENDS):
        name = f"m{k:03d}"
        manifest, arrays, par = make_model_ir(rng, f"pred_{name}")
        manifest["scoreBuckets"] = list(FLEET_BUCKETS)
        write_portable(os.path.join(root, name), manifest, arrays)
        backends[name] = (f"pred_{name}", par)
    manifest, arrays, par = make_model_ir(np.random.default_rng(seed + 1),
                                          DEFAULT_RESULT)
    manifest["scoreBuckets"] = list(FLEET_BUCKETS)
    write_portable(os.path.join(root, "v1"), manifest, arrays)
    aliases = {f"m{k:03d}": f"m{k % N_BACKENDS:03d}"
               for k in range(N_BACKENDS, N_MODELS)}
    write_registry_manifest(root, default="v1", aliases=aliases)
    catalog = dict(backends)
    catalog.update({a: backends[t] for a, t in aliases.items()})
    catalog[None] = (DEFAULT_RESULT, par)
    return catalog


def write_v2(path: str, seed: int):
    """The rollout's v2: the second draw from ``seed`` + 1, in v1's
    layout and under its result name. Returns (result name, oracle
    parameters)."""
    rng = np.random.default_rng(seed + 1)
    make_model_ir(rng, DEFAULT_RESULT)          # v1's draw
    manifest, arrays, par = make_model_ir(rng, DEFAULT_RESULT)
    manifest["scoreBuckets"] = list(FLEET_BUCKETS)
    write_portable(path, manifest, arrays)
    return DEFAULT_RESULT, par


def poisson_arrivals(duration_s: float, rps: float, seed: int):
    """Arrival times of a Poisson process at ``rps`` over
    ``duration_s`` (bench.py::_poisson_arrivals, one segment)."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / rps))
        if t >= duration_s:
            return out
        out.append(t)


def fleet_requests(seed: int, n: int, ids, max_rows: int,
                   default_share: float = 0.0):
    """``n`` requests of 1..max_rows rows of the catalog's 12 columns
    (5% missing), model ids Zipf(1.1) over ``ids``; a ``default_share``
    of them name no model (the registry default)."""
    rng = np.random.default_rng(seed)
    pz = 1.0 / np.arange(1, len(ids) + 1) ** ZIPF_A
    picks = rng.choice(len(ids), size=n, p=pz / pz.sum())
    out = []
    for j in picks:
        rows = int(rng.integers(1, max_rows + 1))
        cols = {f"x{i}": np.where(rng.random(rows) < 0.05, np.nan,
                                  rng.normal(size=rows))
                for i in range(N_COLUMNS)}
        model = None if rng.random() < default_share else ids[j]
        out.append((model, cols))
    return out


def open_loop(submit, reqs, arrivals, timeout: float = FLEET_TIMEOUT_S):
    """Open-loop drive (bench.py::_open_loop_drive): sleep to each
    arrival, ``submit(cols, model)``, book arrival-to-completion
    latency. Returns (records [(due s, latency s, future or the
    submit's exception)], futures, requests never resolved)."""
    from concurrent.futures import wait
    recs = [None] * len(arrivals)
    futs = []
    t0 = time.perf_counter()
    for i, due in enumerate(arrivals):
        lag = due - (time.perf_counter() - t0)
        if lag > 0:
            time.sleep(lag)
        model, cols = reqs[i]
        try:
            fut = submit(cols, model)
        except Exception as e:      # noqa: BLE001 — a client error
            recs[i] = (due, 0.0, e)
            continue

        def done(f, i=i, due=due):
            recs[i] = (due, time.perf_counter() - t0 - due, f)

        fut.add_done_callback(done)
        futs.append(fut)
    _done, not_done = wait(futs, timeout=timeout)
    deadline = time.perf_counter() + 5.0
    while any(r is None for r in recs) and time.perf_counter() < deadline:
        time.sleep(0.01)            # done-callbacks run after waiters wake
    return recs, futs, len(not_done)


def _outcome(rec):
    """(result dict or None, exception or None) of one record."""
    if rec is None:
        return None, TimeoutError("never resolved")
    what = rec[2]
    if isinstance(what, BaseException):
        return None, what
    exc = what.exception()
    return (None, exc) if exc is not None else (what.result(), None)


class PlaneReference:
    """Each request scored alone through either plane by one engine's
    scorers, built from the same artifacts on the same device: the
    classic plane (the version's own scorer, launch + finalize) and the
    fused plane (one FusedGroupScorer pass over every catalog backend,
    the engine's canonical member order, the request's rows under its
    model's index)."""

    def __init__(self, root: str, device, v2_path=None):
        from transmogrifai_tpu_torch.serving import build_registry
        from transmogrifai_tpu_torch.serving.fusion import (
            FusedGroupScorer, stack_spec_of)
        self.reg = build_registry(root, buckets=FLEET_BUCKETS,
                                  device=device)
        names = [f"m{k:03d}" for k in range(N_BACKENDS)] + ["v1"]
        if v2_path is not None:
            self.reg.register("v2", v2_path, buckets=FLEET_BUCKETS,
                              device=device)
            names.append("v2")
        self.backends = {}
        for name in names:
            with self.reg.acquire(name) as (_v, backend):
                self.backends[name] = backend
        order = sorted(names)
        self.pos = {n: i for i, n in enumerate(order)}
        self.fused = FusedGroupScorer(
            [(self.backends[n], stack_spec_of(self.backends[n]))
             for n in order])

    def version(self, model) -> str:
        """``None``: the fleet's default after the rollout when a v2
        is registered, else v1."""
        if model is None:
            return "v2" if "v2" in self.backends else "v1"
        return self.reg.resolve(model)

    def classic(self, model, cols):
        b = self.backends[self.version(model)]
        n, vals = b.prepare(cols)
        return b.finalize(b.launch(n, vals))

    def fused_pass(self, model, cols):
        name = self.version(model)
        b = self.backends[name]
        n, vals = b.prepare(cols)
        mid = np.full(n, self.pos[name], np.int32)
        return self.fused.finalize(self.fused.launch(n, vals, mid))


def _against_reference(ref: PlaneReference, model, cols, res, name):
    """Which plane's alone-scoring ``res[name]`` equals: ("fused" |
    "classic", bitwise?, max abs err against it)."""
    got = np.asarray(res[name])
    cands = {"fused": ref.fused_pass(model, cols),
             "classic": ref.classic(model, cols)[name]}
    errs = {k: float(np.abs(got - np.asarray(v)).max())
            for k, v in cands.items()}
    plane = min(errs, key=errs.get)
    return plane, errs[plane] == 0.0, errs[plane]


def _check_answer(model, cols, res, catalog, bf16: bool, plane: str):
    """Max abs err of one answer against its model's numpy score under
    its plane's operand policy; raises past SERVE_ATOL."""
    name, par = catalog[model]
    if name not in res:
        raise AssertionError(
            f"an answer for {model} lacks {name}: another version "
            f"served it ({sorted(res)})")
    want = oracle_probs(cols, par, bf16 and plane == "fused")
    err = float(np.abs(np.asarray(res[name]) - want).max())
    if not err <= SERVE_ATOL:
        raise AssertionError(
            f"a fleet answer for {model} ({plane} plane) is {err} from "
            f"its numpy score")
    return err


def _phase_latency(recs, kill_at: float, window_s: float):
    phases = {"steady": [], "failover": [], "recovered": []}
    for due, lat, _f in recs:
        phase = ("steady" if due < kill_at else
                 "failover" if due < kill_at + window_s else "recovered")
        phases[phase].append(lat * 1e3)
    from transmogrifai_tpu_torch.profiling import percentile_nearest_rank
    out = {}
    for phase, lats in phases.items():
        lats.sort()
        out[f"{phase}_requests"] = len(lats)
        out[f"{phase}_p50_ms"] = (percentile_nearest_rank(lats, 0.5)
                                  if lats else None)
        out[f"{phase}_p99_ms"] = (percentile_nearest_rank(lats, 0.99)
                                  if lats else None)
    return out


def _kernel_events(prof) -> int:
    """Launches of the fused serving kernel in a torch.profiler trace."""
    from torch.autograd import DeviceType
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and "fused_scores_kernel" in ev.key)


def inproc_fleet_part(seed, device, root, catalog, v2, *,
                      replicas=FLEET_REPLICAS, rps=FLEET_RPS,
                      steady_s=FLEET_STEADY_S, failover_s=FLEET_FAILOVER_S,
                      window_s=FLEET_WINDOW_S, busy_s=FLEET_BUSY_S,
                      v2_requests=FLEET_V2_REQUESTS, fault=None):
    """The inproc fleet under failover: ``replicas`` replicas of the
    registry root at ``root`` on ``device``, open-loop Poisson arrivals
    at ``rps`` of 1-16 rows, the busiest replica hard-killed after
    ``steady_s``, ``failover_s`` more; on the card ``busy_s`` more
    under torch.profiler (its kernel launches counted by the profiler
    must equal the wrapper's count); then a staged rollout to v2 and
    ``v2_requests`` requests, half to the default. Every answer is held
    to numpy under the operand policy of the plane its spans name and,
    bit for bit, to the same request scored alone through that plane.
    ``fault`` plants a defect the gates must catch ("v1_after_rollout":
    one replica keeps v1 as its default after the rollout; "lost": one
    answer dropped). Returns the part's measurements."""
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.serving import (EngineConfig, FleetConfig,
                                                 ServingFleet)
    from transmogrifai_tpu_torch.telemetry import spans as tspans
    from transmogrifai_tpu_torch.telemetry.spans import TRACER
    on_card = device.type == "cuda"
    ids = sorted(k for k in catalog if k is not None)
    arrivals = poisson_arrivals(steady_s + failover_s, rps, seed + 29)
    reqs = fleet_requests(seed + 3, len(arrivals), ids, FLEET_MAX_ROWS)
    cfg = FleetConfig(replicas=replicas, supervise_s=0.05,
                      breaker_open_s=0.3, restart_backoff_s=0.2,
                      backoff_s=0.005, rollout_bake_s=2.0,
                      rollout_min_requests=16, rollout_p99_floor_ms=60.0)
    ecfg = EngineConfig(max_wait_ms=2.0, fused_kernel=True)
    old_tracer = (TRACER.sample, TRACER.capacity)
    tspans.configure(sample=1.0, capacity=1 << 17)
    v2_path, (v2_name, v2_par) = v2
    cat2 = dict(catalog)
    cat2[None] = (v2_name, v2_par)
    try:
        with ServingFleet(root, replicas=replicas, buckets=FLEET_BUCKETS,
                          config=cfg, engine_config=ecfg,
                          device=device) as fleet:
            for i in range(8):          # first touch, untimed
                fleet.score(reqs[i][1], version=reqs[i][0],
                            timeout=FLEET_TIMEOUT_S)
            TRACER.clear()
            kill = {}
            t_start = time.perf_counter()

            def killer():
                time.sleep(steady_s)
                disp = fleet.status()["fleet"]["dispatches"]
                name = max(disp, key=disp.get) if disp else "r0"
                kill.update(name=name, at=time.perf_counter() - t_start)
                fleet.chaos_kill(name, reason="chip_smoke fleet drill")

            def submit(c, m):
                return fleet.submit(c, version=m)

            sk.fused_linear_scores.launches = 0
            t0 = time.perf_counter()
            kt = threading.Thread(target=killer)
            kt.start()
            recs, futs, lost = open_loop(submit, reqs, arrivals)
            kt.join()
            storm_wall = time.perf_counter() - t0
            h = fleet._handle(kill["name"])
            deadline = time.perf_counter() + 60
            while (h.dead or h.restarts < 1) and \
                    time.perf_counter() < deadline:
                time.sleep(0.05)
            restarted = h.restarts >= 1 and not h.dead
            busy_reqs, busy_recs = [], []
            busy_us = events = prof_launches = busy_wall = None
            window_launches = 0
            if on_card:
                barr = poisson_arrivals(busy_s, rps, seed + 37)
                busy_reqs = fleet_requests(seed + 11, len(barr), ids,
                                           FLEET_MAX_ROWS)
                before = sk.fused_linear_scores.launches

                def window():
                    t1 = time.perf_counter()
                    out = open_loop(submit, busy_reqs, barr)
                    return out, time.perf_counter() - t1

                # the wall inside the profiled run: the profiler's start
                # and stop are not the storm's
                prof, ((busy_recs, _bf, busy_lost), busy_wall) = profiled(
                    window, host=False)
                window_launches = sk.fused_linear_scores.launches - before
                lost += busy_lost
                busy_us, events = _device_time_us(prof)
                prof_launches = _kernel_events(prof)
            # the staged rollout to v2, under traffic from a pump
            report = {}
            stop = threading.Event()
            pump_errors = []

            def pump():
                k = 0
                while not stop.is_set():
                    m, c = reqs[k % len(reqs)]
                    try:
                        fleet.score(c, version=None if k % 2 else m,
                                    timeout=FLEET_TIMEOUT_S)
                    except Exception as e:  # noqa: BLE001 — gated below
                        pump_errors.append(e)
                    k += 1
                    time.sleep(0.005)

            pt = threading.Thread(target=pump)
            pt.start()
            try:
                report = fleet.rollout("v2", v2_path)
            finally:
                stop.set()
                pt.join()
            if fault == "v1_after_rollout":
                # one replica goes back to v1's weights under the default
                reg0 = fleet.replica_handles()[0].engine.registry
                reg0.register("v1_again", os.path.join(root, "v1"),
                              buckets=FLEET_BUCKETS, device=device)
                reg0.set_default("v1_again")
            v2_reqs = fleet_requests(seed + 5, v2_requests, ids,
                                     FLEET_MAX_ROWS, default_share=0.5)
            v2_futs = [fleet.submit(c, version=m) for m, c in v2_reqs]
            v2_res = [f.result(FLEET_TIMEOUT_S) for f in v2_futs]
            launches = sk.fused_linear_scores.launches
            status = fleet.status()
            spans = TRACER.spans()
    finally:
        tspans.configure(sample=old_tracer[0], capacity=old_tracer[1])
    if fault == "lost":
        recs[len(recs) // 2] = None

    # -- gates -----------------------------------------------------------
    errors = [e for e in (_outcome(r)[1] for r in recs + busy_recs)
              if e is not None]
    if lost or errors or pump_errors:
        raise AssertionError(
            f"inproc fleet: {lost} requests lost, {len(errors)} client "
            f"errors ({errors[:1]}), {len(pump_errors)} rollout-traffic "
            f"errors")
    if not restarted:
        raise AssertionError(f"killed replica {kill['name']} did not "
                             f"restart")
    if report.get("rolled_back"):
        raise AssertionError(f"the rollout to v2 rolled back: "
                             f"{report.get('reason')}")
    timed = list(zip(reqs, recs)) + list(zip(busy_reqs, busy_recs))
    traces = [tspans.get_trace(r[2]) for _q, r in timed] + \
        [tspans.get_trace(f) for f in v2_futs]
    if any(t is None for t in traces):
        raise AssertionError("a routed request carries no trace id")
    plane, fused_spans = _served_planes(spans, traces)
    bf16 = sk.serve_dtype(device) == torch.bfloat16
    ref = PlaneReference(root, device, v2_path)
    matched = {"fused": 0, "classic": 0}
    bitwise = {"fused": 0, "classic": 0}
    max_ref_err = max_err = 0.0
    answers = [(m, c, _outcome(r)[0], t) for ((m, c), r), t in
               zip(timed, traces)] + [
        (m, c, res, t) for (m, c), res, t in
        zip(v2_reqs, v2_res, traces[len(timed):])]
    for m, c, res, tid in answers:
        how = plane[tid]
        name = cat2[m][0]
        max_err = max(max_err, _check_answer(m, c, res, cat2, bf16, how))
        want = (ref.fused_pass(m, c) if how == "fused"
                else ref.classic(m, c)[name])
        err = float(np.abs(np.asarray(res[name]) - np.asarray(want)).max())
        if not err <= FLEET_REF_ATOL:
            raise AssertionError(
                f"a fleet answer for {m or ref.version(None)} is {err} "
                f"from the same request scored alone through the {how} "
                f"plane")
        matched[how] += 1
        bitwise[how] += err == 0.0
        max_ref_err = max(max_ref_err, err)
    fl = status["fleet"]
    per = {}
    fused_total = 0
    for rname, snap in status["replicas"].items():
        eng = snap.get("engine") or {}
        if eng.get("fused_fallbacks"):
            raise AssertionError(f"replica {rname}: "
                                 f"{eng['fused_fallbacks']} fused fallbacks")
        if snap.get("device", {}).get("device") is None or \
                torch.device(snap["device"]["device"]).type != device.type:
            raise AssertionError(f"replica {rname} serves on "
                                 f"{snap.get('device')}, not {device}")
        per[rname] = {"completed": eng.get("completed"),
                      "fused_batches": eng.get("fused_batches"),
                      "fused_requests": eng.get("fused_requests"),
                      "fused_fallbacks": eng.get("fused_fallbacks"),
                      "restarts": snap["supervision"]["restarts"]}
        fused_total += eng.get("fused_batches") or 0
    fused_slices = sum(max(1, -(-s["attrs"]["rows"] // FLEET_BUCKETS[-1]))
                       for s in fused_spans)
    if not fused_slices:
        raise AssertionError("the inproc fleet never ran a fused pass")
    want_launches = fused_slices if on_card else 0
    if launches != want_launches:
        raise AssertionError(f"the fused kernel launched {launches} times "
                             f"for {fused_slices} fused bucket slices")
    if prof_launches is not None and prof_launches != window_launches:
        raise AssertionError(f"the profiler saw {prof_launches} fused "
                             f"kernel launches in its window, the "
                             f"wrapper counted {window_launches}")
    rows = sum(len(c["x0"]) for _m, c in reqs)
    out = {"replicas": replicas, "offered_rps": rps,
           "requests": len(recs), "rows": rows,
           "rows_per_s": rows / storm_wall, "storm_wall_s": storm_wall,
           "killed_replica": kill["name"], "kill_at_s": kill["at"],
           "lost_requests": lost, "client_errors": len(errors),
           "failovers": fl["failovers"], "breaker_opens": fl["breaker_opens"],
           "breaker_closes": fl["breaker_closes"],
           "breaker_probes": fl.get("breaker_probes"),
           "replica_crashes": fl["replica_crashes"],
           "replica_restarts": fl["replica_restarts"],
           "rollout": {"rolled_back": report.get("rolled_back"),
                       "replicas": {k: {"ok": v.get("ok"),
                                        "served": v.get("served")}
                                    for k, v in report["replicas"].items()}},
           "v2_requests": len(v2_reqs),
           "v2_default_requests": sum(m is None for m, _c in v2_reqs),
           "matched": matched, "bitwise_alone": bitwise,
           "max_abs_err_vs_numpy": max_err,
           "max_abs_err_vs_alone": max_ref_err,
           "kernel_launches": launches,
           "profiler_kernel_launches": prof_launches,
           "profiled_window_launches": window_launches,
           "busy_window_s": busy_wall,
           "busy_window_requests": len(busy_reqs),
           "ejections": fl.get("ejections"), "hedges": fl.get("hedges"),
           "retries": fl.get("retries"),
           "fused_slices": fused_slices, "fused_batches": fused_total,
           "per_replica": per,
           "device_busy_s": None if busy_us is None else busy_us / 1e6,
           "device_busy_share": (None if busy_us is None
                                 else busy_us / 1e6 / busy_wall),
           "device_events": events}
    out.update(_phase_latency(recs, kill["at"], window_s))
    return out


def socket_fleet_part(seed, device, root, catalog, *,
                      workers=XHOST_WORKERS, rps=XHOST_RPS,
                      duration_s=XHOST_DURATION_S,
                      deadline_ms=XHOST_DEADLINE_MS,
                      window_s=XHOST_WINDOW_S):
    """Socket workers under a kill -9: ``workers`` worker processes
    serving the registry root on ``device`` (each its own CUDA context
    on the same card), open-loop Poisson at ``rps`` of 1-8 rows for
    ``duration_s`` with a ``deadline_ms`` deadline, the busiest worker
    SIGKILLed halfway. Every answer is held to numpy and, bit for bit,
    to the same request scored alone through one plane (the inproc
    fleet's gate); each worker's status must name ``device`` and, on
    the card, a fused launch count equal to its fused passes, with no
    fallback (``check_workers``); the restarted worker must serve
    again. Returns the part's measurements (latency phases split at
    the kill and ``window_s`` after it)."""
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.serving import (FleetConfig, HealthServer,
                                                 ServingFleet)
    from transmogrifai_tpu_torch.serving.transport import TransportConfig
    on_card = device.type == "cuda"
    ids = sorted(k for k in catalog if k is not None)
    arrivals = poisson_arrivals(duration_s, rps, seed + 31)
    reqs = fleet_requests(seed + 7, len(arrivals), ids, XHOST_MAX_ROWS)
    cfg = FleetConfig(replicas=workers, supervise_s=0.05,
                      breaker_open_s=0.3, restart_backoff_s=0.2,
                      backoff_s=0.005)
    env = {"TM_SERVE_FUSED_KERNEL": "1", "TM_ENGINE_MAX_WAIT_MS": "2.0"}
    t0 = time.perf_counter()
    with ServingFleet(root, replicas=workers, buckets=FLEET_BUCKETS,
                      config=cfg, transport="socket", worker_env=env,
                      transport_config=TransportConfig(spawn_timeout_s=180),
                      device=device) as fleet:
        spawn_s = time.perf_counter() - t0
        # every backend loaded in each worker and the admission latency
        # model seeded by warm passes, untimed
        for i in range(8 * workers):
            fleet.score(reqs[i % len(reqs)][1],
                        version=f"m{i % N_BACKENDS:03d}",
                        timeout=FLEET_TIMEOUT_S)
        kill = {}
        t_start = time.perf_counter()

        def killer():
            time.sleep(duration_s / 2)
            disp = fleet.status()["fleet"]["dispatches"]
            name = max(disp, key=disp.get) if disp else "r0"
            h = fleet._handle(name)
            kill.update(name=name, at=time.perf_counter() - t_start,
                        before=h.transport.status_snapshot())
            fleet.chaos_kill(name, reason="chip_smoke kill -9")

        kt = threading.Thread(target=killer)
        kt.start()
        recs, futs, lost = open_loop(
            lambda c, m: fleet.submit(c, version=m,
                                      deadline_ms=deadline_ms),
            reqs, arrivals)
        kt.join()
        wall = time.perf_counter() - t_start
        h = fleet._handle(kill["name"])
        deadline = time.perf_counter() + 120
        while (h.dead or h.restarts < 1 or not h.transport.live()) and \
                time.perf_counter() < deadline:
            time.sleep(0.05)
        if h.dead or h.restarts < 1:
            raise AssertionError(f"killed worker {kill['name']} did not "
                                 f"restart")
        served_before = h.transport.outcome_counters()["completed"]
        after = fleet_requests(seed + 9, 64, ids, XHOST_MAX_ROWS)
        deadline = time.perf_counter() + 30
        while time.perf_counter() < deadline:
            # bursts, so the restarted worker's passes co-batch several
            # backends (fused) as under load
            for f in [fleet.submit(c, version=m) for m, c in after]:
                f.result(FLEET_TIMEOUT_S)
            eng = h.transport.status_snapshot()["engine"]
            if eng["completed"] > served_before and (
                    eng["fused_batches"] or not on_card):
                break
        served_again = (h.transport.outcome_counters()["completed"]
                        - served_before)
        health = HealthServer(fleet).start()
        try:
            import urllib.request
            scrape = urllib.request.urlopen(
                f"http://127.0.0.1:{health.port}/metricsz",
                timeout=30).read().decode()
        finally:
            health.stop()
        snaps = {x.name: x.transport.status_snapshot()
                 for x in fleet.replica_handles()}
        wire = {x.name: x.transport.stats.as_dict()
                for x in fleet.replica_handles()}
        status = fleet.status()

    errors = [e for e in (_outcome(r)[1] for r in recs) if e is not None]
    if lost or errors:
        raise AssertionError(f"socket fleet: {lost} requests lost, "
                             f"{len(errors)} client errors ({errors[:1]})")
    if served_again <= 0:
        raise AssertionError(f"restarted worker {kill['name']} served "
                             f"nothing")
    bf16 = sk.serve_dtype(device) == torch.bfloat16
    ref = PlaneReference(root, device)
    planes = {"fused": 0, "classic": 0}
    bitwise = 0
    max_err = max_ref_err = 0.0
    for (m, c), r in zip(reqs, recs):
        res = _outcome(r)[0]
        name = catalog[m][0]
        how, exact, err = _against_reference(ref, m, c, res, name)
        if not err <= FLEET_REF_ATOL:
            raise AssertionError(
                f"a socket answer for {m} is {err} from the same request "
                f"scored alone through either plane")
        max_err = max(max_err, _check_answer(m, c, res, catalog, bf16, how))
        planes[how] += 1
        bitwise += exact
        max_ref_err = max(max_ref_err, err)
    workers_out = check_workers(snaps, device)
    for name, w in workers_out.items():
        w.update(wire_p50_us=wire[name].get("wire_p50_us"),
                 wire_p99_us=wire[name].get("wire_p99_us"))
    worker_launches = sum(w["launches"] for w in workers_out.values())
    before = kill["before"]
    killed_launches = (before.get("device") or {}).get(
        "kernels", {}).get("fused_linear_scores") or 0
    fl = status["fleet"]
    rows = sum(len(c["x0"]) for _m, c in reqs)
    out = {"workers": workers, "offered_rps": rps,
           "requests": len(recs), "rows": rows, "rows_per_s": rows / wall,
           "deadline_ms": deadline_ms, "spawn_s": spawn_s,
           "killed_worker": kill["name"], "kill_at_s": kill["at"],
           "lost_requests": lost, "client_errors": len(errors),
           "restarted_served": served_again,
           "ejections": fl.get("ejections"),
           "readmissions": fl.get("readmissions"),
           "hedges": fl.get("hedges"), "retries": fl.get("retries"),
           "supervision": {k: v.get("supervision")
                           for k, v in status["replicas"].items()},
           "failovers": fl["failovers"], "breaker_opens": fl["breaker_opens"],
           "breaker_closes": fl["breaker_closes"],
           "replica_crashes": fl["replica_crashes"],
           "replica_restarts": fl["replica_restarts"],
           "planes": planes, "bitwise_alone": bitwise,
           "max_abs_err_vs_numpy": max_err,
           "max_abs_err_vs_alone": max_ref_err,
           "worker_launches": worker_launches + killed_launches,
           "killed_worker_launches_before_kill": killed_launches,
           "per_worker": workers_out,
           "metricsz_families": sorted(
               {f for f in FLEET_METRIC_FAMILIES if f in scrape})}
    out.update(_phase_latency(recs, kill["at"], window_s))
    return out


def check_workers(snaps, device):
    """Each socket worker's status (``{name: status snapshot}``) must
    name ``device``, show no fused fallback and, on the card, a fused
    kernel launch for each of its fused passes (each pass holds at most
    the top bucket's rows: one slice); on the CPU none. Returns
    {name: the worker's numbers}; raises on the first that fails."""
    out = {}
    for name, snap in snaps.items():
        dev = snap.get("device") or {}
        eng = snap.get("engine") or {}
        launched = (dev.get("kernels") or {}).get("fused_linear_scores")
        if dev.get("device") is None or \
                torch.device(dev["device"]).type != device.type:
            raise AssertionError(f"worker {name} reports device "
                                 f"{dev.get('device')}, not {device}")
        if eng.get("fused_fallbacks"):
            raise AssertionError(f"worker {name}: "
                                 f"{eng['fused_fallbacks']} fused fallbacks")
        on_card = device.type == "cuda"
        want = eng.get("fused_batches") if on_card else 0
        if on_card and not launched:
            raise AssertionError(f"worker {name} launched no fused kernel")
        if launched != want:
            raise AssertionError(f"worker {name} launched the fused kernel "
                                 f"{launched} times for {want} fused passes")
        out[name] = {
            "device": dev.get("device"), "launches": launched,
            "fused_batches": eng.get("fused_batches"),
            "fused_fallbacks": eng.get("fused_fallbacks"),
            "completed": eng.get("completed"),
            "pid": snap.get("transport", {}).get("pid"),
            "generation": snap.get("transport", {}).get("generation")}
    return out


def wf_data(pkg, n: int, seed: int, shift: float = 0.0):
    """``n`` rows of the catalog's 12 Real columns (5% missing; x0
    shifted by ``shift``) with a logistic label: the LR workflow the
    CLI and continuum legs serve."""
    import importlib
    root = importlib.import_module(pkg)
    ft = root.features.types
    rng = np.random.default_rng(seed)
    cols = {f"x{i}": np.where(rng.random(n) < 0.05, np.nan,
                              rng.normal(size=n)) for i in range(N_COLUMNS)}
    z = np.nan_to_num(cols["x0"]) - np.nan_to_num(cols["x1"])
    cols["label"] = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    cols["x0"] = cols["x0"] + shift
    schema = {f"x{i}": ft.Real for i in range(N_COLUMNS)}
    schema["label"] = ft.RealNN
    return root.Dataset(cols, schema)


def wf_workflow():
    """The served LR workflow: the continuum test's recipe at 12
    columns (raw feature filter included, so the saved model carries
    the drift baseline)."""
    from transmogrifai_tpu_torch import FeatureBuilder
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.features import reset_uids, types as ft
    from transmogrifai_tpu_torch.ops.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.workflow import Workflow
    reset_uids()
    label = FeatureBuilder.of(ft.RealNN, "label").from_column().as_response()
    preds = [FeatureBuilder.of(ft.Real, f"x{i}").from_column().as_predictor()
             for i in range(N_COLUMNS)]
    pred = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=2, candidates=[["LogisticRegression",
                                {"regParam": [0.01],
                                 "elasticNetParam": [0.0]}]]
    ).set_input(label, SanityChecker().set_input(
        label, transmogrify(preds)).output).output
    return Workflow([pred]).with_raw_feature_filter(min_fill_rate=0.001)


def _ds_slice(ds, lo: int, hi: int):
    return type(ds)({k: ds.column(k)[lo:hi] for k in ds.column_names},
                    {k: ds.ftype(k) for k in ds.column_names})


def cli_part(model, ds, device, workdir, requests=CLI_REQUESTS,
             replicas=CLI_REPLICAS):
    """``python -m transmogrifai_tpu_torch serve --engine`` as a
    subprocess on the saved workflow (``--replicas``, TM_TRACE_DIR set),
    every output row held to the in-process ``WorkflowModel.score``;
    then ``serve`` in stream mode over a CSV of the same rows."""
    import csv
    path = os.path.join(workdir, "wf_model")
    model.save(path)
    rng = np.random.default_rng(11)
    spans_dir = os.path.join(workdir, "cli_trace")
    cols = {k: np.asarray(ds.column(k)) for k in ds.column_names
            if k != "label"}
    n = len(cols["x0"])
    slices = []
    with open(os.path.join(workdir, "r.jsonl"), "w") as f:
        for _ in range(requests):
            lo = int(rng.integers(0, n - 8))
            hi = lo + int(rng.integers(1, 9))
            slices.append((lo, hi))
            f.write(json.dumps({"columns": {
                k: [None if np.isnan(x) else float(x) for x in v[lo:hi]]
                for k, v in cols.items()}}) + "\n")
    dev_args = [] if device.type == "cuda" else ["--device", str(device)]
    env = dict(os.environ, TM_TRACE_DIR=spans_dir, TM_TRACE_SAMPLE="1")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "transmogrifai_tpu_torch", "serve",
         "--engine", "--model", path,
         "--input", os.path.join(workdir, "r.jsonl"),
         "--output", os.path.join(workdir, "o.jsonl"),
         "--clients", str(CLI_CLIENTS), "--replicas", str(replicas)]
        + dev_args, cwd=here, env=env, capture_output=True, text=True,
        timeout=600)
    engine_wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"cli serve --engine exited "
                             f"{res.returncode}: {res.stderr[-2000:]}")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    if summary["ok"] != requests or summary["errors"]:
        raise AssertionError(f"cli serve --engine: ok {summary['ok']} of "
                             f"{requests}, errors {summary['errors']}")
    name = model.result_features[0].name
    want = _probs(model, model.score(ds))
    out = [json.loads(x) for x in open(os.path.join(workdir, "o.jsonl"))]
    max_err = 0.0
    for o, (lo, hi) in zip(out, slices):
        got = np.asarray(o["results"][name])[:, -1]
        max_err = max(max_err, float(np.abs(got - want[lo:hi]).max()))
    if not max_err <= CLI_ATOL:
        raise AssertionError(f"cli serve --engine rows are {max_err} from "
                             f"WorkflowModel.score")
    span_file = os.path.join(spans_dir, "tm_spans.jsonl")
    n_spans = (sum(1 for _ in open(span_file))
               if os.path.exists(span_file) else 0)
    if not n_spans:
        raise AssertionError("cli serve --engine wrote no spans under "
                             "TM_TRACE_DIR")
    # stream mode over a CSV of every request's rows
    csv_path = os.path.join(workdir, "r.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(sorted(cols))
        for lo, hi in slices:
            for r in range(lo, hi):
                w.writerow(["" if np.isnan(cols[k][r]) else repr(
                    float(cols[k][r])) for k in sorted(cols)])
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "transmogrifai_tpu_torch", "serve",
         "--model", path, "--input", csv_path,
         "--output", os.path.join(workdir, "o.csv")] + dev_args,
        cwd=here, env=dict(os.environ), capture_output=True, text=True,
        timeout=600)
    stream_wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"cli serve (stream) exited "
                             f"{res.returncode}: {res.stderr[-2000:]}")
    stream = json.loads(res.stdout.strip().splitlines()[-1])
    with open(os.path.join(workdir, "o.csv")) as f:
        rows = list(csv.reader(f))
    got = np.asarray([float(r[-1]) for r in rows[1:]])
    want_rows = np.concatenate([want[lo:hi] for lo, hi in slices])
    stream_err = float(np.abs(got - want_rows).max())
    if len(got) != len(want_rows) or not stream_err <= CLI_ATOL:
        raise AssertionError(f"cli serve (stream): {len(got)} rows, max "
                             f"abs err {stream_err}")
    return {"requests": requests, "ok": summary["ok"],
            "replicas": replicas, "rows": summary["rows"],
            "engine_wall_s": engine_wall,
            "engine_rows_per_s": summary["rows_per_sec"],
            "max_abs_err": max_err, "spans_written": n_spans,
            "stream_rows": stream["rows"], "stream_wall_s": stream_wall,
            "stream_max_abs_err": stream_err}


def continuum_part(model, train_ds, drifted, device, workdir):
    """A drift drill (tests/test_continuum.py's): traffic with x0
    shifted → debounced detection → a retrain of the LR workflow on
    ``device`` → lint and shadow gates → staged promotion across a
    two-replica inproc fleet, with zero client-visible errors; then
    one /metricsz scrape of the controller. Returns the part's
    measurements."""
    from transmogrifai_tpu_torch.continuum import (ContinuumConfig,
                                                   ContinuumController,
                                                   DriftConfig)
    from transmogrifai_tpu_torch.serving import (EngineConfig, FleetConfig,
                                                 HealthServer, ServingFleet)
    fcfg = FleetConfig(replicas=2, supervise_s=0.05, breaker_open_s=0.3,
                       restart_backoff_s=0.1, backoff_s=0.005,
                       rollout_bake_s=2.0, rollout_min_requests=6,
                       rollout_p99_floor_ms=60.0)
    ccfg = ContinuumConfig(tick_s=0.05, cooldown_s=0.5, retrain_attempts=2,
                           retrain_backoff_s=0.01, shadow_min_samples=6,
                           shadow_timeout_s=15.0, stop_timeout_s=60.0,
                           checkpoint_dir=os.path.join(workdir, "ckpt"))
    dcfg = DriftConfig(threshold=0.4, debounce_windows=2,
                       window_min_rows=24)
    errors = []
    stop = threading.Event()
    t0 = time.perf_counter()
    with ServingFleet(model, replicas=2, buckets=(32,),
                      warm_sample=_ds_slice(train_ds, 0, 1), config=fcfg,
                      engine_config=EngineConfig(max_wait_ms=1.0),
                      device=device) as fleet:
        ctl = ContinuumController(fleet, model, wf_workflow, train_ds,
                                  buckets=(32,), config=ccfg,
                                  drift_config=dcfg)

        def pump(seed):
            rng = np.random.default_rng(seed)
            n = drifted.n_rows
            while not stop.is_set():
                lo = int(rng.integers(0, n - 12))
                try:
                    fleet.score(_ds_slice(drifted, lo,
                                          lo + int(rng.integers(4, 12))),
                                timeout=FLEET_TIMEOUT_S)
                except Exception as e:  # noqa: BLE001 — gated below
                    errors.append(e)
                    return
                time.sleep(0.004)

        threads = [threading.Thread(target=pump, args=(s,))
                   for s in range(4)]
        with ctl:
            for t in threads:
                t.start()
            deadline = time.perf_counter() + 90
            while time.perf_counter() < deadline and not (
                    (ctl.last_cycle or {}).get("outcome") == "promoted"
                    and not ctl.continuum_status()["cycle_in_flight"]):
                time.sleep(0.05)
            health = HealthServer(ctl).start()
            try:
                import urllib.request
                scrape = urllib.request.urlopen(
                    f"http://127.0.0.1:{health.port}/metricsz",
                    timeout=30).read().decode()
            finally:
                health.stop()
            stop.set()
            for t in threads:
                t.join()
            st = ctl.continuum_status()
            last = dict(ctl.last_cycle or {})
    wall = time.perf_counter() - t0
    stats = st["stats"]
    if errors:
        raise AssertionError(f"continuum drill: {len(errors)} client "
                             f"errors ({errors[0]!r})")
    if stats["promotions"] != 1 or last.get("outcome") != "promoted":
        raise AssertionError(f"continuum drill: {stats['promotions']} "
                             f"promotions, last cycle {last}")
    return {"wall_s": wall, "promotions": stats["promotions"],
            "triggers": stats["triggers"],
            "retrains": stats.get("retrains"),
            "shadow_samples": stats.get("shadow_samples"),
            "trigger_reason": stats.get("last_trigger_reason"),
            "version": last.get("version"), "phases_s": last.get("phases"),
            "client_errors": len(errors),
            "metricsz_families": sorted(
                {f for f in FLEET_METRIC_FAMILIES if f in scrape})}


def fleet_phase(seed: int, device="cuda", workdir=None,
                replicas=FLEET_REPLICAS, rps=FLEET_RPS,
                steady_s=FLEET_STEADY_S, failover_s=FLEET_FAILOVER_S,
                window_s=FLEET_WINDOW_S, busy_s=FLEET_BUSY_S,
                v2_requests=FLEET_V2_REQUESTS,
                workers=XHOST_WORKERS, xhost_rps=XHOST_RPS,
                xhost_s=XHOST_DURATION_S, wf_rows=FLEET_WF_ROWS,
                cli_requests=CLI_REQUESTS, fault=None):
    """The serving tier end to end on ``device``: the catalog written as
    a registry root, the inproc fleet under failover and a staged
    rollout, socket workers under a kill -9, the CLI as a subprocess
    (engine and stream modes) and the continuum drift drill. ``fault``
    plants a defect the inproc part's gates must catch (see
    ``inproc_fleet_part``). Returns every part's measurements; raises
    on any failure."""
    import tempfile
    device = torch.device(device)
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="tm_smoke_fleet_")
    t0 = time.perf_counter()
    try:
        root = os.path.join(workdir, "catalog")
        catalog = write_catalog(root, seed)
        v2_path = os.path.join(workdir, "v2")
        v2 = (v2_path, write_v2(v2_path, seed))
        inproc = inproc_fleet_part(
            seed, device, root, catalog, v2, replicas=replicas, rps=rps,
            steady_s=steady_s, failover_s=failover_s, window_s=window_s,
            busy_s=busy_s, v2_requests=v2_requests,
            fault=fault)
        socket = socket_fleet_part(
            seed, device, root, catalog, workers=workers, rps=xhost_rps,
            duration_s=xhost_s, window_s=min(XHOST_WINDOW_S, xhost_s / 4))
        train_ds = wf_data("transmogrifai_tpu_torch", wf_rows, seed + 13)
        t_train = time.perf_counter()
        model = wf_workflow().train(train_ds, device=device)
        train_wall = time.perf_counter() - t_train
        cli = cli_part(model, wf_data("transmogrifai_tpu_torch", 512,
                                      seed + 17), device, workdir,
                       requests=cli_requests,
                       replicas=min(CLI_REPLICAS, max(1, replicas)))
        cont = continuum_part(model, train_ds,
                              wf_data("transmogrifai_tpu_torch", 512,
                                      seed + 19, shift=50.0),
                              device, workdir)
        families = set(socket["metricsz_families"]) | set(
            cont["metricsz_families"])
        if families != set(FLEET_METRIC_FAMILIES):
            raise AssertionError(f"/metricsz scrapes carry {sorted(families)}"
                                 f", not every one of "
                                 f"{list(FLEET_METRIC_FAMILIES)}")
        return {"device": str(device), "inproc": inproc, "socket": socket,
                "workflow_train_s": train_wall, "cli": cli,
                "continuum": cont, "phase_wall_s": time.perf_counter() - t0,
                "kernel_launches": inproc["kernel_launches"]
                + socket["worker_launches"]}
    finally:
        if own:
            import shutil
            shutil.rmtree(workdir, ignore_errors=True)


def fleet_lines(fl) -> list:
    """One printed line per number of the fleet phase, each its run's."""
    ip, so, cli, co = (fl["inproc"], fl["socket"], fl["cli"],
                       fl["continuum"])
    lines = []
    for label, part in (("inproc", ip), ("socket", so)):
        lines.append(
            f"phase fleet: {label} p50/p99 ms steady "
            f"{part['steady_p50_ms']}/{part['steady_p99_ms']} failover "
            f"{part['failover_p50_ms']}/{part['failover_p99_ms']} "
            f"recovered {part['recovered_p50_ms']}/"
            f"{part['recovered_p99_ms']}; {part['rows_per_s']} rows/s; "
            f"lost {part['lost_requests']}, client errors "
            f"{part['client_errors']}")
        lines.append(
            f"phase fleet: {label} failovers {part['failovers']}, "
            f"retries {part['retries']}, ejections {part['ejections']}, "
            f"crashes {part['replica_crashes']}, restarts "
            f"{part['replica_restarts']}, breaker opens "
            f"{part['breaker_opens']} closes {part['breaker_closes']}")
    lines.append(
        f"phase fleet: inproc rollout to v2 rolled back "
        f"{ip['rollout']['rolled_back']}; answers vs numpy "
        f"{ip['max_abs_err_vs_numpy']}, vs alone {ip['max_abs_err_vs_alone']}"
        f" (bitwise {ip['bitwise_alone']} of {ip['matched']}); kernel "
        f"launches {ip['kernel_launches']} for {ip['fused_slices']} fused "
        f"slices, {ip['profiler_kernel_launches']} by the profiler in its "
        f"{ip['busy_window_s']} s window; busy share "
        f"{ip['device_busy_share']}")
    for name, w in so["per_worker"].items():
        lines.append(
            f"phase fleet: worker {name} on {w['device']} launches "
            f"{w['launches']} fused passes {w['fused_batches']} fallbacks "
            f"{w['fused_fallbacks']}; wire overhead p50/p99 us "
            f"{w['wire_p50_us']}/{w['wire_p99_us']}")
    lines.append(
        f"phase fleet: socket answers vs numpy {so['max_abs_err_vs_numpy']}"
        f", vs alone {so['max_abs_err_vs_alone']} (bitwise "
        f"{so['bitwise_alone']} of {so['requests']}, planes "
        f"{so['planes']}); restarted worker served {so['restarted_served']}")
    lines.append(
        f"phase fleet: cli serve --engine {cli['ok']}/{cli['requests']} ok "
        f"in {cli['engine_wall_s']} s, max abs err {cli['max_abs_err']}, "
        f"{cli['spans_written']} spans; stream {cli['stream_rows']} rows in "
        f"{cli['stream_wall_s']} s, max abs err {cli['stream_max_abs_err']}")
    lines.append(
        f"phase fleet: continuum promotions {co['promotions']} in "
        f"{co['wall_s']} s (phases {co['phases_s']}), client errors "
        f"{co['client_errors']}; /metricsz families "
        f"{sorted(set(co['metricsz_families']) | set(so['metricsz_families']))}")
    lines.append(f"phase fleet: wall {fl['phase_wall_s']} s")
    return lines


# ---------------------------------------------------------------------------
# phase 12: the FT-Transformer — grid fit, card vs CPU, the front door
# ---------------------------------------------------------------------------

#: bench.py::bench_ft_transformer's shape (:3352, :3361; N_ROWS :39): rows,
#: features, folds; the family's default grid (6 points) makes 18 fits
FT_ROWS = 896
FT_FEATURES = 16
FT_FOLDS = 3
#: the bench's widest point (d_model at the tile boundary, d_ff = 2x)
FT_WIDE = (128, 256)
#: AdamW steps of the two short fits whose difference gives one step's
#: device time and operations
FT_PROFILE_STEPS = (5, 15)
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet): the rate
#: that bounds the bf16 fit's matrix products; the f32 fit (TF32 off)
#: runs on the F32_FLOPS_PER_S pipes
BF16_FLOPS_PER_S = 989e12
#: card vs CPU, f32 (TM_FT_BF16=0, TF32 off), the same initial draw,
#: 200 AdamW steps: probabilities after the fit. Both sides are f32 in
#: another summation order; Adam's normalised steps carry an ulp-level
#: gradient difference into each step, so the gap grows with the steps
FT_CPU_ATOL = 1e-3
#: the bf16 grid's held-out AUROC (mean over folds, best grid point)
#: against the f32 grid's (the JAX package's test_ft_bf16_compute_quality
#: allows 0.08 of accuracy)
FT_BF16_AUROC_TOL = 0.02
#: a row scored alone (LocalScorer) or in another co-batch (the engine)
#: against the batch score: read 6.0e-8 and 1.2e-7 on an H100 (the
#: bf16 products of the trunk round alike at every batch shape the
#: buckets give; the f32 norm and head differ by an f32 ulp). Far under
#: the gap between two passengers' probabilities, so a row given
#: another row's answer fails it
FT_ROW_ATOL = 1e-5
FT_REQUESTS = 96
FT_LOCAL_ROWS = 100
FT_CANDIDATES = [["LogisticRegression", None],
                 ["FTTransformerClassifier", None]]


def ft_data(seed: int, rows=FT_ROWS, d=FT_FEATURES):
    """(X, y) from ``seed``: normal features, a label the FT-Transformer
    can learn and a linear model cannot fully (x0 * x1 + x2)."""
    rng = np.random.default_rng(seed + 12)
    X = rng.normal(size=(rows, d)).astype(np.float32)
    logit = 2.0 * X[:, 0] * X[:, 1] + X[:, 2]
    y = (logit + 0.3 * rng.normal(size=rows) > 0).astype(np.float32)
    return X, y


def ft_flops(n, d, fits, d_model, n_layers, d_ff, n_steps) -> float:
    """A copy of bench.py::_ft_flops: per forward, T = d+1 tokens through
    n_layers of (QKV+O 8TD^2, attention 4T^2D, FFN 4TDd_ff) per row,
    plus the tokenizer (2TD); an Adam step ~ 3 forwards; n_steps steps
    a fit plus one predict forward."""
    T, D = d + 1, d_model
    fwd_row = n_layers * (8 * T * D * D + 4 * T * T * D + 4 * T * D * d_ff) \
        + 2 * T * D
    return fits * (3 * n_steps + 1) * n * fwd_row


def ft_bytes(n, d, fits, d_model, n_layers, d_ff, n_steps) -> float:
    """A copy of bench.py::_ft_bytes: per Adam step each fit's parameters
    read and re-written with gradients and two moments (~3x the
    parameter bytes), the batch read once; activations not counted."""
    T, D = d + 1, d_model
    params = T * D + n_layers * (4 * D * D + 2 * D * d_ff) + D
    return 4.0 * (n * d + fits * n_steps * 3.0 * params)


@contextlib.contextmanager
def ft_sizes(d_model, d_ff, n_steps=None):
    """The FT classifier family at another width (and step count) for
    the block: its static attributes, read at fit time."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    fam = MODEL_FAMILIES["FTTransformerClassifier"]
    old = (fam.d_model, fam.d_ff, fam.n_steps)
    fam.d_model, fam.d_ff = d_model, d_ff
    if n_steps is not None:
        fam.n_steps = n_steps
    try:
        yield fam
    finally:
        fam.d_model, fam.d_ff, fam.n_steps = old


def _ft_step_device(fam, X, y, device, chunk):
    """One AdamW step's device time (ms) and device operations on a
    chunk of ``chunk`` instances: two fits of FT_PROFILE_STEPS steps
    under torch.profiler (device activity), their difference over the
    steps between them; and the longer fit's top device operations
    (ms and count per step)."""
    from torch.autograd import DeviceType
    Xt = torch.as_tensor(X, device=device).expand(chunk, -1, -1)
    yt = torch.as_tensor(y, device=device).expand(chunk, -1)
    wt = torch.ones_like(yt)
    hyper = {"learningRate": torch.full((chunk,), 3e-3, device=device),
             "weightDecay": torch.full((chunk,), 1e-4, device=device)}
    out = []
    for steps in FT_PROFILE_STEPS:
        old = fam.n_steps
        fam.n_steps = steps
        try:
            prof, _ = profiled(lambda: fam.fit_batch(Xt, yt, wt, hyper, 2),
                               host=False)
        finally:
            fam.n_steps = old
        out.append(_device_time_us(prof))
    (us0, ev0), (us1, ev1) = out
    k = FT_PROFILE_STEPS[1] - FT_PROFILE_STEPS[0]
    steps = FT_PROFILE_STEPS[1]
    top = sorted(((ev.device_time_total, ev.count, ev.key[:70])
                  for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA), reverse=True)[:8]
    return ((us1 - us0) / k / 1e3, (ev1 - ev0) / k,
            [{"ms_per_step": us / 1e3 / steps, "per_step": c / steps,
              "name": name} for us, c, name in top])


def ft_grid_run(X, y, device, d_model, d_ff, profile=True, busy=False):
    """The FT classifier's 3-fold CV over its default grid through
    ``OpCrossValidation.dispatch`` on ``device`` at one width, in the
    compute dtype the knobs give: wall, fits/s, the best mean AUROC;
    with ``profile``, one AdamW step's device time and operations on a
    sweep chunk, and with ``busy`` the same dispatch at
    FT_PROFILE_STEPS[1] AdamW steps under torch.profiler (device
    activity) for the busy share (the whole dispatch's ~10^5 device
    events take the profiler longer to read than the budget allows)."""
    from transmogrifai_tpu_torch.models.ft_transformer import ft_dtype
    from transmogrifai_tpu_torch.models.tuning import (OpCrossValidation,
                                                       SWEEP_CHUNK)
    w = np.ones(len(y), np.float32)
    dev = torch.device(device)
    sync = _sync_of(device)
    with ft_sizes(d_model, d_ff) as fam:
        grid = fam.make_grid()
        cv = OpCrossValidation(n_folds=FT_FOLDS, metric="auroc")

        def run():
            return cv.collect(cv.dispatch(fam, grid, X, y, w, 2,
                                          device=device))
        sync()
        t0 = time.perf_counter()
        res = run()
        sync()
        wall = time.perf_counter() - t0
        fits = FT_FOLDS * len(grid)
        chunk = SWEEP_CHUNK.get(dev.type, 1)
        dtype = ft_dtype(dev)
        flops = ft_flops(len(y), X.shape[1], fits, d_model, fam.n_layers,
                         d_ff, fam.n_steps)
        nbytes = ft_bytes(len(y), X.shape[1], fits, d_model, fam.n_layers,
                          d_ff, fam.n_steps)
        peak, peak_name = ((BF16_FLOPS_PER_S, "bf16 989 TFLOP/s")
                           if dtype == torch.bfloat16 else
                           (F32_FLOPS_PER_S, "f32 67 TFLOP/s"))
        flop_ms, byte_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out = {"d_model": d_model, "d_ff": d_ff, "dtype": str(dtype),
               "rows": len(y), "features": X.shape[1], "folds": FT_FOLDS,
               "grid": len(grid), "fits": fits, "chunk": chunk,
               "instances_computed": -(-fits // chunk) * chunk,
               "adam_steps": fam.n_steps, "wall_s": wall,
               "fits_per_s": fits / wall,
               "best_auroc": float(res.best_metric),
               "grid_auroc": [float(m) for m in res.grid_metrics],
               "flops": flops, "bytes": nbytes,
               "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
               "peak": peak_name}
        if profile and dev.type == "cuda":
            t0 = time.perf_counter()
            step_ms, step_ops, top = _ft_step_device(fam, X, y, device,
                                                     chunk)
            out.update(step_device_ms=step_ms, step_device_ops=step_ops,
                       step_top_device_ops=top,
                       step_profile_wall_s=time.perf_counter() - t0)
        if busy and dev.type == "cuda":
            t0 = time.perf_counter()
            fam.n_steps = FT_PROFILE_STEPS[1]
            try:
                prof, pwall = profiled(_walled(run), host=False)
            finally:
                fam.n_steps = out["adam_steps"]
            busy_us, events = _device_time_us(prof)
            out.update(busy_window_steps=FT_PROFILE_STEPS[1],
                       profiled_wall_s=pwall, device_busy_s=busy_us / 1e6,
                       device_events=events,
                       device_busy_share=busy_us / 1e6 / pwall,
                       busy_profile_wall_s=time.perf_counter() - t0)
    return out


def ft_cpu_part(X, y, device, fits_check=None):
    """Card against CPU: the same inputs and the same injected initial
    draw, TM_FT_BF16=0 (TF32 is off for the run), one fit at the
    default hypers on each side, probabilities compared on every row
    (FT_CPU_ATOL). ``fits_check``: a test's planted fault on the
    card side's probabilities."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    from transmogrifai_tpu_torch.models.base import params_to_numpy
    fam = MODEL_FAMILIES["FTTransformerClassifier"]
    init = params_to_numpy(fam.init_params(X.shape[1], 2))
    probs, walls = {}, {}
    with env(TM_FT_BF16="0"):
        for side in (device, "cpu"):
            sync = _sync_of(side)
            Xt = torch.as_tensor(X, device=side)
            yt = torch.as_tensor(y, device=side)
            sync()
            t0 = time.perf_counter()
            p = fam.fit_kernel(Xt, yt, torch.ones_like(yt),
                               fam.default_hyper, 2, init=init)
            pr = fam.predict_kernel(p, Xt, 2)[:, 1].cpu().numpy()
            walls[side] = time.perf_counter() - t0
            probs[side] = pr
    card = probs[device] if fits_check is None else fits_check(probs[device])
    gap = float(np.abs(card - probs["cpu"]).max())
    if not gap <= FT_CPU_ATOL:
        raise AssertionError(f"FT card vs CPU: probabilities {gap} apart "
                             f"(atol {FT_CPU_ATOL})")
    return {"rows": len(y), "max_abs_gap": gap,
            "card_fit_s": walls[device], "cpu_fit_s": walls["cpu"]}


def _ft_train(reader, device, candidates):
    """(model, wall, histogram launches) of the Titanic workflow with
    ``candidates``; the launch counter is read, not reset (the phase
    reads its own difference over the whole phase)."""
    from transmogrifai_tpu_torch.models import kernels as tk
    sync = _sync_of(device)
    sync()
    before = tk.histogram_grid.launches
    t0 = time.perf_counter()
    model = _titanic_workflow(candidates).train(reader, device=device)
    sync()
    return (model, time.perf_counter() - t0,
            tk.histogram_grid.launches - before)


def ft_front_part(device, workdir, requests=FT_REQUESTS,
                  local_rows=FT_LOCAL_ROWS, seed=0):
    """Titanic through ``Workflow.train`` with the selector's candidates
    LogisticRegression and FTTransformerClassifier (default grids): the
    winner and both CV results; the served model is the FT one (the
    winner, or else the same workflow with FT alone). Save and load
    (scores bitwise); ``export_portable`` (its batch scores bitwise the
    workflow's) -> ``portable.load`` -> one ServingEngine under ``requests`` requests of 1-8 rows from 8
    threads carrying the boundary columns: every answer within
    FT_ROW_ATOL of the portable chain's batch scores, every request on
    the classic plane (FT's head is not linear: no stack spec, no fused
    launch); LocalScorer on ``local_rows`` rows within FT_ROW_ATOL of
    the batch scores. No kernel launches (no tree family, no fused
    plane)."""
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.local import LocalScorer
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    from transmogrifai_tpu_torch.profiling import percentile_nearest_rank
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.serving import (EngineConfig, ModelRegistry,
                                                 ServingEngine)
    from transmogrifai_tpu_torch.serving.fusion import stack_spec_of
    from transmogrifai_tpu_torch.telemetry.spans import TRACER
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    reader = DataReaders.csv(_repo_file("examples", "data", "titanic.csv"),
                             _types(TITANIC_SCHEMA), key="id")
    model, wall, launches = _ft_train(reader, device, FT_CANDIDATES)
    summ = model.selected_model().summary
    winner = summ["bestModel"]["family"]
    cv = {r["family"]: max(r["gridMetrics"])
          for r in summ["validationResults"]}
    if sorted(cv) != sorted(c for c, _ in FT_CANDIDATES):
        raise AssertionError(f"FT front door validated {sorted(cv)}")
    served, ft_wall = model, None
    if winner != "FTTransformerClassifier":
        served, ft_wall, more = _ft_train(
            reader, device, [["FTTransformerClassifier", None]])
        launches += more
    if launches:
        raise AssertionError(f"FT front door: {launches} histogram "
                             f"launches with no tree family")
    head = served.selected_model()
    if head.params["family"] != "FTTransformerClassifier":
        raise AssertionError(f"served head is {head.params['family']}")
    first = _probs(served, served.score(reader))
    if not (np.isfinite(first).all() and (first >= 0).all()
            and (first <= 1).all()):
        raise AssertionError("FT front door: scores malformed")
    t0 = time.perf_counter()
    served.save(os.path.join(workdir, "ft_model"))
    loaded = WorkflowModel.load(os.path.join(workdir, "ft_model"),
                                device=device)
    save_load = time.perf_counter() - t0
    if not np.array_equal(_probs(loaded, loaded.score(reader)), first):
        raise AssertionError("FT: the loaded model scores differently")
    # LocalScorer: one row at a time
    recs = reader.read()[:local_rows]
    local = LocalScorer(loaded, device=device)
    name = loaded.result_features[0].name
    lp = np.asarray([local({k: v for k, v in r.items() if k != "survived"})
                     [name]["probability_1"] for r in recs])
    local_err = float(np.abs(lp - first[:local_rows]).max())
    if not local_err <= FT_ROW_ATOL:
        raise AssertionError(f"FT LocalScorer differs from the batch "
                             f"scores by {local_err}")
    # export -> portable.load -> ServingEngine (classic plane)
    art = os.path.join(workdir, "ft_export")
    served.export_portable(art, buckets=BUCKETS)
    pm = portable.load(art, device=device)
    stage = pm.manifest["stages"][-1]
    if stage.get("family") != "FTTransformerClassifier" or \
            stage.get("nHeads") != 4:
        raise AssertionError(f"FT export: head stage {stage}")
    host = served.compile_scoring(device=device)._host_ds(reader)
    cols = {c: np.asarray(host.column(c)) for c in pm.boundary
            if c in host and c not in pm.response_boundary}
    batch = np.asarray(pm.compile_scoring(buckets=BUCKETS).score_arrays(
        cols)[pm.result_names[0]], np.float64)[:, 1]
    export_gap = float(np.abs(batch - first).max())
    if not np.array_equal(batch, first):
        raise AssertionError(f"FT export scores {export_gap} from the "
                             f"workflow's (bitwise required)")
    # two backends of the artifact, so a drain pass holds two groups and
    # the engine considers the fused plane: each FT group falls back
    reg = ModelRegistry()
    names = ("ft", "ft_b")
    for v in names:
        reg.register(v, pm if v == "ft" else portable.load(art, device),
                     buckets=BUCKETS,
                     warm_sample={c: x[:1] for c, x in cols.items()})
        if stack_spec_of(reg.get(v).backend) is not None:
            raise AssertionError("an FT head got a fused stack spec")
    rng = np.random.default_rng(seed + 41)
    n = len(first)
    reqs, picks = [], []
    for i in range(requests):
        rows = rng.integers(0, n, int(rng.integers(1, 9)))
        picks.append(rows)
        reqs.append((names[i % 2], {c: v[rows] for c, v in cols.items()}))
    TRACER.clear()
    traces = [TRACER.mint("req") for _ in reqs]
    eng = ServingEngine(registry=reg, config=EngineConfig(
        max_batch_rows=MAX_BATCH_ROWS, fused_kernel=True)).start()
    before = sk.fused_linear_scores.launches
    try:
        results, lat, swall = _storm(eng, reqs, THREADS, traces)
        moved = sk.fused_linear_scores.launches - before
    finally:
        eng.stop()
    plane, _ = _served_planes(TRACER.spans(), traces)
    worst, bitwise = 0.0, 0
    for rows, res in zip(picks, results):
        got = np.asarray(res[pm.result_names[0]], np.float64)[:, 1]
        worst = max(worst, float(np.abs(got - batch[rows]).max()))
        bitwise += int(np.array_equal(got, batch[rows]))
    if not worst <= FT_ROW_ATOL:
        raise AssertionError(f"FT served rows differ from the batch "
                             f"scores by {worst}")
    stats = eng.stats.as_dict()
    if set(plane.values()) != {"classic"} or moved != 0 or \
            not stats["fused_fallbacks"] >= 1:
        raise AssertionError(f"FT requests rode {set(plane.values())}, "
                             f"fused launches {moved}, fallbacks "
                             f"{stats['fused_fallbacks']}")
    if stats["failed"]:
        raise AssertionError(f"FT serving: {stats['failed']} failed")
    lat_ms = sorted(x * 1e3 for x in lat)
    return {"rows": n, "train_wall_s": wall, "winner": winner,
            "cv_best_auroc": cv, "ft_only_train_wall_s": ft_wall,
            "served_family": head.params["family"],
            "holdout_auroc": head.summary["holdoutEvaluation"].get("AuROC"),
            "save_load_wall_s": save_load, "loaded_scores_bitwise": True,
            "local_rows": len(recs), "local_max_abs_err": local_err,
            "export_max_abs_err": export_gap, "requests": requests,
            "serve_wall_s": swall, "serve_max_abs_err": worst,
            "serve_bitwise_requests": bitwise,
            "p50_ms": percentile_nearest_rank(lat_ms, 0.50),
            "p99_ms": percentile_nearest_rank(lat_ms, 0.99),
            "planes": sorted(set(plane.values())),
            "fused_fallbacks": stats.get("fused_fallbacks")}


def _ft_done(name: str, t0: float) -> float:
    wall = time.perf_counter() - t0
    print(f"phase ft: part {name} done in {wall:.3f} s", flush=True)
    return wall


def ft_phase(seed: int, device="cuda", rows=FT_ROWS, wide=FT_WIDE,
             n_steps=None):
    """The FT-Transformer on ``device``: the grid fit at the bench's
    shape in bf16 (the CUDA default) and f32 (TM_FT_BF16=0), at the
    family's width and at ``wide``; card against CPU; Titanic through
    the selector, save/load, export and serving. ``rows``, ``wide`` and
    ``n_steps`` (the family's 200 when None) exist for a CPU
    rehearsal."""
    import shutil
    import tempfile
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    fam = MODEL_FAMILIES["FTTransformerClassifier"]
    before = {"fused_linear_scores": sk.fused_linear_scores.launches,
              "ring_allreduce": tk.ring_allreduce.launches,
              "tree_histogram": tk.histogram_grid.launches}
    X, y = ft_data(seed, rows)
    old_steps = fam.n_steps
    if n_steps is not None:
        fam.n_steps = n_steps
    workdir = tempfile.mkdtemp(prefix="tm_ft_phase_")
    t0 = time.perf_counter()
    walls = {}
    try:
        grids = []
        for d_model, d_ff in ((fam.d_model, fam.d_ff), wide):
            for flag in ("", "0"):
                t1 = time.perf_counter()
                with env(TM_FT_BF16=flag) if flag else contextlib.nullcontext():
                    grids.append(ft_grid_run(
                        X, y, device, d_model, d_ff,
                        busy=(d_model == fam.d_model and not flag)))
                walls[f"grid d{d_model} {grids[-1]['dtype']}"] = _ft_done(
                    f"grid d_model {d_model} {grids[-1]['dtype']}", t1)
        base = [g for g in grids if g["d_model"] == fam.d_model]
        auroc_gap = abs(base[0]["best_auroc"] - base[1]["best_auroc"])
        if not auroc_gap <= FT_BF16_AUROC_TOL:
            raise AssertionError(f"FT bf16 grid AUROC {base[0]['best_auroc']}"
                                 f" vs f32 {base[1]['best_auroc']}")
        t1 = time.perf_counter()
        cpu = ft_cpu_part(X, y, device)
        walls["card_vs_cpu"] = _ft_done("card_vs_cpu", t1)
        t1 = time.perf_counter()
        front_out = ft_front_part(device, workdir)
        walls["front"] = _ft_done("front", t1)
    finally:
        fam.n_steps = old_steps
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {"fused_linear_scores": sk.fused_linear_scores.launches
                - before["fused_linear_scores"],
                "ring_allreduce": tk.ring_allreduce.launches
                - before["ring_allreduce"],
                "tree_histogram": tk.histogram_grid.launches
                - before["tree_histogram"]}
    if any(launches.values()):
        raise AssertionError(f"the FT phase launched {launches}")
    return {"grids": grids, "bf16_vs_f32_auroc_gap": auroc_gap,
            "card_vs_cpu": cpu, "front": front_out, "launches": launches,
            "part_walls_s": walls, "wall_s": time.perf_counter() - t0}


def ft_lines(fr) -> list:
    """One line per reported number of the FT phase, each taken from
    its result ``fr``."""
    out = []
    for g in fr["grids"]:
        tag = f"d_model {g['d_model']} d_ff {g['d_ff']} {g['dtype']}"
        out.append(
            f"phase ft: grid {tag}: {g['fits']} fits ({g['folds']} folds x "
            f"{g['grid']} points, {g['rows']} x {g['features']}, "
            f"{g['adam_steps']} AdamW steps; {g['instances_computed']} "
            f"instances in chunks of {g['chunk']}) wall {g['wall_s']} s, "
            f"{g['fits_per_s']} fits/s, best AUROC {g['best_auroc']}")
        out.append(
            f"phase ft: grid {tag}: one AdamW step on a chunk "
            f"{g.get('step_device_ms', 'not measured')} ms of device time "
            f"in {g.get('step_device_ops', 'not measured')} device "
            f"operations; device busy share "
            + (f"{g['device_busy_share']} (the dispatch at "
               f"{g.get('busy_window_steps')} steps)"
               if "device_busy_share" in g else "not measured")
            + "; top device "
            f"operations a step {json.dumps(g.get('step_top_device_ops'))}")
        out.append(
            f"phase ft: grid {tag}: {g['flops']} FLOPs, {g['bytes']} bytes "
            f"(bench.py's _ft_flops / _ft_bytes), bound {g['bound_ms']} ms "
            f"by {g['bound_by']} ({g['peak']}, 3.35 TB/s)")
    out.append(f"phase ft: bf16 vs f32 best held-out AUROC gap "
               f"{fr['bf16_vs_f32_auroc_gap']} (<= {FT_BF16_AUROC_TOL})")
    c = fr["card_vs_cpu"]
    out.append(f"phase ft: card vs CPU (TM_FT_BF16=0, TF32 off, the same "
               f"draw) {c['rows']} rows: probabilities {c['max_abs_gap']} "
               f"apart (atol {FT_CPU_ATOL}); fit {c['card_fit_s']} s card, "
               f"{c['cpu_fit_s']} s CPU")
    f = fr["front"]
    out.append(f"phase ft: Titanic LR + FT selector train "
               f"{f['train_wall_s']} s, winner {f['winner']}, CV best "
               f"AUROC {json.dumps(f['cv_best_auroc'])}; served "
               f"{f['served_family']} (FT alone "
               f"{f['ft_only_train_wall_s']} s), holdout AUROC "
               f"{f['holdout_auroc']}")
    out.append(f"phase ft: save/load {f['save_load_wall_s']} s (scores "
               f"bitwise), LocalScorer {f['local_rows']} rows max abs "
               f"err {f['local_max_abs_err']} (atol {FT_ROW_ATOL}), export "
               f"max abs err {f['export_max_abs_err']} (bitwise required)")
    out.append(f"phase ft: served {f['requests']} requests on "
               f"{f['planes']} (fused fallbacks {f['fused_fallbacks']}):"
               f" max abs err {f['serve_max_abs_err']} (atol "
               f"{FT_ROW_ATOL}), {f['serve_bitwise_requests']} bitwise, "
               f"p50 {f['p50_ms']} ms, p99 {f['p99_ms']} ms")
    out.append(f"phase ft: kernel launches {json.dumps(fr['launches'])}; "
               f"phase wall {fr['wall_s']} s, parts "
               f"{json.dumps(fr['part_walls_s'])}")
    return out


# ---------------------------------------------------------------------------
# phase 13: the learned autotuner on the kernels' own launch choices
# ---------------------------------------------------------------------------

#: the histogram shapes the autotuner measures, (label, G, n, d, S, m,
#: B, exact): HIST_SHAPES' first four in bf16 (the training path's
#: operand mode), then the capture shape in exact mode
TUNE_HIST = ([(label, *shape, False) for label, *shape in HIST_SHAPES[:4]]
             + [("capture_exact", *HIST_SHAPES[0][1:], True)])
#: the fused scorer's shapes, (label, n, C, p, K, L, form): the serving
#: pass's prefix form at the storm's top bucket, its identity form, and
#: the prefix form at two larger bucket sizes
TUNE_SERVE = [("prefix_64", 64, N_COLUMNS + 1, P_KEEP, N_BACKENDS, 1,
               "prefix"),
              ("identity_64", 64, P_KEEP, P_KEEP, N_BACKENDS, 1,
               "identity"),
              ("prefix_1024", 1024, N_COLUMNS + 1, P_KEEP, N_BACKENDS, 1,
               "prefix"),
              ("prefix_8192", 8192, N_COLUMNS + 1, P_KEEP, N_BACKENDS, 1,
               "prefix")]
#: timing: a histogram candidate's median over SAMPLES runs of CALLS
#: back-to-back launches between CUDA events, per launch (a launch is
#: 0.2-1.5 ms of device time, so the events see the device); a scorer
#: candidate's median device time over CALLS launches in a
#: torch.profiler trace (a launch is a few us of device time, less than
#: the host takes to issue it, so CUDA events around back-to-back
#: launches would time the host)
TUNE_HIST_SAMPLES = 5
TUNE_HIST_CALLS = 10
TUNE_SERVE_SAMPLES = 5
TUNE_SERVE_CALLS = 40
#: the scorer's kernel in a trace (csrc fused_scores_kernel<...>)
TUNE_SERVE_KERNEL = "fused_scores_kernel"
#: rows the engine rescores after the bucket ladder's swap
TUNE_RESCORE_ROWS = 64


def tune_ms(fn, device, samples: int, calls: int = 1) -> float:
    """Median over ``samples`` of the time of ``calls`` back-to-back
    calls of ``fn``, per call, after one warm-up call: CUDA events on
    the card; on the CPU (the tests' rehearsal) the host clock."""
    fn()
    cuda = torch.device(device).type == "cuda"
    per = []
    for _ in range(samples):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per.append((time.perf_counter() - t0) * 1e3 / calls)
    return float(np.median(per))


def kernel_median_ms(fn, pattern: str, calls: int) -> float:
    """Median device time of one launch of the kernel named *pattern*
    over ``calls`` calls of ``fn`` in a torch.profiler trace, after one
    warm-up call. The median is taken only from a trace that holds
    exactly one such kernel a call: a trace holding fewer (one that
    lost device events) is taken again, up to PROFILE_ATTEMPTS
    sessions; one holding more raises at once."""
    from torch.autograd import DeviceType
    fn()
    traced = []
    for _ in range(PROFILE_ATTEMPTS):
        prof, _ = profiled(lambda: [fn() for _ in range(calls)], host=False)
        spans = [ev.time_range.end - ev.time_range.start
                 for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA and pattern in ev.name]
        if len(spans) == calls:
            return float(np.median(spans)) / 1e3
        traced.append(len(spans))
        if len(spans) > calls:
            break
        print(f"kernel_median_ms: a trace held {len(spans)} kernels named "
              f"*{pattern}* for {calls} calls", file=sys.stderr)
    raise AssertionError(f"{traced} device kernels named *{pattern}* "
                         f"traced in {len(traced)} sessions of {calls} "
                         f"calls each")


def _hist_knobs(exact: bool) -> dict:
    return ({"TM_KERNEL_EXACT": "1"} if exact
            else {"TM_KERNEL_EXACT": "0", "TM_HIST_BF16": "1"})


def tune_hist_part(cases, seed, device, samples=TUNE_HIST_SAMPLES,
                   calls=TUNE_HIST_CALLS):
    """Every histogram candidate the screen admits at each case, on
    seeded inputs: its output ``torch.equal`` to the static launch's,
    and its time. Returns (rows, each case's inputs and static output)."""
    from transmogrifai_tpu_torch.autotune import candidate_configs
    from transmogrifai_tpu_torch.models import kernels as tk
    rows, kept = [], []
    for i, (label, G, n, d, S, m, B, exact) in enumerate(cases):
        shape = {"G": G, "n": n, "d": d, "B": B, "S": S, "m": m}
        gen = torch.Generator(device=device).manual_seed(seed + i)
        args = (torch.randint(0, B, (n, d), generator=gen, device=device,
                              dtype=torch.int32),
                torch.randn((G, n, S), generator=gen, device=device),
                torch.randint(0, m, (G, n), generator=gen, device=device,
                              dtype=torch.int32))
        meas = []
        with env(**_hist_knobs(exact)):
            static = tk.histogram_grid(*args, m, B,
                                       config=tk.STATIC_LAUNCH_CONFIG)
            for cfg in candidate_configs(shape):
                def run(cfg=cfg):
                    return tk.histogram_grid(*args, m, B, config=cfg)
                if not torch.equal(run(), static):
                    raise AssertionError(
                        f"autotune: histogram candidate {cfg} at {label} "
                        f"differs from the static launch")
                meas.append({"shape": shape, "config": cfg,
                             "ms": tune_ms(run, device, samples, calls)})
        rows.append({"label": label, "shape": shape, "exact": exact,
                     "static": tk.STATIC_LAUNCH_CONFIG,
                     "measurements": meas})
        kept.append((args, static))
    return rows, kept


def _serve_inputs(rng, form, n, C, p, K, L, device):
    """The prefix form's inputs (:func:`prefix_inputs`), or the identity
    form's rows, weights and model ids, on ``device``."""
    if form == "prefix":
        return tuple(prefix_inputs(rng, n, C, p, K, L, device=device))
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = (0.5 * rng.normal(size=(K, p + 1, L))).astype(np.float32)
    mid = rng.integers(0, K, size=n).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (X, W, mid))


def _serve_call(sk, form, args, config=None):
    if form == "prefix":
        return sk.fused_prefix_scores(*args, act="sigmoid_pair",
                                      config=config)
    return sk.fused_linear_scores(*args, config=config)


def tune_serve_part(cases, seed, device, samples=TUNE_SERVE_SAMPLES,
                    calls=TUNE_SERVE_CALLS):
    """Every scorer candidate the screen admits at each case (the grid
    each executes from the card's own launch rule,
    ``launch_blocks_on_card``): its output ``torch.equal`` to the static
    launch's, and its time: the median device time of a launch
    (:func:`kernel_median_ms`) on the card, the host clock on the CPU
    (the tests' rehearsal)."""
    from transmogrifai_tpu_torch.autotune import serve_candidate_configs
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    rng = np.random.default_rng(seed)
    cuda = torch.device(device).type == "cuda"
    rows, kept = [], []
    for label, n, C, p, K, L, form in cases:
        shape = {"K": K, "n": n, "p": p, "L": L}
        args = _serve_inputs(rng, form, n, C, p, K, L, device)

        def grid(br, n=n, p=p, K=K, L=L, form=form):
            return sk.launch_blocks_on_card(device, n, p, K, L,
                                            tables=form == "prefix",
                                            block_rows=br)

        static = _serve_call(sk, form, args, sk.STATIC_LAUNCH_CONFIG)
        meas = []
        for cfg in serve_candidate_configs(shape,
                                           grid=grid if cuda else None):
            def run(cfg=cfg):
                return _serve_call(sk, form, args, cfg)
            if not torch.equal(run(), static):
                raise AssertionError(
                    f"autotune: scorer candidate {cfg} at {label} differs "
                    f"from the static launch")
            ms = (kernel_median_ms(run, TUNE_SERVE_KERNEL, calls) if cuda
                  else tune_ms(run, device, samples, calls))
            meas.append({"shape": shape, "config": cfg, "ms": ms})
        rows.append({"label": label, "shape": shape, "form": form,
                     "static": sk.STATIC_LAUNCH_CONFIG,
                     "measurements": meas})
        kept.append((form, args, static))
    return rows, kept


def tune_choices(rows, model, key, executed=lambda shape, cfg: cfg):
    """Each row's static, chosen, measured-best and predicted times: the
    model ranks the row's measured candidates (the set its hook ranks);
    ``executed`` maps the static config to its candidate's label."""
    for r in rows:
        meas = r["measurements"]
        by = {key(m["config"]): m["ms"] for m in meas}
        choice, predicted = model.choose_config(
            r["shape"], [m["config"] for m in meas])
        best = min(meas, key=lambda m: (m["ms"], key(m["config"])))
        r.update(candidates=len(meas),
                 static_ms=by[key(executed(r["shape"], r["static"]))],
                 chosen=choice, chosen_ms=by[key(choice)],
                 best=best["config"], best_ms=best["ms"],
                 predicted_ms=predicted,
                 chosen_is_best=key(choice) == key(best["config"]))
    return rows


def _titanic_tuned(reader, device, candidates):
    """The Titanic helloworld's train (``Workflow.train``) with every
    histogram level and its shape recorded: (model, CV grid metrics,
    histograms, shapes)."""
    record, shapes = [], []
    with hist_hook(record=record, shapes=shapes):
        model = _titanic_workflow(candidates).train(reader, device=device)
    return (model, _grid_metrics(model.selected_model().summary), record,
            shapes)


def tune_buckets_part(model, reader, device, mix, buckets=BUCKETS,
                      rows=TUNE_RESCORE_ROWS):
    """A ladder proposed from the serving storm's observed ``mix`` and
    applied through the engine's warmed swap (``retune_buckets``) on an
    engine serving ``model`` on ``buckets``: the expected padded rows
    under both ladders, and the same rows scored before and after the
    swap, which must be bitwise equal."""
    from transmogrifai_tpu_torch.autotune import retune_buckets
    from transmogrifai_tpu_torch.serving import ServingEngine
    from transmogrifai_tpu_torch.workflow import raw_dataset_for
    ds = raw_dataset_for(reader, model.raw_features)
    sample, warm = _ds_slice(ds, 0, rows), _ds_slice(ds, 0, 1)
    with ServingEngine(model, buckets=buckets, warm_sample=warm,
                       device=device) as eng:
        before = eng.score(sample, timeout=120)
        report = retune_buckets(eng, model, version="retuned", mix=mix,
                                current=buckets, warm_sample=warm)
        if not report["applied"]:
            raise AssertionError(f"autotune: the proposed ladder was not "
                                 f"applied: {report}")
        if eng.registry.default_version != "retuned":
            raise AssertionError("autotune: the engine does not serve the "
                                 "retuned ladder after the swap")
        after = eng.score(sample, timeout=120)
    if sorted(before) != sorted(after) or not all(
            np.array_equal(before[k], after[k]) for k in before):
        raise AssertionError("autotune: rows rescored after the ladder's "
                             "swap differ from before it")
    return {"current": report["current"], "proposed": report["proposed"],
            "expected_padded_rows_current":
                report["expected_padded_rows_current"],
            "expected_padded_rows_proposed":
                report["expected_padded_rows_proposed"],
            "batches": sum(mix.values()), "rescored_rows": rows,
            "rescored_bitwise": True}


def autotune_phase(seed: int, device="cuda", mix=None, hist=TUNE_HIST,
                   serve=TUNE_SERVE, candidates=None):
    """Measure every launch candidate of the histogram (``hist``) and the
    fused scorer (``serve``), each bitwise the static launch; fit both
    cost models from these measurements alone (the histogram's bf16
    rows, the scorer's prefix-form rows: the forms the main path runs)
    and save them; then, with ``TM_AUTOTUNE=1`` and the two model paths,
    re-run every case and the Titanic helloworld's train (``candidates``,
    default its own) through the hooks: outputs, histograms and CV
    metrics bitwise the autotune-off run's, one dispatch-log entry and
    one flight-recorder record per distinct shape on the card (none on
    the CPU, where the hooks are not consulted). Last, a bucket ladder
    from the serving storm's batch ``mix`` ({rows: batches}) applied
    through the engine swap. Raises on any failed gate."""
    import tempfile
    from transmogrifai_tpu_torch import autotune as at
    from transmogrifai_tpu_torch.autotune import costmodel as acm
    from transmogrifai_tpu_torch.models import kernels as tk
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.telemetry.recorder import RECORDER
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    hrows, hkept = tune_hist_part(hist, seed, device)
    srows, skept = tune_serve_part(serve, seed, device)
    kmodel = at.KernelCostModel.fit(
        [m for r in hrows if not r["exact"] for m in r["measurements"]])
    smodel = at.ServingCostModel.fit(
        [m for r in srows if r["form"] == "prefix"
         for m in r["measurements"]])
    tune_choices(hrows, kmodel, acm.config_key, acm.executed_config)
    tune_choices(srows, smodel, acm.serve_config_key)
    t_measure = time.perf_counter() - t0

    reader = DataReaders.csv(_repo_file("examples", "data", "titanic.csv"),
                             _types(TITANIC_SCHEMA), key="id")
    at.reset_autotuner()
    off = _titanic_tuned(reader, device, candidates)
    with tempfile.TemporaryDirectory() as tmp:
        kpath = os.path.join(tmp, "kernel_model.json")
        spath = os.path.join(tmp, "serving_model.json")
        kmodel.save(kpath)
        smodel.save(spath)
        with env(TM_AUTOTUNE="1", TM_AUTOTUNE_MODEL=kpath,
                 TM_AUTOTUNE_SERVING_MODEL=spath):
            at.reset_autotuner()
            seq0 = RECORDER.total
            for (label, G, n, d, S, m, B, exact), (args, static) in zip(
                    hist, hkept):
                with env(**_hist_knobs(exact)):
                    if not torch.equal(tk.histogram_grid(*args, m, B),
                                       static):
                        raise AssertionError(f"autotune: the tuned launch "
                                             f"differs at {label}")
            from transmogrifai_tpu_torch.models import serving_kernels as sk
            for (label, *_), (form, args, static) in zip(serve, skept):
                if not torch.equal(_serve_call(sk, form, args), static):
                    raise AssertionError(f"autotune: the tuned scorer "
                                         f"launch differs at {label}")
            on = _titanic_tuned(reader, device, candidates)
            hist_log = at.kernel_dispatch_log()
            serve_log = at.serving_dispatch_log()
            events = [e for e in RECORDER.events(subsystem="autotune")
                      if e["seq"] > seq0]
    at.reset_autotuner()
    if off[1] != on[1]:
        raise AssertionError(f"autotune: Titanic CV metrics moved under the "
                             f"autotuner: {off[1]} vs {on[1]}")
    if len(off[2]) != len(on[2]) or not all(
            torch.equal(a, b) for a, b in zip(off[2], on[2])):
        raise AssertionError("autotune: Titanic's histograms moved under "
                             "the autotuner")
    # (G, n, d, S, m, B) records -> the hook's (G, n, d, B, S, m) keys
    shapes = {acm.shape_key(r["shape"]) for r in hrows} | {
        (G, n, d, B, S, m) for G, n, d, S, m, B in on[3]}
    serve_shapes = {acm.serve_shape_key(r["shape"]) for r in srows}
    want_h, want_s = (len(shapes), len(serve_shapes)) if cuda else (0, 0)
    logged = [acm.shape_key(e["shape"]) for e in hist_log]
    if len(logged) != want_h or (cuda and set(logged) != shapes):
        raise AssertionError(f"autotune: {len(logged)} histogram decisions "
                             f"for {want_h} distinct shapes")
    if len(serve_log) != want_s:
        raise AssertionError(f"autotune: {len(serve_log)} scorer decisions "
                             f"for {want_s} distinct shapes")
    kinds = [e["event"] for e in events]
    if (kinds.count("kernel_config"), kinds.count("serving_config")) != (
            want_h, want_s):
        raise AssertionError(f"autotune: the flight recorder holds "
                             f"{kinds.count('kernel_config')} / "
                             f"{kinds.count('serving_config')} decisions "
                             f"for {want_h} / {want_s} shapes")
    by_shape = {acm.shape_key(e["shape"]): e["config"] for e in hist_log}
    for r in hrows:
        got = by_shape.get(acm.shape_key(r["shape"]))
        if cuda and not r["exact"] and got != r["chosen"]:
            raise AssertionError(f"autotune: the hook ran {got} at "
                                 f"{r['label']}, the model chose "
                                 f"{r['chosen']}")
    mix = {int(k): int(v) for k, v in (mix or {}).items()}
    buckets = (tune_buckets_part(on[0], reader, device, mix) if mix
               else None)
    for r in hrows + srows:
        r["measurements"] = [{"config": m["config"], "ms": m["ms"]}
                             for m in r["measurements"]]
    return {"hist": hrows, "serve": srows, "buckets": buckets,
            "kernel_model": kmodel.to_json(),
            "serving_model": smodel.to_json(),
            "titanic_cv_bitwise": True, "titanic_levels": len(on[2]),
            "titanic_winner": on[0].selected_model().summary[
                "bestModel"]["family"],
            "hist_decisions": len(hist_log),
            "serve_decisions": len(serve_log),
            "measure_s": t_measure, "wall_s": time.perf_counter() - t0}


def autotune_lines(at_) -> list:
    """One line a tuned shape (static, chosen, measured-best and
    predicted ms; whether the choice was the measured best; every
    candidate's config values and ms) and one for the bucket ladder,
    from this run's phase result."""
    out = []
    for r in at_["hist"] + at_["serve"]:
        table = [list(m["config"].values()) + [m["ms"]]
                 for m in r["measurements"]]
        out.append(
            f"autotune {r['label']}: static {r['static_ms']} ms, chosen "
            f"{r['chosen_ms']} ms {r['chosen']}, measured best "
            f"{r['best_ms']} ms {r['best']}, predicted {r['predicted_ms']} "
            f"ms, chosen is the measured best: {r['chosen_is_best']} "
            f"({r['candidates']} candidates, each bitwise the static "
            f"launch; {list(r['static'])} and ms: {json.dumps(table)})")
    b = at_["buckets"]
    if b is not None:
        out.append(
            f"autotune buckets: {b['batches']} observed batches; current "
            f"ladder {b['current']} expects "
            f"{b['expected_padded_rows_current']} padded rows, proposed "
            f"{b['proposed']} {b['expected_padded_rows_proposed']}; "
            f"{b['rescored_rows']} rows rescored bitwise after the swap")
    out.append(f"autotune: phase {at_['wall_s']} s (measuring "
               f"{at_['measure_s']} s); Titanic CV metrics bitwise over "
               f"{at_['titanic_levels']} levels; {at_['hist_decisions']} / "
               f"{at_['serve_decisions']} decisions")
    return out


def kernels_line(rows, serve, empty_ms, hrows, train, hmma, rrows, dp,
                 wf=None, ctr=None, fe=None, fl=None, mesh=None,
                 mesh2d=None, multihost=None):
    """The ``kernels`` line from this run's phase results: every time
    and error is one this run measured, every bound one it computed
    from its own inputs, every launch count its main path's (the
    histogram's: the training phase's and the workflow phase's ``wf``;
    the serving kernel's: the serving phase's, with the workflow
    phase's exported models apart, and its two forms' own launches and
    served-shape checks under ``table_form`` and ``generic_form``;
    ``ctr_launches``: the CTR phase's, which launches none;
    ``features_launches``: the features phase's, whose histogram
    launches add to the histogram's count;
    ``fleet_launches``: the fleet phase's, the inproc fleet's by the
    wrapper's count and by the profiler's, every socket worker's from
    its own status; ``mesh_launches``: the mesh phase's, which add to
    the histogram's and the ring's counts, as do ``mesh2d_launches`` and
    ``multihost_launches``, the 2-D mesh's and the two processes'
    together; the histogram's error also covers the features phase's
    checks at its trains' own levels)."""
    def ring_of(ph):
        return None if ph is None else {
            "allreduce": ph["ring_allreduce_launches"],
            "allgather": ph["ring_allgather_launches"]}
    mesh_ring = ring_of(mesh)
    extra = [ph for ph in (mesh, mesh2d, multihost) if ph is not None]
    ctr_launches = (ctr or {}).get("launches", {})
    fe_launches = (fe or {}).get("launches", {})
    # the serving pass's shape in its operand mode: the prefix form,
    # and the identity form (the JAX function) with its library call
    main_row = next(r for r in rows if r["form"] == "prefix")
    ident = rows[0]
    keys = ("shape", "act", "dtype", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "call_ms", "plain_call_ms")
    forms = {} if wf is None else {
        f"{key}_form": dict({k: wf[f"{key}_form"]["kernel"][k] for k in keys},
                            launches=wf[f"{key}_form"]["kernel_launches"],
                            fused_slices=wf[f"{key}_form"]["fused_slices"])
        for key in ("table", "generic") if f"{key}_form" in wf}
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
        "features_launches": fe_launches.get("fused_linear_scores"),
        "fleet_launches": None if fl is None else {
            "inproc": fl["inproc"]["kernel_launches"],
            "inproc_profiler": fl["inproc"]["profiler_kernel_launches"],
            "workers": fl["socket"]["worker_launches"]},
        "max_abs_err": max([r["max_abs_err"] for r in rows]
                           + [f["max_abs_err"] for f in forms.values()]),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], **forms,
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
            0 if wf is None else wf["histogram_launches"]) + (
            0 if fe is None else fe["histogram_launches"]) + sum(
            ph["histogram_launches"] for ph in extra),
        "training_launches": train["histogram_launches"],
        "workflow_launches": None if wf is None else wf["histogram_launches"],
        "ctr_launches": ctr_launches.get("tree_histogram"),
        "features_launches": fe_launches.get("tree_histogram"),
        "mesh_launches": None if mesh is None else mesh["histogram_launches"],
        "mesh2d_launches": (None if mesh2d is None
                            else mesh2d["histogram_launches"]),
        "multihost_launches": (None if multihost is None
                               else multihost["histogram_launches"]),
        "max_abs_err": max(r["max_abs_err"] for r in hrows + (
            fe or {}).get("hist_checks", [])),
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
        "launches": dp["ring_launches"] + sum(
            sum(ring_of(ph).values()) for ph in extra),
        "data_parallel_launches": dp["ring_launches"],
        "mesh_launches": mesh_ring,
        "mesh2d_launches": ring_of(mesh2d),
        "multihost_launches": ring_of(multihost),
        "ctr_launches": ctr_launches.get("ring_allreduce"),
        "features_launches": fe_launches.get("ring_allreduce"),
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
    ms = mesh_phase(args.seed)
    print("phase mesh: " + json.dumps(dict(ms, card=card)), flush=True)
    m2 = mesh2d_phase(args.seed)
    print("phase mesh2d: " + json.dumps(dict(m2, card=card)), flush=True)
    mh = multihost_phase(args.seed)
    print("phase multihost: " + json.dumps(dict(mh, card=card)),
          flush=True)

    wf = workflow_phase(args.seed)
    print("phase workflow: " + json.dumps(dict(wf, card=card)), flush=True)
    for line in workflow_lines(wf):
        print(line, flush=True)
    for line in form_lines(wf):
        print(line + f" [{card}]", flush=True)
    sv = services_phase()
    print("phase services: " + json.dumps(dict(sv, card=card)), flush=True)

    ctr = ctr_phase(args.seed)
    print("phase ctr: " + json.dumps(dict(ctr, card=card)), flush=True)
    for line in ctr_lines(ctr):
        print(line, flush=True)

    fe = features_phase(args.seed)
    print("phase features: " + json.dumps(dict(fe, card=card), default=str),
          flush=True)
    for line in features_lines(fe):
        print(line, flush=True)

    fr = ft_phase(args.seed)
    print("phase ft: " + json.dumps(dict(fr, card=card), default=str),
          flush=True)
    for line in ft_lines(fr):
        print(line + f" [{card}]", flush=True)

    fl = fleet_phase(args.seed)
    print("phase fleet: " + json.dumps(dict(fl, card=card), default=str),
          flush=True)
    for line in fleet_lines(fl):
        print(line, flush=True)

    tuned = autotune_phase(args.seed, mix=serve["batch_mix"])
    brief = {k: v for k, v in tuned.items() if k not in ("hist", "serve")}
    brief["shapes"] = [{k: v for k, v in r.items() if k != "measurements"}
                       for r in tuned["hist"] + tuned["serve"]]
    print("phase autotune: " + json.dumps(dict(brief, card=card)),
          flush=True)
    for line in autotune_lines(tuned):
        print(line + f" [{card}]", flush=True)

    print(json.dumps(kernels_line(rows, serve, empty_ms, hrows, train, hmma,
                                  rrows, dp, wf, ctr, fe, fl, ms, m2, mh)),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
