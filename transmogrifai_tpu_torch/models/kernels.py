"""The tree-histogram kernel and the training numerics policy.

Counterpart of ``transmogrifai_tpu/models/kernels.py``. There the
histogram of every tree level is either a one-hot MXU matmul in XLA
(``histogram_xla``) or the Pallas kernels ``_hist_grid_kernel`` and
``_hist_db_kernel`` behind ``histogram_pallas_grid``; here it is
:func:`histogram_grid`, which launches the hand-written CUDA kernel
``csrc/tree_histogram.cu`` on a CUDA tensor and runs the plain PyTorch
version :func:`histogram_torch` (the vmapped ``histogram_xla``
formulation) on a CPU tensor. On the card the kernel is always the
path: no knob selects another formulation and nothing falls back.

The function, for G instances over one shared binned matrix::

    out[g, node*S + s, j*B + b] = sum_i r(stats[g, i, s])
                                  * [pos[g, i] == node] * [bins[i, j] == b]

with r() rounding the masked stat to the hist dtype (the rounding point
of the XLA formulation: mask in f32, then cast) and f32 accumulation.

Numerics policy (the JAX package's knobs, same meaning):

* ``TM_KERNEL_EXACT=1`` pins f32 operands (:func:`kernel_exact`);
* ``TM_HIST_BF16=1/0`` forces bf16/f32 operands; unset means bf16 on
  CUDA and f32 on the CPU (:func:`env_dtype`, :func:`hist_dtype`);
* ``TM_HIST_ACCUM_BF16=1`` (bf16 accumulation) is not ported and raises
  (:func:`hist_accum_bf16`).

The TPU-only knobs ``TM_PALLAS``, ``TM_HIST_DOUBLE_BUFFER``,
``TM_HIST_MXU_ALIGN``, ``TM_HIST_ROWS_PER_STEP`` and the autotuner hook
size VMEM blocks and MXU tiles; the port reads none of them.
"""
from __future__ import annotations

import ctypes
import math
import os
import threading
from typing import Dict

import torch

from .. import _cuda_build

#: the CUDA source this module's kernel builds from (under the package)
KERNEL_NAME = "tree_histogram"

#: the most shared memory a block may take (the H100's opt-in limit)
SMEM_MAX_BYTES = 227 * 1024
#: features a histogram block covers: one warp, a lane per feature
FEATURES_PER_BLOCK = 32
#: nodes a launch may have: the sort keeps a counter per node in
#: shared memory (48 KB without opt-in)
MAX_NODES = 12 * 1024
#: rows of one node a histogram block takes (a run): RUN_ROWS, or more
#: when n is so large that an instance would need over MAX_RUNS runs
#: (each run keeps a partial histogram in device memory); and rows of
#: one instance a sort block ranks (a chunk). Both depend on n alone, so
#: an instance's runs and sums do not depend on G or on the other
#: instances: its histogram is the same alone or inside any batch
RUN_ROWS = 2048
MAX_RUNS = 128
SORT_CHUNK_ROWS = 1024
#: rows a histogram block stages through shared memory at a time
TILE_ROWS = 32


def kernel_exact() -> bool:
    """TM_KERNEL_EXACT=1 pins every kernel formulation to the bitwise
    reference: f32 contraction inputs and f32 accumulation. Integer-
    valued stats then give bitwise-equal histograms from the kernel and
    the plain version (integer sums are exact in f32 in any order)."""
    return os.environ.get("TM_KERNEL_EXACT", "0") == "1"


def env_dtype(flag_name: str, device) -> torch.dtype:
    """Flag-to-dtype policy of the mixed-precision knobs (TM_HIST_BF16):
    "1" forces bfloat16, "0" forces float32, unset means bf16 exactly
    when ``device`` is CUDA (the JAX package: exactly on the TPU)."""
    flag = os.environ.get(flag_name)
    if flag == "1":
        return torch.bfloat16
    if flag == "0":
        return torch.float32
    return (torch.bfloat16 if torch.device(device).type == "cuda"
            else torch.float32)


def hist_dtype(device) -> torch.dtype:
    """Histogram operand dtype on ``device``: TM_KERNEL_EXACT=1 pins
    f32; else :func:`env_dtype` of TM_HIST_BF16. Accumulation is f32."""
    if kernel_exact():
        return torch.float32
    return env_dtype("TM_HIST_BF16", device)


def hist_accum_bf16() -> bool:
    """bf16 ACCUMULATION (the JAX package's TM_HIST_ACCUM_BF16=1
    deviation) is not ported: the knob raises instead of being ignored.
    TM_KERNEL_EXACT=1 wins and keeps f32, as in the JAX package."""
    if (not kernel_exact()
            and os.environ.get("TM_HIST_ACCUM_BF16", "0") == "1"):
        raise NotImplementedError(
            "TM_HIST_ACCUM_BF16=1 (bf16 histogram accumulation) is not "
            "ported to transmogrifai_tpu_torch; unset it (accumulation "
            "is f32)")
    return False


def _round_operand(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return t if dt == torch.float32 else t.to(dt).to(torch.float32)


def _check_args(bins, stats_g, pos_g, m: int, B: int):
    """Device, dtype and shape checks shared by the kernel wrapper and
    the plain version; returns (G, n, S, d)."""
    if bins.dim() != 2 or stats_g.dim() != 3 or pos_g.dim() != 2:
        raise ValueError(
            f"want bins (n, d), stats (G, n, S), pos (G, n); got "
            f"{tuple(bins.shape)}, {tuple(stats_g.shape)}, "
            f"{tuple(pos_g.shape)}")
    n, d = (int(s) for s in bins.shape)
    G, n2, S = (int(s) for s in stats_g.shape)
    if n2 != n or tuple(pos_g.shape) != (G, n):
        raise ValueError(
            f"row counts disagree: bins {tuple(bins.shape)}, stats "
            f"{tuple(stats_g.shape)}, pos {tuple(pos_g.shape)}")
    if m < 1 or B < 1:
        raise ValueError(f"need m >= 1 and B >= 1, got m={m}, B={B}")
    if bins.dtype != torch.int32 or pos_g.dtype != torch.int32:
        raise TypeError(f"bins and pos must be int32, got {bins.dtype}, "
                        f"{pos_g.dtype}")
    if stats_g.dtype != torch.float32:
        raise TypeError(f"stats must be float32, got {stats_g.dtype}")
    if not (bins.device == stats_g.device == pos_g.device):
        raise ValueError(f"bins, stats, pos on different devices: "
                         f"{bins.device}, {stats_g.device}, {pos_g.device}")
    return G, n, S, d


def histogram_torch(bins: torch.Tensor, stats_g: torch.Tensor,
                    pos_g: torch.Tensor, m: int, B: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the vmapped
    ``histogram_xla`` formulation. bins (n, d) int32, stats (G, n, S)
    f32, pos (G, n) int32 -> (G, m*S, d*B) f32, column j*B + b. The
    node mask is applied in f32 and the product then rounded to
    :func:`hist_dtype` of the device; the product of a rounded operand
    and a 0/1 one-hot is exact in f32, so the f32 matmul below is the
    rounded-operand, f32-accumulate contraction (on CUDA only while
    ``torch.backends.cuda.matmul.allow_tf32`` is off, its default).
    Instances run in chunks of g so the masked-stats matrix stays near
    256 MB."""
    G, n, S, d = _check_args(bins, stats_g, pos_g, m, B)
    hist_accum_bf16()
    dt = hist_dtype(bins.device)
    dev = bins.device
    Z = (bins[:, :, None] == torch.arange(B, device=dev, dtype=torch.int32)
         ).reshape(n, d * B).to(torch.float32)
    out = torch.empty((G, m * S, d * B), dtype=torch.float32, device=dev)
    step = max(1, (64 << 20) // max(n * m * S, 1))
    nodes = torch.arange(m, device=dev, dtype=torch.int32)
    for g0 in range(0, G, step):
        g1 = min(G, g0 + step)
        node_oh = (pos_g[g0:g1, :, None] == nodes).to(torch.float32)
        A = (node_oh[:, :, :, None]
             * stats_g[g0:g1, :, None, :]).reshape(g1 - g0, n, m * S)
        out[g0:g1] = torch.matmul(_round_operand(A, dt).transpose(1, 2), Z)
    return out


def launch_plan(G: int, n: int, d: int, S: int, m: int,
                B: int) -> Dict[str, int]:
    """How the kernel cuts one launch: the sort's row chunks; the rows
    of a run and the most runs an instance can need (``ceil(n /
    run_rows) + m``: one partial run per node at most); the feature
    chunks of FEATURES_PER_BLOCK features (one warp a block); the
    dynamic shared memory of a histogram block (its [S][B+1][32] slab
    plus two TILE_ROWS-row tiles of bins and stats padded to 4); and the
    int32 workspace and f32 partials the wrapper allocates. Raises when
    a block cannot hold its slab or the sort its node counters."""
    F = FEATURES_PER_BLOCK
    smem = 4 * (S * (B + 1) * F + 2 * TILE_ROWS * (F + -(-S // 4) * 4))
    if smem > SMEM_MAX_BYTES:
        raise ValueError(
            f"tree_histogram: a block's histogram slab ({S} stats x "
            f"{B + 1} bin rows x {F} features x 4 bytes) exceeds the "
            f"{SMEM_MAX_BYTES}-byte shared-memory budget")
    if m > MAX_NODES:
        raise ValueError(f"tree_histogram: m={m} nodes exceeds the "
                         f"{MAX_NODES} the sort's counters hold")
    sort_chunks = max(1, -(-n // SORT_CHUNK_ROWS))
    run_rows = max(RUN_ROWS, -(-n // MAX_RUNS))
    runs_cap = -(-n // run_rows) + m
    return {"run_rows": run_rows, "sort_chunk_rows": SORT_CHUNK_ROWS,
            "sort_chunks": sort_chunks, "runs_cap": runs_cap,
            "n_chunks": max(1, -(-d // F)), "smem_bytes": smem,
            "workspace_words": G * (m * sort_chunks + 2 * m + m + 1 + n),
            "partial_floats": G * runs_cap * S * d * B}


_LAUNCH_LOCK = threading.Lock()
_LIB = None


def _library():
    """Build (first use) and bind the kernel's C entry points."""
    global _LIB
    if _LIB is None:
        lib = _cuda_build.load_library(KERNEL_NAME)
        fn = lib.tm_tree_histogram
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                               ctypes.c_void_p,
                                               ctypes.c_longlong] \
            + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tm_tree_histogram_error_string.argtypes = [ctypes.c_int]
        lib.tm_tree_histogram_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def histogram_grid(bins: torch.Tensor, stats_g: torch.Tensor,
                   pos_g: torch.Tensor, m: int, B: int) -> torch.Tensor:
    """Node x feature x bin histograms of per-row stats for G instances
    over SHARED bins, in ONE kernel launch.

    bins (n, d) int32 in [0, B); stats (G, n, S) f32; pos (G, n) int32
    node index in [0, m) (a row outside [0, m), or a bin outside
    [0, B), adds nothing, as the one-hot formulation gives). Returns
    (G, m*S, d*B) f32 — memory laid out as (G, m, S, d, B), the layout
    ``trees.grow_tree_grid`` reads. The operand dtype is
    :func:`hist_dtype` of the device (bf16 or f32); accumulation is
    f32.

    On a CPU tensor this is :func:`histogram_torch`. On a CUDA tensor it
    launches ``csrc/tree_histogram.cu`` on the current stream (built at
    first use) and raises if the build or the launch fails; the result
    is deterministic and an instance's histogram does not depend on the
    other instances of the launch. ``histogram_grid.launches`` counts
    launches."""
    G, n, S, d = _check_args(bins, stats_g, pos_g, m, B)
    hist_accum_bf16()
    if bins.device.type == "cpu":
        return histogram_torch(bins, stats_g, pos_g, m, B)
    if bins.device.type != "cuda":
        raise ValueError(f"histogram_grid: unsupported device "
                         f"{bins.device}")
    dt = hist_dtype(bins.device)
    if not (bins.is_contiguous() and stats_g.is_contiguous()
            and pos_g.is_contiguous()):
        raise ValueError("histogram_grid: bins, stats and pos must be "
                         "contiguous")
    out = torch.empty((G, m * S, d * B), dtype=torch.float32,
                      device=bins.device)
    if G == 0 or d == 0:
        return out
    plan = launch_plan(G, n, d, S, m, B)
    lib = _library()
    work = torch.empty(plan["workspace_words"], dtype=torch.int32,
                       device=bins.device)
    partial = torch.empty(plan["partial_floats"], dtype=torch.float32,
                          device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        err = lib.tm_tree_histogram(
            bins.data_ptr(), stats_g.data_ptr(), pos_g.data_ptr(),
            out.data_ptr(), work.data_ptr(), work.numel(),
            partial.data_ptr(), partial.numel(), n, d, G, S, m, B,
            int(dt == torch.bfloat16), plan["run_rows"],
            plan["sort_chunk_rows"], plan["runs_cap"], stream)
    if err != 0:
        raise RuntimeError(
            f"tree_histogram launch failed (G={G}, n={n}, d={d}, S={S}, "
            f"m={m}, B={B}): "
            f"{lib.tm_tree_histogram_error_string(err).decode()}")
    with _LAUNCH_LOCK:
        histogram_grid.launches += 1
    return out


#: launches of the CUDA kernel (the CPU path counts nothing)
histogram_grid.launches = 0


def histogram_cost(G: int, n: int, d: int, S: int, m: int,
                   B: int) -> Dict[str, float]:
    """What one call must do at least: every input read once and the
    output written once (bytes), and one f32 add per (instance, row,
    feature, stat) (operations)."""
    nbytes = 4.0 * (n * d + G * n * S + G * n + G * m * S * d * B)
    return {"bytes": nbytes, "adds": float(G) * n * d * S}
