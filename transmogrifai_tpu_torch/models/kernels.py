"""The tree-histogram kernel, the cross-rank ring reduction and the
training numerics policy.

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

The cross-rank reduction of row-sharded work (``allreduce_data``) is
the second kernel here: ``csrc/ring_allreduce.cu`` behind
``ring_allgather`` / ``ring_allreduce``, with the plain versions
``ring_allgather_torch`` / ``ring_allreduce_torch`` (see the section
below).

The TPU-only knobs ``TM_PALLAS``, ``TM_HIST_DOUBLE_BUFFER``,
``TM_HIST_MXU_ALIGN``, ``TM_HIST_ROWS_PER_STEP`` and the autotuner hook
size VMEM blocks and MXU tiles; the port reads none of them.
"""
from __future__ import annotations

import ctypes
import math
import os
import threading
from typing import Any, Dict, List, Optional

import torch

from .. import _cuda_build
from ..profiling import check_nan_outputs, nan_checking

#: the CUDA source this module's kernel builds from (under the package)
KERNEL_NAME = "tree_histogram"

#: the most static shared memory a block may take (no opt-in)
SMEM_MAX_BYTES = 48 * 1024
#: features a histogram block covers (a chunk), and features a warp of
#: it owns: a block has a warp per FEATURES_PER_WARP features of the
#: widest chunk, two at least
FEATURES_PER_BLOCK = 32
FEATURES_PER_WARP = 4
#: bins and stats a histogram block covers: two 16-bin tiles of the
#: one-hot A operand and one 8-stat tile of the B operand of mma
#: m16n8k16; larger B or S take more blocks
BIN_GROUP = 32
STAT_GROUP = 8
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
#: rows a histogram block stages through shared memory at a time (8
#: k-steps of 16): HIST_STAGES tiles of gathered bins (bytes, 48 a row)
#: and stats (f32, 12 a row) in flight, and HIST_IDX_SLOTS tiles of row
#: indices
TILE_ROWS = 128
HIST_STAGES = 3
HIST_IDX_SLOTS = 8
#: the kernel packs the bins once per launch, per group of BIN_GROUP
#: bins: a byte a bin relative to the group (255 outside it), rows
#: padded to a multiple of PACKED_ROW_ALIGN bytes
PACKED_ROW_ALIGN = 16
#: a launch's blocks must fit CUDA's one-dimensional grid
MAX_GRID_BLOCKS = 2 ** 31 - 1


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
    run_rows) + m``: one partial run per node at most); the blocks of
    the histogram pass, one per (instance, run slot, chunk of
    FEATURES_PER_BLOCK features, group of BIN_GROUP bins, group of
    STAT_GROUP stats), each of ``warps`` warps with its static shared
    memory; the packed bins (a byte a bin and bin group, ``dpad`` bytes
    a row); and the int32 workspace (the sort's words, then from a
    16-byte boundary the packed bins) and f32 partials the wrapper
    allocates. Raises when the sort cannot hold its node counters or
    the grid its blocks."""
    if m > MAX_NODES:
        raise ValueError(f"tree_histogram: m={m} nodes exceeds the "
                         f"{MAX_NODES} the sort's counters hold")
    sort_chunks = max(1, -(-n // SORT_CHUNK_ROWS))
    run_rows = max(RUN_ROWS, -(-n // MAX_RUNS))
    runs_cap = -(-n // run_rows) + m
    n_chunks = max(1, -(-d // FEATURES_PER_BLOCK))
    bin_groups = -(-B // BIN_GROUP)
    stat_groups = -(-S // STAT_GROUP)
    blocks = G * runs_cap * n_chunks * bin_groups * stat_groups
    if blocks > MAX_GRID_BLOCKS:
        raise ValueError(f"tree_histogram: {blocks} histogram blocks "
                         f"exceed the {MAX_GRID_BLOCKS}-block grid")
    # a staged row: 48 bytes of bins and 12 stat words; an index word
    smem = 4 * TILE_ROWS * (HIST_STAGES * (12 + 12) + HIST_IDX_SLOTS)
    assert smem <= SMEM_MAX_BYTES
    dpad = -(-d // PACKED_ROW_ALIGN) * PACKED_ROW_ALIGN
    sort_words = G * (m * sort_chunks + 2 * m + m + 1 + n)
    return {"run_rows": run_rows, "sort_chunk_rows": SORT_CHUNK_ROWS,
            "sort_chunks": sort_chunks, "runs_cap": runs_cap,
            "n_chunks": n_chunks, "bin_groups": bin_groups,
            "stat_groups": stat_groups, "blocks": blocks,
            "warps": max(2, -(-min(d, FEATURES_PER_BLOCK)
                              // FEATURES_PER_WARP)),
            "smem_bytes": smem, "dpad": dpad,
            "packed_bytes": bin_groups * n * dpad,
            "workspace_words": (-(-sort_words // 4) * 4
                                + -(-bin_groups * n * dpad // 4)),
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
    if nan_checking():          # launched outside torch's dispatcher
        check_nan_outputs("tree_histogram", out, stats_g)
    return out


#: launches of the CUDA kernel (the CPU path counts nothing)
histogram_grid.launches = 0


def histogram_cost(G: int, n: int, d: int, S: int, m: int,
                   B: int) -> Dict[str, float]:
    """What one call must do at least: every input read once and the
    output written once (bytes), and one f32 add per (instance, row,
    feature, stat) (operations). ``mma`` and ``mma_flop`` count what
    the kernel issues on the tensor cores in bf16 mode (three times
    that in exact mode): per instance, 16-row k-step of a node's rows
    and feature, ceil(B/16) x ceil(S/8) mma of m16n8k16, 4096 FLOP
    each. The k-steps are counted as if no node's rows left a partial
    k-step (each node's partial k-step adds at most one more)."""
    nbytes = 4.0 * (n * d + G * n * S + G * n + G * m * S * d * B)
    mma = float(G) * -(-n // 16) * d * -(-B // 16) * -(-S // 8)
    return {"bytes": nbytes, "adds": float(G) * n * d * S, "mma": mma,
            "mma_flop": 4096.0 * mma}


# ---------------------------------------------------------------------------
# Cross-rank reductions: the hand-written CUDA exchange (+ its plain
# version), named "ring" after the JAX package's RDMA ring
# ---------------------------------------------------------------------------
#
# Counterpart of the JAX package's ring_reduce_enabled / ring_allgather
# (the Pallas RDMA ring, _ring_gather_kernel) / ring_allreduce /
# allreduce_data. ``parts`` is one tensor per rank of a
# ``parallel.Mesh`` (parts[r] on mesh.devices[r], all the same shape,
# f32, contiguous); the result is one tensor per rank again.

#: the CUDA source of the ring kernel
RING_KERNEL_NAME = "ring_allreduce"
#: ranks the kernel takes (its RingPeers arrays)
RING_MAX_RANKS = 8
#: blocks one call may launch over all its ranks (csrc kWaveBlocks): one
#: wave of an H100's 132 SMs, so every rank's blocks are resident at once
RING_WAVE_BLOCKS = 132
#: floats a block owns at least, before the wave cap splits finer
RING_MIN_CHUNK = 4096
#: flag words per rank (csrc kFlagRows x kWaveBlocks): an "arrived" and
#: a "done" row per source rank
RING_FLAG_WORDS = 2 * RING_MAX_RANKS * RING_WAVE_BLOCKS
#: a wait on another rank longer than this traps (a protocol fault)
RING_TIMEOUT_S = 5.0

#: card index -> events recorded on every rank stream just after the
#: last exchange launched on that card. The next exchange touching the
#: card waits for them, so one exchange at a time is in flight on a card
#: (RING_WAVE_BLOCKS sizes one call's blocks to be resident together;
#: two calls of two meshes' grid rows could not all be)
_RING_TAIL: Dict[int, list] = {}
_RING_ORDER = threading.Lock()


def ring_reduce_enabled(device=None) -> bool:
    """Whether the cross-rank reductions of the data-parallel entry
    points (``parallel.sharded_histograms``, ``trees.grow_tree_grid(mesh=
    ...)``) launch the CUDA kernel: TM_MESH_RDMA_RING=1/0 forces; unset
    -> the kernel exactly when ``device`` is CUDA. On CPU tensors the
    kernel's wrapper runs its plain version either way."""
    from ..parallel.mesh import resolve_mesh_config
    cfg = resolve_mesh_config()
    if cfg.rdma_ring is not None:
        return cfg.rdma_ring
    return device is not None and torch.device(device).type == "cuda"


def _check_parts(parts, mesh):
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size} "
                         f"ranks")
    shape = parts[0].shape
    for r, (p, d) in enumerate(zip(parts, mesh.devices)):
        if p.dtype != torch.float32:
            raise TypeError(f"ring: rank {r} part is {p.dtype}, the ring "
                            f"takes float32 only")
        if p.shape != shape:
            raise ValueError(f"ring: rank {r} part {tuple(p.shape)} != "
                             f"rank 0's {tuple(shape)}")
        if p.device != d:
            raise ValueError(f"ring: rank {r} part on {p.device}, its rank "
                             f"is on {d}")


def ring_allgather_torch(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Plain version of the all-gather: the kernel's direct exchange run
    as tensor copies, every rank's part copied into slot r of every
    rank's output. Returns per rank the (ndev, ...) stack in origin
    order."""
    return [torch.stack([p.to(q.device, copy=True) for p in parts])
            for q in parts]


def ring_allreduce_torch(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Plain version of the all-reduce: the all-gather's origin order
    summed left to right in f32, ``acc = x_0; acc = acc + x_1; ...``:
    every rank gets the same bits, and the kernel's."""
    out = []
    for g in ring_allgather_torch(parts):
        acc = g[0].clone()
        for o in range(1, g.shape[0]):
            acc = acc + g[o]
        out.append(acc)
    return out


def _ceil4(x: int) -> int:
    return -(-x // 4) * 4


def ring_plan(numel: int, ndev: int, gather: bool = False) -> Dict[str, int]:
    """How a call cuts its parts. An all-reduce gives rank r partition r
    of the elements (``part`` floats, a multiple of 4 for 16-byte
    copies); an all-gather gives each rank its whole part (``part`` =
    numel). Each rank splits its share over ``blocks`` blocks (at most
    RING_WAVE_BLOCKS // ndev, so all ranks' blocks are resident at once
    on one card) of ``chunk`` floats (a multiple of 4). Depends on
    numel, ndev and the mode alone."""
    if numel <= 0:
        return {"blocks": 0, "chunk": 0, "part": 0}
    part = numel if gather else _ceil4(-(-numel // ndev))
    cap = max(1, RING_WAVE_BLOCKS // ndev)
    blocks = min(cap, -(-part // RING_MIN_CHUNK))
    chunk = _ceil4(-(-part // blocks))
    return {"blocks": -(-part // chunk), "chunk": chunk, "part": part}


def ring_cost(ndev: int, numel: int, same_card: bool) -> Dict[str, Any]:
    """The least an all-reduce of ndev f32 parts of ``numel`` values
    must do, and the time the H100 needs for it (the larger of bytes
    over the memory or link rate and adds over the f32 rate):

    * every part read once and every rank's output written once:
      ``8 * ndev * numel`` bytes of device memory, one card's 3.35 TB/s
      when the ranks share it (``same_card``), else per card
      ``8 * numel`` at that rate, beside the link: a card must receive
      at least ``2 * (ndev - 1) / ndev`` of a part (reduce-scatter then
      all-gather) over 450 GB/s of NVLink one way;
    * ``(ndev - 1) * numel`` f32 adds at 67 TFLOP/s.

    ``moved_bytes`` is what the kernel moves in a call: per rank it reads
    its partition of every input and writes it into every output, 4 x
    numel read and 4 x numel written, so ``8 * ndev * numel`` in all,
    the bound's bytes on one card."""
    hbm, link, f32 = 3.35e12, 450e9, 67e12
    adds = float(max(ndev - 1, 0)) * numel
    if same_card:
        nbytes = 8.0 * ndev * numel
        bytes_s = nbytes / hbm
    else:
        nbytes = 8.0 * numel
        link_bytes = 4.0 * numel * 2.0 * (ndev - 1) / ndev
        bytes_s = max(nbytes / hbm, link_bytes / link)
    ops_s = adds / f32
    return {"bytes": nbytes, "adds": adds,
            "moved_bytes": 8.0 * ndev * numel,
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


_RING_LIB = None


def _ring_library():
    """Build (first use) and bind the ring kernel's C entry points."""
    global _RING_LIB
    if _RING_LIB is None:
        lib = _cuda_build.load_library(RING_KERNEL_NAME)
        lib.tm_ring_launch_all.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_int] + [ctypes.c_longlong] * 3
            + [ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_void_p])
        lib.tm_ring_launch_all.restype = ctypes.c_int
        lib.tm_ring_prepare.argtypes = []
        lib.tm_ring_prepare.restype = ctypes.c_int
        lib.tm_ring_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.tm_ring_enable_peer.restype = ctypes.c_int
        lib.tm_ring_error_string.argtypes = [ctypes.c_int]
        lib.tm_ring_error_string.restype = ctypes.c_char_p
        for name, want in (("tm_ring_flag_words", RING_FLAG_WORDS),
                           ("tm_ring_max_ranks", RING_MAX_RANKS),
                           ("tm_ring_wave_blocks", RING_WAVE_BLOCKS)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [], ctypes.c_int
            if fn() != want:
                raise RuntimeError(f"{RING_KERNEL_NAME}: {name} is "
                                   f"{fn()}, the wrapper expects {want}")
        _RING_LIB = lib
    return _RING_LIB


def peer_pairs(devices) -> List[tuple]:
    """Every ordered pair (a, b) of distinct cards among ``devices``: the
    exchange reads and writes every rank's memory from every rank, so
    each such pair needs peer access."""
    cards = list(dict.fromkeys(torch.device(d) for d in devices))
    return [(a, b) for a in cards for b in cards if a != b]


class _RingComm:
    """One data mesh's flag words: per rank an array zeroed once and only
    ever raised to the call's epoch. Peer access is enabled once between
    every pair of distinct cards, and the kernel loaded into each card's
    context before its first launch."""

    def __init__(self, mesh):
        lib = _ring_library()
        ndev = mesh.size
        if ndev > RING_MAX_RANKS:
            raise ValueError(f"the ring takes at most {RING_MAX_RANKS} "
                             f"ranks, the mesh has {ndev}")
        for d in dict.fromkeys(mesh.devices):
            with torch.cuda.device(d):
                err = lib.tm_ring_prepare()
            if err:
                raise RuntimeError(f"ring kernel failed to load on {d}: "
                                   f"{lib.tm_ring_error_string(err).decode()}")
        for d, nb in peer_pairs(mesh.devices):
            err = lib.tm_ring_enable_peer(d.index, nb.index)
            if err == -1:
                raise RuntimeError(f"ring: {d} cannot access {nb}'s "
                                   f"memory (no peer access); the ring "
                                   f"never stages through the host")
            if err:
                raise RuntimeError(
                    f"ring: enabling peer access {d} -> {nb} failed: "
                    f"{lib.tm_ring_error_string(err).decode()}")
        self.flags = [torch.zeros(RING_FLAG_WORDS, dtype=torch.int32,
                                  device=d) for d in mesh.devices]
        self.epoch = 0


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _ring(parts, mesh, gather: bool) -> List[torch.Tensor]:
    """Launch one call: rank r's kernel on mesh.streams[r], every rank
    from one host call (tm_ring_launch_all). Outputs are allocated on
    the rank streams before it (an allocation may synchronise, and a
    synchronisation between launches would wait on a rank spinning for
    one not yet launched). Every rank reads every part and writes every
    output, yet each part is recorded on its own rank stream only: rank
    r's kernel ends only after every rank has posted "done" at the exit
    barrier, so after every other rank's reads of part r and writes to
    output r. Calls on one card are chained (``_RING_TAIL``): each rank
    stream first waits for the previous call on any of the mesh's cards
    to end, whichever mesh made it."""
    ndev = mesh.size
    shape = tuple(parts[0].shape)
    numel = parts[0].numel()
    out_shape = (ndev,) + shape if gather else shape
    if any(not p.is_contiguous() for p in parts):
        raise ValueError("ring: parts must be contiguous")
    if mesh.ring is None:
        mesh.ring = _RingComm(mesh)
    comm = mesh.ring
    mesh.fork()
    outs = []
    for r in range(ndev):
        with mesh.rank(r):
            outs.append(torch.empty(out_shape, dtype=torch.float32,
                                    device=mesh.devices[r]))
    plan = ring_plan(numel, ndev, gather=gather)
    if plan["blocks"] == 0:
        return outs
    for p, s in zip(parts, mesh.streams):
        p.record_stream(s)          # read until this rank's kernel ends
    lib = _ring_library()

    def ptrs(vals):
        return (ctypes.c_void_p * ndev)(*vals)
    vec = int(all(_aligned(t) for t in parts + outs)
              and (not gather or numel % 4 == 0))
    failed = ctypes.c_int(-1)
    cards = sorted({d.index for d in mesh.devices})
    with _RING_ORDER:
        for ev in {id(e): e for c in cards
                   for e in _RING_TAIL.get(c, ())}.values():
            for s in mesh.streams:
                s.wait_event(ev)
        comm.epoch = (comm.epoch + 1) & 0xFFFFFFFF
        err = lib.tm_ring_launch_all(
            ndev, (ctypes.c_int * ndev)(*[d.index for d in mesh.devices]),
            ptrs([p.data_ptr() for p in parts]),
            ptrs([o.data_ptr() for o in outs]),
            ptrs([f.data_ptr() for f in comm.flags]),
            ptrs([s.cuda_stream for s in mesh.streams]), vec, numel,
            plan["part"], plan["chunk"], plan["blocks"], comm.epoch,
            int(gather), int(len(set(mesh.devices)) > 1),
            int(RING_TIMEOUT_S * 1e9), ctypes.byref(failed))
        if not err:
            tail = []
            for s in mesh.streams:
                ev = torch.cuda.Event()
                ev.record(s)
                tail.append(ev)
            for c in cards:
                _RING_TAIL[c] = tail
    if err:
        raise RuntimeError(
            f"ring_allreduce launch failed on rank {failed.value} of "
            f"{ndev} (numel={numel}): "
            f"{lib.tm_ring_error_string(err).decode()}")
    return outs


def ring_allgather(parts: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """All-gather of one f32 part per rank -> per rank the (ndev, ...)
    stack in ORIGIN order, bitwise the same on every rank.

    On CPU tensors this is :func:`ring_allgather_torch`. On CUDA tensors
    it launches ``csrc/ring_allreduce.cu`` (gather mode) once per rank,
    each on its rank's stream (built at first use), and raises if the
    build or a launch fails. The parts must be ready on their ranks'
    streams or on their cards' current streams (``mesh.fork()`` runs
    first); the outputs are ready on the rank streams (``mesh.join`` for
    the current streams). ``ring_allgather.launches`` counts launches."""
    _check_parts(parts, mesh)
    if not mesh.is_cuda:
        return ring_allgather_torch(parts)
    outs = _ring(parts, mesh, gather=True)
    with _LAUNCH_LOCK:
        ring_allgather.launches += mesh.size if parts[0].numel() else 0
    if nan_checking():          # launched outside torch's dispatcher
        check_nan_outputs("ring_allgather", outs, parts)
    return outs


def ring_allreduce(parts: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Sum of one f32 part per rank -> per rank the origin-order sum
    ``((x_0 + x_1) + x_2) + ...`` in f32: every rank holds the same
    bits, equal to :func:`ring_allreduce_torch` (a psum's order is the
    backend's; the ring's is pinned). CPU tensors take the plain
    version; CUDA tensors launch the kernel as :func:`ring_allgather`
    does, each rank summing its partition of the elements once and
    writing the sum to every rank. ``ring_allreduce.launches`` counts
    launches."""
    _check_parts(parts, mesh)
    if not mesh.is_cuda:
        return ring_allreduce_torch(parts)
    outs = _ring(parts, mesh, gather=False)
    with _LAUNCH_LOCK:
        ring_allreduce.launches += mesh.size if parts[0].numel() else 0
    if nan_checking():          # launched outside torch's dispatcher
        check_nan_outputs("ring_allreduce", outs, parts)
    return outs


#: launches of the CUDA kernel, one per rank per call (CPU counts nothing)
ring_allgather.launches = 0
ring_allreduce.launches = 0


def allreduce_data(parts: List[torch.Tensor], mesh,
                   use_ring: Optional[bool] = None) -> List[torch.Tensor]:
    """The cross-rank histogram/gradient reduction of row-partitioned
    work, the one policy point: :func:`ring_allreduce` (the CUDA ring)
    when ``use_ring``, else the plain origin-order sum
    :func:`ring_allreduce_torch` (TM_MESH_RDMA_RING=0: the port's psum,
    an explicit choice, never a fallback). At one rank the parts are
    returned as they are.

    ``use_ring=None`` resolves :func:`ring_reduce_enabled` here; a
    caller that makes several reductions resolves it once on the host
    and passes it, so one computation never mixes the two."""
    if mesh.size <= 1:
        return list(parts)
    return _policy_call(parts, mesh, use_ring, ring_allreduce,
                        ring_allreduce_torch)


def allgather_data(parts: List[torch.Tensor], mesh,
                   use_ring: Optional[bool] = None) -> List[torch.Tensor]:
    """The cross-rank all-gather of row-partitioned work (the sharded
    statistics' extrema and columns), the same policy as
    :func:`allreduce_data`: :func:`ring_allgather` (the CUDA kernel in
    gather mode) when ``use_ring``, else :func:`ring_allgather_torch`.
    Per rank the (ndev, ...) stack in origin order; at one rank each
    part with a leading axis of one."""
    if mesh.size <= 1:
        return [p[None] for p in parts]
    return _policy_call(parts, mesh, use_ring, ring_allgather,
                        ring_allgather_torch)


def _policy_call(parts, mesh, use_ring, kernel_fn, plain_fn):
    if use_ring is None:
        use_ring = ring_reduce_enabled(parts[0].device)
    if use_ring or not mesh.is_cuda:
        return kernel_fn(parts, mesh)
    # the plain version reads every rank's part: it runs on the cards'
    # current streams, after the rank streams, and hands back to them
    _check_parts(parts, mesh)
    mesh.join(*parts)
    outs = plain_fn(parts)
    mesh.fork()
    for o, s in zip(outs, mesh.streams):
        o.record_stream(s)
    return outs
