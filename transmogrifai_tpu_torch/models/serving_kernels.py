"""Fused cross-model serving kernel: one launch per (backend-family,
bucket) slice, scoring each request row under its own model out of K
stacked linear heads.

Counterpart of ``transmogrifai_tpu/models/serving_kernels.py`` and of
the jitted pass around it in ``transmogrifai_tpu/serving/fusion.py``.
There the Pallas kernel ``_fused_db_kernel`` streams rows through VMEM
and runs one masked ``(n, K*L)`` MXU contraction, and XLA fuses each
member's prefix (impute, null indicators, concat, keep_cols) and the
head's activation around it into one program. Here one hand-written
CUDA kernel, ``csrc/fused_linear_scores.cu``, does all of it: each row
builds its features from the raw boundary values through its own
model's prefix tables (:func:`fused_prefix_scores`), is scored against
its own ``(p+1, L)`` weight block, and leaves as probabilities (see
the note in the source for why that is the same function, and what
bounds it on an H100). :func:`fused_linear_scores` is the same kernel
launched with the identity table: with the identity activation it is
the JAX package's ``fused_linear_scores``, and with a head's activation
it scores the serving pass's generic form (each member's own prefix
run before it, ``serving/fusion.py``).

The prefix tables (:data:`OP_VALUE`, :data:`OP_FILLED`,
:data:`OP_NULL`): feature ``j`` of a row under model ``k`` reads
boundary column ``src[k, j]`` and is that value as is, the value with
NaN replaced by ``fill[k, j]``, or the value's null indicator.

:func:`fused_linear_scores_torch` is the plain PyTorch version of the
contraction: the XLA twin's formulation (flattened weight block,
intercept-row add, iota mask, ``where`` before the reduction, 0/1
group-sum dot) in torch; :func:`fused_prefix_scores_torch` puts the
prefix gather (:func:`prefix_features_torch`) before it and the
activation (:func:`apply_activation`) after it. The wrappers take the
plain versions only for tensors on the CPU; on CUDA tensors they launch
the kernel or raise — no fallback.

Launch choice: the rows a block covers before the grid-stride cap
(``block_rows``, :data:`STATIC_LAUNCH_CONFIG`) changes no bit, since a
warp owns a row. On CUDA the wrappers take it from the caller's
``config=``, else from the learned autotuner's hook
(``autotune.serving_launch_config``, off unless ``TM_AUTOTUNE=1`` and a
serving model is set), else the static rule. The rule itself lives in
the C entry alone; :func:`launch_blocks_on_card` asks it for the grid
a choice launches.

Numerics policy (mirrors ``kernel_exact`` and ``serve_dtype`` of the
JAX package): ``TM_KERNEL_EXACT=1`` pins f32 operands; otherwise
operands round to bf16 on CUDA and stay f32 on the CPU. Accumulation is
f32 always, and the intercept is added in f32 after the dot. On CUDA
the plain version's f32 matrix products are the f32 reference only
while ``torch.backends.cuda.matmul.allow_tf32`` is off (its default);
the callers that compare against it keep it off.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .. import _cuda_build
from ..profiling import check_nan_outputs, nan_checking
from .linear import sigmoid_pair
# TM_KERNEL_EXACT=1: the engine's fused path on the CPU runs each
# model's own tail (serving/fusion.py); the card's kernel takes f32
# operands
from .kernels import kernel_exact

#: the CUDA source this module's kernel builds from (under the package)
KERNEL_NAME = "fused_linear_scores"

#: prefix-table op codes: feature = the boundary value as is, the value
#: with NaN filled, or the value's null indicator (1 for NaN, else 0)
OP_VALUE, OP_FILLED, OP_NULL = 0, 1, 2

#: the stackable heads' activations, by the kernel's activation code
ACTIVATIONS = {"identity": 0, "sigmoid_pair": 1, "softmax": 2}

#: warps of a block (csrc kWarps): a warp owns a row
WARPS_PER_BLOCK = 8
#: the launch choice (the autotuner's config key) at its static value:
#: one row a warp, so ceil(n / 8) blocks before the cap
STATIC_LAUNCH_CONFIG = {"block_rows": WARPS_PER_BLOCK}


def serve_dtype(device) -> torch.dtype:
    """Operand dtype of the serving contraction on ``device``:
    TM_KERNEL_EXACT=1 pins f32; otherwise bf16 on CUDA, f32 everywhere
    else. Accumulation is ALWAYS f32 — only the operand precision
    moves."""
    if kernel_exact():
        return torch.float32
    return (torch.bfloat16 if torch.device(device).type == "cuda"
            else torch.float32)


def serve_policy_token(device) -> tuple:
    """Everything that changes the fused serving path's numerics on
    ``device``. Any cache over the fused path MUST key on this (plus
    its own shape/config key): a flipped knob then rebuilds instead of
    silently reusing a stale scorer."""
    dev = torch.device(device)
    return (kernel_exact(), str(serve_dtype(dev)), dev.type)


def _round_operand(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round an f32 operand to the serve dtype and back to f32: the
    product of two bf16 values is exact in f32, so an f32 product of
    rounded operands is the bf16-operand / f32-accumulate contraction."""
    return t if dt == torch.float32 else t.to(dt).to(torch.float32)


def _check_args(X, W, mid):
    """Device, dtype and shape checks shared by the kernel wrapper and
    the plain version; returns (n, p, K, L)."""
    if X.dim() != 2 or W.dim() != 3 or mid.dim() != 1:
        raise ValueError(
            f"want X (n, p), W (K, p+1, L), mid (n,); got "
            f"{tuple(X.shape)}, {tuple(W.shape)}, {tuple(mid.shape)}")
    n, p = (int(s) for s in X.shape)
    K, L = _check_head(n, p, X, W, mid, "X")
    return n, p, K, L


def _check_head(n, p, rows, W, mid, what):
    """Checks of W (K, p+1, L) and mid (n,) against ``rows``, the
    (n, ...) f32 input named ``what``; returns (K, L)."""
    K, p1, L = (int(s) for s in W.shape)
    if p1 != p + 1:
        raise ValueError(
            f"weight stack rows {p1} != features+intercept {p + 1}")
    if int(mid.shape[0]) != n:
        raise ValueError(f"mid has {int(mid.shape[0])} rows, {what} has "
                         f"{n}")
    if rows.dtype != torch.float32 or W.dtype != torch.float32:
        raise TypeError(f"{what} and W must be float32, got {rows.dtype}, "
                        f"{W.dtype}")
    if mid.dtype != torch.int32:
        raise TypeError(f"mid must be int32, got {mid.dtype}")
    if not (rows.device == W.device == mid.device):
        raise ValueError(f"{what}, W, mid on different devices: "
                         f"{rows.device}, {W.device}, {mid.device}")
    return K, L


def fused_linear_scores_torch(X: torch.Tensor, W: torch.Tensor,
                              mid: torch.Tensor, *,
                              dtype: Optional[torch.dtype] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the XLA twin's formulation):
    X (n, p) f32, W (K, p+1, L) f32 stacked weights (last row the
    intercept), mid (n,) int32 -> (n, L) f32 raw scores. ``dtype`` is
    the operand dtype (None: :func:`serve_dtype` of X's device)."""
    n, p, K, L = _check_args(X, W, mid)
    dt = serve_dtype(X.device) if dtype is None else dtype
    dev = X.device
    Wflat = W.permute(1, 0, 2).reshape(p + 1, K * L)
    z = _round_operand(X, dt) @ _round_operand(Wflat[:p], dt)
    z = z + Wflat[p][None, :]
    cols = torch.arange(K * L, device=dev, dtype=torch.int32)
    mask = (cols // L)[None, :] == mid.reshape(-1, 1)
    masked = torch.where(mask, z, torch.zeros((), device=dev))
    sel = (cols[:, None] % L
           == torch.arange(L, device=dev, dtype=torch.int32)[None, :])
    return masked @ sel.to(torch.float32)


def _check_prefix_args(V, mid, src, op, fill, W, act):
    """Checks of the prefix form shared by the kernel wrapper and the
    plain version; returns (n, C, p, K, L)."""
    if V.dim() != 2 or src.dim() != 2 or W.dim() != 3 or mid.dim() != 1:
        raise ValueError(
            f"want V (n, C), src (K, p), W (K, p+1, L), mid (n,); got "
            f"{tuple(V.shape)}, {tuple(src.shape)}, {tuple(W.shape)}, "
            f"{tuple(mid.shape)}")
    n, C = (int(s) for s in V.shape)
    K, p = (int(s) for s in src.shape)
    if tuple(op.shape) != (K, p) or tuple(fill.shape) != (K, p):
        raise ValueError(f"prefix tables disagree: src {(K, p)}, op "
                         f"{tuple(op.shape)}, fill {tuple(fill.shape)}")
    KW, L = _check_head(n, p, V, W, mid, "V")
    if KW != K:
        raise ValueError(f"{KW} weight blocks for {K} prefix tables")
    if (src.dtype, op.dtype, fill.dtype) != (torch.int32, torch.uint8,
                                             torch.float32):
        raise TypeError(f"src, op, fill must be int32, uint8, float32; "
                        f"got {src.dtype}, {op.dtype}, {fill.dtype}")
    if not (V.device == src.device == op.device == fill.device):
        raise ValueError(f"V and the prefix tables on different devices: "
                         f"{V.device}, {src.device}, {op.device}, "
                         f"{fill.device}")
    _check_act(act, L)
    return n, C, p, K, L


def _check_act(act, L):
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r} (have "
                         f"{sorted(ACTIVATIONS)})")
    if act == "sigmoid_pair" and L != 1:
        raise ValueError(f"a sigmoid pair head has L = 1, got {L}")


def prefix_features_torch(V: torch.Tensor, mid: torch.Tensor,
                          src: torch.Tensor, op: torch.Tensor,
                          fill: torch.Tensor) -> torch.Tensor:
    """Plain version of the prefix: (n, p) f32 features, row ``i`` built
    by model ``mid[i]``'s tables from its boundary values ``V[i]`` (a
    row outside [0, K) by model 0's; its score is 0 whatever they
    hold). Selection only, so each feature is bitwise what the eager
    impute / concat / keep_cols chain gives."""
    K = int(src.shape[0])
    own = torch.where((mid >= 0) & (mid < K), mid,
                      torch.zeros_like(mid)).long()
    v = V.gather(1, src[own].long())
    isnull = torch.isnan(v)
    o = op[own]
    filled = torch.where(isnull & (o == OP_FILLED), fill[own], v)
    return torch.where(o == OP_NULL, isnull.to(torch.float32), filled)


def apply_activation(act: str, z: torch.Tensor) -> torch.Tensor:
    """The head's fixed activation over raw stacked scores (n, L) —
    the same ops the per-family predict functions apply."""
    if act == "sigmoid_pair":
        return sigmoid_pair(z[:, 0])
    if act == "softmax":
        return torch.softmax(z, dim=1)
    return z


def fused_prefix_scores_torch(V: torch.Tensor, mid: torch.Tensor,
                              src: torch.Tensor, op: torch.Tensor,
                              fill: torch.Tensor, W: torch.Tensor, *,
                              act: str,
                              dtype: Optional[torch.dtype] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel's prefix form: the prefix
    gather, :func:`fused_linear_scores_torch`, the activation. V (n, C)
    f32 boundary values, mid (n,) int32, src / op / fill (K, p) int32 /
    uint8 / f32 prefix tables, W (K, p+1, L) f32 -> (n, n_out) f32
    (n_out = 2 for a sigmoid pair, else L)."""
    _check_prefix_args(V, mid, src, op, fill, W, act)
    X = prefix_features_torch(V, mid, src, op, fill)
    return apply_activation(
        act, fused_linear_scores_torch(X, W, mid, dtype=dtype))


_LAUNCH_LOCK = threading.Lock()
_LIB = None


def _library():
    """Build (first use) and bind the kernel's C entry points."""
    global _LIB
    if _LIB is None:
        lib = _cuda_build.load_library(KERNEL_NAME)
        fn = lib.tm_fused_scores
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = lib.tm_fused_launch_blocks
        plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        plan.restype = ctypes.c_int
        # an empty launch through the same path (timing floor only)
        lib.tm_empty_launch.argtypes = [ctypes.c_void_p]
        lib.tm_empty_launch.restype = ctypes.c_int
        lib.tm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tm_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(V, mid, tables, W, n, C, p, K, L, act, dt,
            config) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors (``tables`` None: the
    identity table) under the launch ``config`` (None: the autotuner's
    decision, else the static rule); counts on
    ``fused_linear_scores.launches``."""
    if V.device.type != "cuda":
        raise ValueError(f"fused serving kernel: unsupported device "
                         f"{V.device}")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"operand dtype {dt} not supported by the kernel")
    if not all(t.is_contiguous() for t in (V, mid, W) + tuple(tables or ())):
        raise ValueError("fused serving kernel: V (X), mid, W and the "
                         "prefix tables must be contiguous")
    n_out = 2 if act == "sigmoid_pair" else L
    out = torch.empty((n, n_out), dtype=torch.float32, device=V.device)
    if n == 0:
        return out
    lib = _library()
    if config is None:
        from ..autotune.runtime import serving_launch_config
        config = serving_launch_config(
            grid=lambda br: launch_blocks_on_card(
                V.device, n, p, K, L, tables=bool(tables), block_rows=br),
            K=K, n=n, p=p, L=L)
    block_rows = launch_config(config)["block_rows"]
    src, op, fill = (t.data_ptr() for t in tables) if tables else (None,) * 3
    stream = torch.cuda.current_stream(V.device).cuda_stream
    with torch.cuda.device(V.device):
        err = lib.tm_fused_scores(
            V.data_ptr(), mid.data_ptr(), src, op, fill, W.data_ptr(),
            out.data_ptr(), n, C, p, K, L, ACTIVATIONS[act],
            int(dt == torch.bfloat16), block_rows, stream)
    if err != 0:
        raise RuntimeError(
            f"fused serving kernel launch failed (n={n}, C={C}, p={p}, "
            f"K={K}, L={L}, act={act}): "
            f"{lib.tm_cuda_error_string(err).decode()}")
    with _LAUNCH_LOCK:
        fused_linear_scores.launches += 1
    if nan_checking():          # launched outside torch's dispatcher
        check_nan_outputs("fused_linear_scores", out, (V, W))
    return out


def fused_linear_scores(X: torch.Tensor, W: torch.Tensor,
                        mid: torch.Tensor, *, act: str = "identity",
                        dtype: Optional[torch.dtype] = None,
                        config: Optional[Dict[str, int]] = None
                        ) -> torch.Tensor:
    """Score ``X[i]`` under model ``mid[i]`` for K stacked linear models
    in ONE kernel launch.

    X: (n, p) f32 request rows. W: (K, p+1, L) f32 stacked weights,
    last row the intercept. mid: (n,) int32 model index per row (a row
    outside [0, K) scores 0 before the activation). ``act``: one of
    :data:`ACTIVATIONS`, the identity by default (raw scores, the JAX
    package's ``fused_linear_scores``). Returns (n, n_out) f32 (n_out =
    2 for a sigmoid pair, else L). ``dtype`` is the operand dtype
    (None: :func:`serve_dtype` of X's device; bf16 and f32 are
    supported).

    On a CPU tensor this is :func:`fused_linear_scores_torch` and
    :func:`apply_activation`. On a CUDA tensor it launches
    ``csrc/fused_linear_scores.cu`` with the identity table and ``act``,
    on the current stream (built at first use), and raises if the build
    or the launch fails. ``config`` is the launch choice
    (:func:`launch_config`; unset: the autotuner's decision, else the
    static rule), which changes no bit. ``fused_linear_scores.launches``
    counts the kernel's launches, from this entry and from
    :func:`fused_prefix_scores`."""
    n, p, K, L = _check_args(X, W, mid)
    _check_act(act, L)
    dt = serve_dtype(X.device) if dtype is None else dtype
    if config is not None:
        launch_config(config)   # the plain version has none; check it
    if X.device.type == "cpu":
        return apply_activation(
            act, fused_linear_scores_torch(X, W, mid, dtype=dt))
    return _launch(X, mid, None, W, n, p, p, K, L, act, dt, config)


#: launches of the CUDA kernel from either entry (the CPU path counts
#: nothing)
fused_linear_scores.launches = 0


def fused_prefix_scores(V: torch.Tensor, mid: torch.Tensor,
                        src: torch.Tensor, op: torch.Tensor,
                        fill: torch.Tensor, W: torch.Tensor, *, act: str,
                        dtype: Optional[torch.dtype] = None,
                        config: Optional[Dict[str, int]] = None
                        ) -> torch.Tensor:
    """One fused serving slice in ONE kernel launch: each row's
    features built from its boundary values by its own model's prefix
    tables, scored under its own model, through the head's activation.

    V: (n, C) f32 boundary values. mid: (n,) int32 model index per row
    (a row outside [0, K) gets raw scores 0 before the activation).
    src / op / fill: (K, p) int32 / uint8 / f32 prefix tables (see the
    module docstring). W: (K, p+1, L) f32 stacked weights. ``act``: one
    of :data:`ACTIVATIONS`. Returns (n, n_out) f32 (n_out = 2 for a
    sigmoid pair, else L). ``dtype`` and ``config`` as for
    :func:`fused_linear_scores`.

    On CPU tensors this is :func:`fused_prefix_scores_torch`; on CUDA
    tensors it launches the kernel or raises. Launches count on
    ``fused_linear_scores.launches``."""
    n, C, p, K, L = _check_prefix_args(V, mid, src, op, fill, W, act)
    dt = serve_dtype(V.device) if dtype is None else dtype
    if config is not None:
        launch_config(config)   # the plain version has none; check it
    if V.device.type == "cpu":
        return fused_prefix_scores_torch(V, mid, src, op, fill, W,
                                         act=act, dtype=dt)
    return _launch(V, mid, (src, op, fill), W, n, C, p, K, L, act, dt,
                   config)


def launch_config(config: Optional[Dict[str, int]] = None
                  ) -> Dict[str, int]:
    """``config`` over :data:`STATIC_LAUNCH_CONFIG` (None: the static
    rule); raises on an unknown key or a ``block_rows`` the kernel does
    not take (a positive multiple of :data:`WARPS_PER_BLOCK`)."""
    cfg = dict(STATIC_LAUNCH_CONFIG)
    if config:
        unknown = sorted(set(config) - set(cfg))
        if unknown:
            raise ValueError(
                f"fused serving kernel: unknown launch config key(s) "
                f"{unknown} (have {sorted(cfg)})")
        cfg.update({k: int(v) for k, v in config.items()})
    br = cfg["block_rows"]
    if br < WARPS_PER_BLOCK or br % WARPS_PER_BLOCK:
        raise ValueError(f"fused serving kernel: block_rows must be a "
                         f"positive multiple of {WARPS_PER_BLOCK}, got {br}")
    return cfg


def launch_blocks_on_card(device, n: int, p: int, K: int, L: int, *,
                          tables: bool, block_rows: int = 0) -> int:
    """The blocks the C entry's own launch rule gives one shape on the
    card (``tm_fused_launch_blocks``) under ``block_rows`` (0: the
    static rule)."""
    lib = _library()
    blocks = ctypes.c_longlong(0)
    with torch.cuda.device(torch.device(device)):
        err = lib.tm_fused_launch_blocks(int(n), int(p), int(K), int(L),
                                         int(bool(tables)), int(block_rows),
                                         ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"fused serving kernel: launch plan failed: "
                           f"{lib.tm_cuda_error_string(err).decode()}")
    return blocks.value


def fused_cost_floor(n: int, p: int, K: int, L: int) -> dict:
    """Analytic roofline floor for one fused launch: MXU flops and HBM
    bytes moved (f32 stream + resident weights + output), for the
    bench's scores_per_sec_per_chip block."""
    flops = 2.0 * n * (p + 1) * K * L + 2.0 * n * K * L * L
    gbytes = 4.0 * (n * (p + 1) + (p + 1) * K * L + n * L) / 1e9
    return {"analytic_gflops": flops / 1e9, "analytic_gbytes": gbytes}


def fused_prefix_cost(n: int, C: int, p: int, K: int, L: int,
                      n_out: int) -> dict:
    """Bytes and f32 operations of one prefix-form launch: each input
    read once (V, mid, the three (K, p) tables, W), the output written
    once; a multiply and an add per (row, feature, head column)."""
    return {"bytes": 4.0 * n * C + 4.0 * n + 9.0 * K * p
            + 4.0 * K * (p + 1) * L + 4.0 * n * n_out,
            "flops": 2.0 * n * (p + 1) * L}


def np_reference_scores(X, W, mid) -> np.ndarray:
    """Pure-NumPy f64 oracle (tests): per-row own-model affine score."""
    X = np.asarray(X, np.float64)
    W = np.asarray(W, np.float64)
    mid = np.asarray(mid, np.int64)
    out = np.empty((X.shape[0], W.shape[2]), np.float64)
    for i in range(X.shape[0]):
        w = W[mid[i]]
        out[i] = X[i] @ w[:-1] + w[-1]
    return out
