"""Fused cross-model serving kernel: one launch per (backend-family,
bucket), scoring each request row under its own model out of K stacked
linear heads.

Counterpart of ``transmogrifai_tpu/models/serving_kernels.py``. There
the Pallas kernel ``_fused_db_kernel`` streams rows through VMEM and
runs one masked ``(n, K*L)`` MXU contraction; here
:func:`fused_linear_scores` launches the hand-written CUDA kernel
``csrc/fused_linear_scores.cu``, which gathers each row's own
``(p+1, L)`` weight block instead (see the note in the source for why
that is the same function, and what bounds it on an H100).

:func:`fused_linear_scores_torch` is the plain PyTorch version: the XLA
twin's formulation (flattened weight block, intercept-row add, iota
mask, ``where`` before the reduction, 0/1 group-sum dot) in torch. The
wrapper takes it only for a tensor on the CPU; on a CUDA tensor it
launches the kernel or raises — no fallback.

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
from typing import Optional

import numpy as np
import torch

from .. import _cuda_build
# TM_KERNEL_EXACT=1: the engine's fused path on the CPU runs each
# model's own tail (serving/fusion.py); the card's kernel takes f32
# operands
from .kernels import kernel_exact

#: the CUDA source this module's kernel builds from (under the package)
KERNEL_NAME = "fused_linear_scores"


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
    """Device, dtype, shape and contiguity checks shared by the kernel
    wrapper and the plain version; returns (n, p, K, L)."""
    if X.dim() != 2 or W.dim() != 3 or mid.dim() != 1:
        raise ValueError(
            f"want X (n, p), W (K, p+1, L), mid (n,); got "
            f"{tuple(X.shape)}, {tuple(W.shape)}, {tuple(mid.shape)}")
    n, p = (int(s) for s in X.shape)
    K, p1, L = (int(s) for s in W.shape)
    if p1 != p + 1:
        raise ValueError(
            f"weight stack rows {p1} != features+intercept {p + 1}")
    if int(mid.shape[0]) != n:
        raise ValueError(f"mid has {int(mid.shape[0])} rows, X has {n}")
    if X.dtype != torch.float32 or W.dtype != torch.float32:
        raise TypeError(f"X and W must be float32, got {X.dtype}, "
                        f"{W.dtype}")
    if mid.dtype != torch.int32:
        raise TypeError(f"mid must be int32, got {mid.dtype}")
    if not (X.device == W.device == mid.device):
        raise ValueError(f"X, W, mid on different devices: {X.device}, "
                         f"{W.device}, {mid.device}")
    return n, p, K, L


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


_LAUNCH_LOCK = threading.Lock()
_LIB = None


def _library():
    """Build (first use) and bind the kernel's C entry points."""
    global _LIB
    if _LIB is None:
        lib = _cuda_build.load_library(KERNEL_NAME)
        fn = lib.tm_fused_linear_scores
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        # an empty launch through the same path (timing floor only)
        lib.tm_empty_launch.argtypes = [ctypes.c_void_p]
        lib.tm_empty_launch.restype = ctypes.c_int
        lib.tm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tm_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def fused_linear_scores(X: torch.Tensor, W: torch.Tensor,
                        mid: torch.Tensor, *,
                        dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Score ``X[i]`` under model ``mid[i]`` for K stacked linear models
    in ONE kernel launch.

    X: (n, p) f32 request rows. W: (K, p+1, L) f32 stacked weights,
    last row the intercept. mid: (n,) int32 model index per row (a row
    outside [0, K) scores 0). Returns (n, L) f32 raw scores
    (pre-activation). ``dtype`` is the operand dtype (None:
    :func:`serve_dtype` of X's device; bf16 and f32 are supported).

    On a CPU tensor this is :func:`fused_linear_scores_torch`. On a
    CUDA tensor it launches ``csrc/fused_linear_scores.cu`` on the
    current stream (built at first use) and raises if the build or
    the launch fails. ``fused_linear_scores.launches`` counts launches."""
    n, p, K, L = _check_args(X, W, mid)
    dt = serve_dtype(X.device) if dtype is None else dtype
    if X.device.type == "cpu":
        return fused_linear_scores_torch(X, W, mid, dtype=dt)
    if X.device.type != "cuda":
        raise ValueError(f"fused_linear_scores: unsupported device "
                         f"{X.device}")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"operand dtype {dt} not supported by the kernel")
    if not (X.is_contiguous() and W.is_contiguous()
            and mid.is_contiguous()):
        raise ValueError("fused_linear_scores: X, W and mid must be "
                         "contiguous")
    out = torch.empty((n, L), dtype=torch.float32, device=X.device)
    if n == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        err = lib.tm_fused_linear_scores(
            X.data_ptr(), W.data_ptr(), mid.data_ptr(), out.data_ptr(),
            n, p, K, L, int(dt == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_linear_scores launch failed (n={n}, p={p}, K={K}, "
            f"L={L}): {lib.tm_cuda_error_string(err).decode()}")
    with _LAUNCH_LOCK:
        fused_linear_scores.launches += 1
    return out


#: launches of the CUDA kernel (the CPU path counts nothing)
fused_linear_scores.launches = 0


def fused_cost_floor(n: int, p: int, K: int, L: int) -> dict:
    """Analytic roofline floor for one fused launch: MXU flops and HBM
    bytes moved (f32 stream + resident weights + output), for the
    bench's scores_per_sec_per_chip block."""
    flops = 2.0 * n * (p + 1) * K * L + 2.0 * n * K * L * L
    gbytes = 4.0 * (n * (p + 1) + (p + 1) * K * L + n * L) / 1e9
    return {"analytic_gflops": flops / 1e9, "analytic_gbytes": gbytes}


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
