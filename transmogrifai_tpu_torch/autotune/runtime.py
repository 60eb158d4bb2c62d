"""Runtime half of the learned autotuner: knobs, decision cache, hooks.

Counterpart of ``transmogrifai_tpu/autotune/runtime.py``. On CUDA,
``models.kernels.histogram_grid`` calls :func:`kernel_launch_config`
and the fused serving kernel's wrapper calls
:func:`serving_launch_config` at a launch whose caller gave no
``config=``. The hooks are OFF by default (``TM_AUTOTUNE`` unset or 0
-> None -> the kernel's static launch, bit for bit today's); with
``TM_AUTOTUNE=1`` and a trained cost model (``TM_AUTOTUNE_MODEL`` /
``TM_AUTOTUNE_SERVING_MODEL``) a hook ranks the candidate configs for
the shape and returns the predicted-fastest one. Every candidate gives
the same bits as the static launch (see :mod:`.costmodel`), so the
autotuner moves time, never results.

Decisions are CACHE-KEYED per shape — one prediction per distinct
shape, however many launches follow — and every decision is recorded
to the flight recorder, so a capture shows exactly which learned
configs a process ran with. A model is reloaded when its file's mtime
changes; already-decided shapes keep their decision.

Knobs follow the strict ``resilience/config.parse_env_fields``
convention: an unknown ``TM_AUTOTUNE_``-prefixed variable or an
unparsable value raises at resolution, never a silent default. The
hooks run at every launch, not once per trace as in the JAX package,
so the knobs are resolved once, at the first launch that consults a
hook, and again only after :func:`reset_autotuner`: with the
autotuner off a launch pays one attribute read. A process that
changes a ``TM_AUTOTUNE*`` variable calls :func:`reset_autotuner`.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from ..resilience.config import parse_env_fields
from .costmodel import (KernelCostModel, ServingCostModel,
                        candidate_configs, serve_candidate_configs,
                        serve_grid, serve_shape_key, shape_key)

__all__ = ["AutotuneConfig", "resolve_autotune_config",
           "kernel_launch_config", "serving_launch_config",
           "reset_autotuner", "kernel_dispatch_log",
           "serving_dispatch_log"]


def _bool01(raw: str) -> bool:
    if raw not in ("0", "1"):
        raise ValueError(f"expected 0 or 1, got {raw!r}")
    return raw == "1"


_ENV_CATALOG = {
    "TM_AUTOTUNE": ("enabled", _bool01),
    "TM_AUTOTUNE_MODEL": ("model_path", str),
    "TM_AUTOTUNE_SERVING_MODEL": ("serving_model_path", str),
    "TM_AUTOTUNE_MAX_BLOCK": ("max_block", int),
    "TM_AUTOTUNE_BUCKET_MAX": ("bucket_max", int),
    "TM_AUTOTUNE_BUCKET_MIN_BATCHES": ("bucket_min_batches", int),
}


class AutotuneConfig:
    """Validated autotuner knobs (strict parse; see module docstring).

    * ``enabled`` — TM_AUTOTUNE: the master switch for both hooks. Off
      means they return None and the kernels keep their static launch.
    * ``model_path`` — TM_AUTOTUNE_MODEL: a trained histogram cost
      model (``KernelCostModel.save``, format ``"cuda-1"``). Enabled
      WITHOUT a model is a no-op hook (None), not an error.
    * ``serving_model_path`` — TM_AUTOTUNE_SERVING_MODEL: a trained
      fused-serving cost model (``ServingCostModel.save``), the same
      no-op-without-artifact contract.
    * ``max_block`` — TM_AUTOTUNE_MAX_BLOCK: caps the candidates' row
      counts, the sort's chunk rows and the scorer's ``block_rows``.
    * ``bucket_max`` / ``bucket_min_batches`` — TM_AUTOTUNE_BUCKET_*:
      ladder-proposal width cap and the minimum observed batches
      before a retune is meaningful (callers of autotune.buckets
      consult these).
    """

    def __init__(self, **overrides):
        fields = parse_env_fields("TM_AUTOTUNE", _ENV_CATALOG,
                                  what="autotune env var",
                                  overrides=overrides)
        self.enabled: bool = bool(fields.get("enabled", False))
        self.model_path: Optional[str] = fields.get("model_path") or None
        self.serving_model_path: Optional[str] = (
            fields.get("serving_model_path") or None)
        self.max_block: int = int(fields.get("max_block", 4096))
        self.bucket_max: int = int(fields.get("bucket_max", 8))
        self.bucket_min_batches: int = int(
            fields.get("bucket_min_batches", 32))
        if self.max_block < 8:
            raise ValueError(
                f"TM_AUTOTUNE_MAX_BLOCK must be >= 8, got {self.max_block}")
        if self.bucket_max < 1:
            raise ValueError(
                f"TM_AUTOTUNE_BUCKET_MAX must be >= 1, got "
                f"{self.bucket_max}")
        if self.bucket_min_batches < 1:
            raise ValueError(
                f"TM_AUTOTUNE_BUCKET_MIN_BATCHES must be >= 1, got "
                f"{self.bucket_min_batches}")


def resolve_autotune_config(**overrides) -> AutotuneConfig:
    return AutotuneConfig(**overrides)


class _Side:
    """One hook's state: the decision cache (shape key -> config or
    None), the loaded model (reloaded on an mtime change) and the
    dispatch log."""

    def __init__(self, model_cls):
        self.model_cls = model_cls
        self.decisions: Dict[tuple, Optional[Dict[str, Any]]] = {}
        self.model: Dict[str, Any] = {"path": None, "mtime": None,
                                      "model": None}
        self.log: list = []

    def clear(self) -> None:
        self.decisions.clear()
        self.log.clear()
        self.model.update(path=None, mtime=None, model=None)

    def load(self, path: Optional[str]):
        """The model at ``path`` (None when unset or missing); a bad
        artifact raises loudly."""
        if path is None:
            return None
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return None
        if self.model["path"] == path and self.model["mtime"] == mtime:
            return self.model["model"]
        model = self.model_cls.load(path)
        self.model.update(path=path, mtime=mtime, model=model)
        return model


# process-global state: both hooks share one lock; their shape
# universes are disjoint and their artifacts load from different paths
# with different formats, so each keeps its own caches
_LOCK = threading.Lock()
_KERNEL = _Side(KernelCostModel)
_SERVE = _Side(ServingCostModel)
_RESOLVED: Optional[AutotuneConfig] = None


def _config() -> AutotuneConfig:
    """The resolved knobs: parsed (strictly) at the first call after
    import or :func:`reset_autotuner`, then the same object."""
    global _RESOLVED
    cfg = _RESOLVED
    if cfg is None:
        cfg = resolve_autotune_config()
        with _LOCK:
            _RESOLVED = cfg
    return cfg


def reset_autotuner() -> None:
    """Drop the decision caches, the loaded models and the resolved
    knobs — kernel AND serving sides (tests, or a process that changed
    a ``TM_AUTOTUNE*`` variable; the knobs re-resolve at the next
    launch)."""
    global _RESOLVED
    with _LOCK:
        _KERNEL.clear()
        _SERVE.clear()
        _RESOLVED = None


def kernel_dispatch_log() -> list:
    """The process's histogram autotune decisions so far (copy):
    [{"shape": {...}, "config": {...}, "predicted_ms": ...}] — the
    in-process mirror of the flight-recorder records."""
    with _LOCK:
        return [dict(e) for e in _KERNEL.log]


def serving_dispatch_log() -> list:
    """The process's fused-serving autotune decisions so far (copy),
    each also carrying the grid the chosen config launches."""
    with _LOCK:
        return [dict(e) for e in _SERVE.log]


def _decide(side: _Side, key: tuple, path: Optional[str],
            choose: Callable) -> Tuple[Optional[Dict[str, Any]], bool,
                                       Optional[float]]:
    """(choice, fresh, predicted ms): the cached decision for ``key``,
    else a new one from the model at ``path`` (None without one)."""
    with _LOCK:
        if key in side.decisions:
            choice = side.decisions[key]
            return (None if choice is None else dict(choice)), False, None
        model = side.load(path)
        if model is None or model.coef is None:
            side.decisions[key] = None
            return None, False, None
        choice, predicted = choose(model)
        side.decisions[key] = choice
        return dict(choice), True, predicted


def kernel_launch_config(**shape: int) -> Optional[Dict[str, Any]]:
    """The histogram kernel's launch hook: the predicted-fastest launch
    config for one shape (keywords G, n, d, B, S, m), or None when the
    autotuner is off or has no trained model — the caller then runs the
    static launch. One prediction per shape (cached); each decision
    lands in the flight recorder as an autotune record."""
    cfg = _RESOLVED or _config()
    if not cfg.enabled:
        return None
    choice, fresh, predicted = _decide(
        _KERNEL, shape_key(shape), cfg.model_path,
        lambda model: model.choose_config(
            shape, candidate_configs(shape, max_block=cfg.max_block)))
    if fresh:
        with _LOCK:
            _KERNEL.log.append({"shape": dict(shape), "config": dict(choice),
                                "predicted_ms": predicted})
        from ..telemetry import recorder as _flight
        _flight.record("autotune", "kernel_config",
                       shape="G={G} n={n} d={d} B={B} S={S} m={m}".format(
                           **shape),
                       predicted_ms=predicted, **choice)
    return choice


def serving_launch_config(grid: Optional[Callable[[int], int]] = None,
                          **shape: int) -> Optional[Dict[str, Any]]:
    """The fused serving kernel's launch hook: the predicted-fastest
    launch config for one fused shape (keywords K, n, p, L), or None
    when the autotuner is off or has no trained serving model — the
    kernel then runs its static launch. ``grid``, a callable from a
    ``block_rows`` to the blocks the C entry launches for it on the
    card, lets the candidate screen dedupe by the grid each candidate
    executes; it is called only for a new decision. Same contract as
    :func:`kernel_launch_config`."""
    cfg = _RESOLVED or _config()
    if not cfg.enabled:
        return None

    def choose(model):
        return model.choose_config(shape, serve_candidate_configs(
            shape, max_block=cfg.max_block, grid=grid))

    choice, fresh, predicted = _decide(
        _SERVE, serve_shape_key(shape), cfg.serving_model_path, choose)
    if fresh:
        blocks = (serve_grid(shape, choice) if grid is None
                  else int(grid(choice["block_rows"])))
        with _LOCK:
            _SERVE.log.append({"shape": dict(shape), "config": dict(choice),
                               "predicted_ms": predicted, "blocks": blocks})
        from ..telemetry import recorder as _flight
        _flight.record("autotune", "serving_config",
                       shape="K={K} n={n} p={p} L={L}".format(**shape),
                       block_rows=choice["block_rows"], blocks=blocks,
                       predicted_ms=predicted)
    return choice
