"""The device mesh as a configuration surface: ``TM_MESH_*`` and padding.

Counterpart of ``transmogrifai_tpu/parallel/mesh.py`` (its knob catalog,
device selection, labels and padding helpers). A mesh here is a list of
``torch.device``s; the data-parallel entry points build theirs with
``parallel.data_parallel.data_mesh``. The JAX package's 1-D grid
sharding of the selector (``grid_map``, ``get_mesh``, ``default_mesh``)
and the 2-D (grid x data) GSPMD sweep (``get_mesh_2d``) are not ported:
``TM_MESH_AXIS=grid,data`` parses, and the selector raises "not ported"
when it would need it (``models.tuning.require_ported``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..resilience.config import parse_env_fields

#: mesh topologies resolve_mesh_config accepts for TM_MESH_AXIS: "grid"
#: = 1-D sweep sharding (the default); "grid,data" = the 2-D (grid x
#: data) sweep, parsed but not ported
MESH_AXES = ("grid", "grid,data")


def _parse_bool01(raw: str) -> bool:
    if raw in ("1", "on", "true"):
        return True
    if raw in ("0", "off", "false"):
        return False
    raise ValueError(f"expected 0/1, got {raw!r}")


#: strict TM_MESH_* catalog: an unknown TM_MESH_ name or an unparsable
#: value raises (a typo'd device count must fail the run, not train on
#: another mesh)
_MESH_ENV_FIELDS = {
    "TM_MESH_DEVICES": ("devices", int),
    "TM_MESH_AXIS": ("axis", str),
    "TM_MESH_RDMA_RING": ("rdma_ring", _parse_bool01),
}


@dataclass(frozen=True)
class MeshConfig:
    """Resolved multi-device configuration.

    ``devices``: how many of the visible CUDA devices the default data
    mesh spans (None = all). ``axis``: mesh topology (MESH_AXES).
    ``rdma_ring``: force the hand-written ring reduction on (True) or
    off (False); None = ring exactly on CUDA tensors
    (models.kernels.ring_reduce_enabled)."""
    devices: Optional[int] = None
    axis: str = "grid"
    rdma_ring: Optional[bool] = None


def resolve_mesh_config(**overrides) -> MeshConfig:
    """Parse TM_MESH_* strictly; explicit ``overrides`` win over the
    environment. A device count that does not divide into
    ``torch.cuda.device_count()`` raises, as does an unknown axis."""
    fields = parse_env_fields("TM_MESH_", _MESH_ENV_FIELDS,
                              what="mesh env var",
                              overrides=overrides or None)
    cfg = MeshConfig(**fields)
    if cfg.devices is not None:
        n_avail = torch.cuda.device_count()
        if not (1 <= cfg.devices <= n_avail) or n_avail % cfg.devices:
            raise ValueError(
                f"TM_MESH_DEVICES={cfg.devices} does not divide into the "
                f"{n_avail} available devices (need a divisor of "
                f"{n_avail})")
    if cfg.axis not in MESH_AXES:
        raise ValueError(f"unknown TM_MESH_AXIS {cfg.axis!r}; one of "
                         f"{MESH_AXES}")
    return cfg


def configured_devices(count: Optional[int] = None) -> List[torch.device]:
    """The CUDA devices the default data mesh spans: the first
    ``TM_MESH_DEVICES`` (or ``count``) of the visible cards, validated
    by resolve_mesh_config. Raises when no card is visible: the port
    never falls back to the CPU."""
    resolve_device()
    cfg = resolve_mesh_config(**({} if count is None
                                 else {"devices": count}))
    n = cfg.devices or torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)]


def device_labels(devices: Sequence) -> List[str]:
    """Stable per-rank labels ("cuda:0", "cpu:1"): a device with an
    index keeps it; one without (the CPU) takes its position."""
    out = []
    for i, d in enumerate(devices):
        d = torch.device(d)
        out.append(f"{d.type}:{i if d.index is None else d.index}")
    return out


def _pad_axis(arr, m: int, axis: int, mode: str):
    n = arr.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return arr
    if isinstance(arr, np.ndarray):
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        return np.pad(arr, widths, mode=mode)
    if mode == "edge":
        idx = torch.arange(n + pad, device=arr.device).clamp_(max=n - 1)
        return arr.index_select(axis, idx)
    shape = list(arr.shape)
    shape[axis] = pad
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def _as_array(a):
    """numpy and torch tensors pass through; anything else -> numpy."""
    return a if isinstance(a, (np.ndarray, torch.Tensor)) else np.asarray(a)


def pad_to_multiple(arr, m: int, axis: int = 0):
    """Edge-pad ``axis`` to a multiple of m: padded entries repeat the
    last real one; callers slice [:n] so the duplicates are dropped."""
    return _pad_axis(_as_array(arr), m, axis, "edge")


def zero_pad_rows(a, m: int, axis: int = 0):
    """Zero-pad ``axis`` to a multiple of m. Zero rows carry zero stats
    and zero weights, so they add exact zeros to every row sum."""
    return _pad_axis(_as_array(a), m, axis, "constant")
