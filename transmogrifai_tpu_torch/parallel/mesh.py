"""The device mesh: ``TM_MESH_*``, the mesh type, grid sharding and
padding.

Counterpart of ``transmogrifai_tpu/parallel/mesh.py`` (its knob catalog,
device selection, labels, ``get_mesh`` / ``default_mesh`` /
``grid_map`` and the padding helpers). A :class:`Mesh` is an explicit
list of ``torch.device``s under one named axis, ``"grid"`` (the
selector's fold x hyper batch is sharded over it) or ``"data"`` (rows
are sharded over it, ``parallel.data_parallel``). Each entry is a rank
with its own non-blocking CUDA stream; an entry may repeat, so several
ranks can share one card, the counterpart of the JAX package's forced
host devices. One process drives every rank, as JAX's single controller
does.

Stream protocol. Work of rank r is issued on ``mesh.streams[r]``
(``with mesh.rank(r)``). An entry point first calls :meth:`Mesh.fork`
(each rank stream waits for its card's current stream, where the inputs
were copied) and last :meth:`Mesh.join` (each card's current stream
waits for the rank streams; tensors handed back are recorded on it).

The 2-D (grid x data) sweep (``get_mesh_2d``, ``pad_grid_by_data``) is
not ported: ``TM_MESH_AXIS=grid,data`` parses, routes the SanityChecker
through row-sharded statistics, and makes :func:`default_mesh` and the
selector raise "not ported".
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..resilience.config import parse_env_fields

#: mesh topologies resolve_mesh_config accepts for TM_MESH_AXIS: "grid"
#: = 1-D sweep sharding (the default); "grid,data" = the 2-D (grid x
#: data) sweep, not ported (the SanityChecker's statistics take the data
#: axis alone)
MESH_AXES = ("grid", "grid,data")

#: the two named axes a 1-D mesh may carry
MESH_AXIS_NAMES = ("grid", "data")

#: the work TM_MESH_AXIS=grid,data would need in the selector
GRID_DATA_NOT_PORTED = (
    "TM_MESH_AXIS=grid,data (the 2-D grid x data sweep: get_mesh_2d, "
    "pad_grid_by_data) is not ported to transmogrifai_tpu_torch; the "
    "axis row-shards the SanityChecker's statistics only")


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

    ``devices``: how many of the visible devices (:func:`visible_devices`)
    the default meshes span (None = all). ``axis``: mesh topology (MESH_AXES).
    ``rdma_ring``: force the hand-written ring reduction on (True) or
    off (False); None = ring exactly on CUDA tensors
    (models.kernels.ring_reduce_enabled)."""
    devices: Optional[int] = None
    axis: str = "grid"
    rdma_ring: Optional[bool] = None


def resolve_mesh_config(**overrides) -> MeshConfig:
    """Parse TM_MESH_* strictly; explicit ``overrides`` win over the
    environment. A device count that does not divide into the visible
    devices raises, as does an unknown axis."""
    fields = parse_env_fields("TM_MESH_", _MESH_ENV_FIELDS,
                              what="mesh env var",
                              overrides=overrides or None)
    cfg = MeshConfig(**fields)
    if cfg.devices is not None:
        n_avail = len(visible_devices())
        if not (1 <= cfg.devices <= n_avail) or n_avail % cfg.devices:
            raise ValueError(
                f"TM_MESH_DEVICES={cfg.devices} does not divide into the "
                f"{n_avail} available devices (need a divisor of "
                f"{n_avail})")
    if cfg.axis not in MESH_AXES:
        raise ValueError(f"unknown TM_MESH_AXIS {cfg.axis!r}; one of "
                         f"{MESH_AXES}")
    return cfg


def visible_devices() -> List[torch.device]:
    """The pool every default mesh draws from: each visible card, in
    index order. Raises when none is visible: the port never falls back
    to the CPU (the CPU tests replace this function with eight CPU
    ranks, as the JAX package's tests force eight host devices)."""
    n = torch.cuda.device_count()
    if n == 0:
        resolve_device()                  # raises "CUDA is not available"
        raise RuntimeError("transmogrifai_tpu_torch: no CUDA device is "
                           "visible")
    return [torch.device("cuda", i) for i in range(n)]


def configured_devices(count: Optional[int] = None) -> List[torch.device]:
    """The devices the default meshes span: the first ``TM_MESH_DEVICES``
    (or ``count``) of :func:`visible_devices`, validated by
    resolve_mesh_config."""
    cfg = resolve_mesh_config(**({} if count is None
                                 else {"devices": count}))
    devs = visible_devices()
    return devs[:cfg.devices] if cfg.devices else devs


def device_labels(devices: Sequence) -> List[str]:
    """Stable per-rank labels for attribution (``SWEEP_STATS``, /statusz
    ``sweepDevices``, /metricsz ``{device=}``, the chip_dispatch fault):
    a card that appears once is ``cuda:N``; ranks that share a card are
    ``cuda:N#r`` (r the rank's position in the mesh); a device without an
    index (the CPU) is ``cpu:r``."""
    devs = [torch.device(d) for d in devices]
    seen = {}
    for d in devs:
        seen[d] = seen.get(d, 0) + 1
    out = []
    for i, d in enumerate(devs):
        if d.index is None:
            out.append(f"{d.type}:{i}")
        elif seen[d] > 1:
            out.append(f"{d.type}:{d.index}#{i}")
        else:
            out.append(f"{d.type}:{d.index}")
    return out


class Mesh:
    """A 1-D mesh of ranks under one named axis (``"grid"`` or
    ``"data"``): ``devices[r]`` holds rank r's work and ``streams[r]``
    (None on the CPU) runs it. Devices must all be CUDA or all be the
    CPU; a device may repeat. ``axis_names`` and ``shape`` read as JAX's
    ``Mesh``. The ring communicator (``models.kernels``) keeps its
    buffers on the mesh, created at the first ring call."""

    def __init__(self, devices: Sequence, axis: str = "data"):
        if axis not in MESH_AXIS_NAMES:
            raise ValueError(f"unknown mesh axis {axis!r}; one of "
                             f"{MESH_AXIS_NAMES}")
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if kinds == {"cuda"}:
            devs = [torch.device("cuda", torch.cuda.current_device()
                                 if d.index is None else d.index)
                    for d in devs]
            self.streams = [torch.cuda.Stream(device=d) for d in devs]
            if len({s.cuda_stream for s in self.streams}) != len(devs):
                raise RuntimeError("mesh ranks must have distinct streams")
        elif kinds == {"cpu"}:
            self.streams = [None] * len(devs)
        else:
            raise ValueError(f"a mesh is all CUDA or all CPU devices, "
                             f"got {device_labels(devs)}")
        self.devices = devs
        self.axis_names = (axis,)
        self.ring = None            # models.kernels._RingComm, lazily

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self):
        return {self.axis_names[0]: self.size}

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    def labels(self) -> List[str]:
        return device_labels(self.devices)

    def rank(self, r: int):
        """Context in which rank r's work is issued (its stream)."""
        s = self.streams[r]
        return contextlib.nullcontext() if s is None else torch.cuda.stream(s)

    def fork(self) -> None:
        """Each rank stream waits for its card's current stream."""
        if self.is_cuda:
            for d, s in zip(self.devices, self.streams):
                s.wait_stream(torch.cuda.current_stream(d))

    def join(self, *tensors: torch.Tensor) -> None:
        """Each card's current stream waits for every rank stream on it;
        ``tensors`` (made on rank streams, handed to the caller) are
        recorded on the current stream of their card, so the caching
        allocator does not reuse them under a pending read."""
        if not self.is_cuda:
            return
        for d, s in zip(self.devices, self.streams):
            torch.cuda.current_stream(d).wait_stream(s)
        for t in tensors:
            if t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(t.device))

    def __repr__(self):
        return f"Mesh({self.labels()}, axis={self.axis_names[0]!r})"


def get_mesh(devices: Optional[Sequence] = None, axis: str = "grid") -> Mesh:
    """A 1-D mesh over ``devices`` (None: :func:`configured_devices`)."""
    return Mesh(configured_devices() if devices is None else devices, axis)


def default_mesh() -> Mesh:
    """The mesh a sweep dispatches on when the caller passes none: the
    configured devices (``TM_MESH_DEVICES``) under the ``"grid"`` axis.
    ``TM_MESH_AXIS=grid,data`` raises: the 2-D sweep is not ported."""
    if resolve_mesh_config().axis == "grid,data":
        raise NotImplementedError(GRID_DATA_NOT_PORTED)
    return get_mesh(configured_devices())


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


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn: Callable, *trees):
    """``fn`` over the matching leaves of trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _on(a, dev: torch.device):
    """A tensor moved to ``dev`` (no copy when it is there); anything
    else (numpy: host batches the callee uploads itself) as it is."""
    return a.to(dev, non_blocking=True) if isinstance(a, torch.Tensor) else a


def _concat(*parts):
    if isinstance(parts[0], torch.Tensor):
        dev = parts[0].device
        return torch.cat([p.to(dev) for p in parts])
    return np.concatenate([np.asarray(p) for p in parts])


def rank_items(b: int, ndev: int) -> List[int]:
    """Real items of each rank when :func:`grid_map` shards b items over
    ndev ranks: the edge-pad copies that fill the last shards are not
    work."""
    share = -(-b // ndev)
    return [max(0, min(b, (r + 1) * share) - r * share)
            for r in range(ndev)]


def grid_map(fn: Callable, batched: Any, replicated: Any = (),
             mesh: Optional[Mesh] = None) -> Any:
    """Run the batched ``fn(shard, *replicated)`` over the mesh's ranks.

    ``batched`` is a pytree (dicts, lists, tuples) of numpy arrays or
    tensors whose leaves share leading dim b; ``fn`` takes the batch
    axis as its leading axis (the port's fit kernels do), so nothing is
    vmapped. The leading axis is edge-padded to a multiple of the mesh
    size and rank r gets the contiguous shard ``[r*s, (r+1)*s)``; tensor
    leaves go to rank r's device, numpy leaves stay on the host. Rank
    r's ``fn`` runs on its stream with the ``replicated`` tensors on its
    device (no copy for ranks that share the card they are on). Returns
    the results' first b entries in order (tensors on rank 0's device,
    numpy as numpy)."""
    mesh = mesh or default_mesh()
    if any(x is None for x in _leaves(batched)):
        raise ValueError("grid_map: batched pytree contains None leaves; "
                         "remove them before dispatch")
    leaves = _leaves(batched)
    if not leaves:
        raise ValueError("grid_map needs at least one batched leaf")
    b = leaves[0].shape[0]
    k = mesh.size
    padded = _map(lambda a: pad_to_multiple(a, k), batched)
    share = -(-b // k)
    mesh.fork()
    outs = []
    for r, dev in enumerate(mesh.devices):
        with mesh.rank(r):
            shard = _map(lambda a: _on(a[r * share:(r + 1) * share], dev),
                         padded)
            repl = _map(lambda a: _on(a, dev), tuple(replicated))
            outs.append(fn(shard, *repl))
    mesh.join(*(t for o in outs for t in _leaves(o)
                if isinstance(t, torch.Tensor)))
    return _map(lambda *parts: _concat(*parts)[:b], *outs)
