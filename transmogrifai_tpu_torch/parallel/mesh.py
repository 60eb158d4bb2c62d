"""The device mesh: ``TM_MESH_*``, the mesh types, grid sharding and
padding.

Counterpart of ``transmogrifai_tpu/parallel/mesh.py`` (its knob catalog,
device selection, labels, ``get_mesh`` / ``get_mesh_2d`` /
``default_mesh`` / ``grid_map`` and the padding helpers). A :class:`Mesh`
is an explicit list of ``torch.device``s under one named axis,
``"grid"`` (the selector's fold x hyper batch is sharded over it) or
``"data"`` (rows are sharded over it, ``parallel.data_parallel``). Each
entry is a rank with its own non-blocking CUDA stream; an entry may
repeat, so several ranks can share one card, the counterpart of the JAX
package's forced host devices. One process drives every rank, as JAX's
single controller does.

A :class:`Mesh2D` (``get_mesh_2d``; ``multihost.hybrid_mesh``) is a
stack of 1-D sub-meshes, one per row of its first axis: on a
``("grid", "data")`` mesh each grid row is a data mesh with its own rank
streams and ring communicator, and ``grid_map`` runs the row's shard of
the items with the rows sharded over its ranks, each rank on a host
thread of its own in lockstep at the fit code's row contractions
(``parallel.spmd``), as GSPMD partitions one program in the JAX package.

Stream protocol. Work of rank r is issued on ``mesh.streams[r]``
(``with mesh.rank(r)``). An entry point first calls :meth:`Mesh.fork`
(each rank stream waits for its card's current stream, where the inputs
were copied) and last :meth:`Mesh.join` (each card's current stream
waits for the rank streams; tensors handed back are recorded on it).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..resilience.config import parse_env_fields

#: mesh topologies resolve_mesh_config accepts for TM_MESH_AXIS: "grid"
#: = 1-D sweep sharding (the default); "grid,data" = the 2-D (grid x
#: data) mesh: sweep items over the first axis, dataset rows over the
#: second, with a cross-rank reduction at every row contraction
MESH_AXES = ("grid", "grid,data")

#: the two named axes a 1-D mesh may carry
MESH_AXIS_NAMES = ("grid", "data")

#: the axis pairs a 2-D mesh may carry: get_mesh_2d's, and hybrid_mesh's
#: (its first axis spans processes)
MESH_2D_AXES = (("grid", "data"), ("dcn_grid", "data"),
                ("dcn_grid", "grid"))


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
    """The ranks the default meshes span: the first ``TM_MESH_DEVICES``
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
    buffers on the mesh, created at the first ring call. ``labels``
    names the ranks for attribution (None: :func:`device_labels`; a
    :class:`Mesh2D` passes each row its place in the whole mesh)."""

    def __init__(self, devices: Sequence, axis: str = "data",
                 labels: Optional[Sequence[str]] = None):
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
        self._labels = (device_labels(devs) if labels is None
                        else list(labels))
        if len(self._labels) != len(devs):
            raise ValueError(f"{len(self._labels)} labels for "
                             f"{len(devs)} ranks")

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
        return list(self._labels)

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


def _owner(d) -> int:
    """The process a mesh entry belongs to: a ``multihost`` device
    handle carries it; a ``torch.device`` is this process's."""
    from .multihost import process_index
    return getattr(d, "process_index", process_index())


def _local(d) -> torch.device:
    return getattr(d, "device", None) or torch.device(d)


def _entry_labels(devs) -> List[str]:
    if all(hasattr(d, "label") for d in devs):
        return [d.label for d in devs]
    return device_labels([_local(d) for d in devs])


class Mesh2D:
    """A 2-D mesh: ``device_rows[i]`` is row i of its first axis, a 1-D
    sub-mesh (``rows[i]``, a :class:`Mesh` under the second axis) with
    its own rank streams and ring communicator. ``axis_names`` is one of
    ``MESH_2D_AXES``: ``("grid", "data")`` from :func:`get_mesh_2d`;
    ``("dcn_grid", "data")`` or ``("dcn_grid", "grid")`` from
    ``multihost.hybrid_mesh``, whose rows are processes. A process builds
    the sub-meshes of its own rows only (``rows[i]`` is None for another
    process's row, ``local_rows`` lists its own). A row whose entries
    belong to several processes raises: a data axis never crosses
    processes (build the mesh with ``hybrid_mesh``, whose first axis
    spans them). ``devices`` is the flat row-major list of entries,
    ``labels()`` their attribution labels (``cuda:0#r`` for ranks that
    share a card, r the flat position; a remote entry's label names its
    process)."""

    def __init__(self, device_rows: Sequence[Sequence],
                 axes: Tuple[str, str] = ("grid", "data")):
        axes = tuple(axes)
        if axes not in MESH_2D_AXES:
            raise ValueError(f"unknown 2-D mesh axes {axes!r}; one of "
                             f"{MESH_2D_AXES}")
        rows = [list(r) for r in device_rows]
        if not rows or not rows[0]:
            raise ValueError("a mesh needs at least one device")
        if len({len(r) for r in rows}) != 1:
            raise ValueError(f"uneven mesh rows: {[len(r) for r in rows]}")
        self.axis_names = axes
        self.device_rows = rows
        self.devices = [d for r in rows for d in r]
        self._labels = _entry_labels(self.devices)
        k = len(rows[0])
        from .multihost import process_index
        me = process_index()
        self.rows: List[Optional[Mesh]] = []
        self.local_rows: List[int] = []
        for i, row in enumerate(rows):
            owners = {_owner(d) for d in row}
            if len(owners) > 1:
                raise ValueError(
                    f"mesh row {i} spans processes {sorted(owners)}: a "
                    f"{axes[1]!r} axis never crosses processes; build the "
                    f"mesh with parallel.multihost.hybrid_mesh, whose "
                    f"first axis spans them")
            if owners == {me}:
                self.rows.append(Mesh([_local(d) for d in row], axes[1],
                                      self._labels[i * k:(i + 1) * k]))
                self.local_rows.append(i)
            else:
                self.rows.append(None)
        if not self.local_rows:
            raise ValueError(f"no row of the mesh belongs to process {me}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self):
        return {self.axis_names[0]: len(self.device_rows),
                self.axis_names[1]: len(self.device_rows[0])}

    @property
    def is_cuda(self) -> bool:
        return self.rows[self.local_rows[0]].is_cuda

    @property
    def is_2d_data(self) -> bool:
        """Rows sharded over the second axis (it is ``"data"`` and holds
        more than one rank)."""
        return self.axis_names[1] == "data" and self.shape["data"] > 1

    @property
    def spans_processes(self) -> bool:
        return len(self.local_rows) < len(self.device_rows)

    def first_device(self) -> torch.device:
        """This process's first rank: where a dispatch's inputs land."""
        return self.rows[self.local_rows[0]].devices[0]

    def data_mesh(self) -> Mesh:
        """The ``"data"`` axis as a 1-D mesh (the sharded sparse fits
        ride it): this process's first row; the rows of a ``"data"``
        mesh replicate each other, as in the JAX package."""
        if self.axis_names[1] != "data":
            raise ValueError(f"mesh axes {self.axis_names} have no "
                             f"'data' axis")
        return self.rows[self.local_rows[0]]

    def labels(self) -> List[str]:
        return list(self._labels)

    def __repr__(self):
        return (f"Mesh2D({self.shape}, labels={self._labels}, "
                f"local_rows={self.local_rows})")


def get_mesh(devices: Optional[Sequence] = None, axis: str = "grid") -> Mesh:
    """A 1-D mesh over ``devices`` (None: :func:`configured_devices`)."""
    return Mesh(configured_devices() if devices is None else devices, axis)


def get_mesh_2d(devices: Optional[Sequence] = None,
                grid_size: Optional[int] = None) -> Mesh2D:
    """The 2-D ``("grid", "data")`` mesh: grid items shard over the
    first axis, dataset rows over the second. ``grid_size`` defaults to
    the largest divisor of the device count not above its square root
    (the JAX package's rule)."""
    devs = list(configured_devices() if devices is None else devices)
    n = len(devs)
    if grid_size is None:
        grid_size = 1
        for cand in range(int(n ** 0.5), 0, -1):
            if n % cand == 0:
                grid_size = cand
                break
    if grid_size < 1 or n % grid_size:
        raise ValueError(f"{n} devices not divisible by "
                         f"grid_size={grid_size}")
    k = n // grid_size
    return Mesh2D([devs[i * k:(i + 1) * k] for i in range(grid_size)],
                  ("grid", "data"))


def default_mesh():
    """The mesh a sweep dispatches on when the caller passes none: the
    configured devices (``TM_MESH_DEVICES``) under the ``"grid"`` axis,
    or ``get_mesh_2d`` of them under ``TM_MESH_AXIS=grid,data``. In a
    multi-process world (``multihost.initialize_distributed``) it spans
    every process's configured devices, as the JAX package's spans
    ``jax.devices()``: a
    ``hybrid_mesh`` with the processes on its first axis and, within a
    process, the ``"data"`` axis under ``grid,data`` or the ``"grid"``
    axis otherwise (a data axis never crosses processes). Every process
    must call it together (it gathers the device lists)."""
    from .multihost import hybrid_mesh, process_count
    axis = resolve_mesh_config().axis
    if process_count() > 1:
        return hybrid_mesh(axes=("dcn_grid", "data" if axis == "grid,data"
                                 else "grid"))
    devs = configured_devices()
    if axis == "grid,data":
        return get_mesh_2d(devs)
    return get_mesh(devs)


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


def pad_grid_by_data(a, n_grid: int, n_data: int):
    """Pad a (b, n) per-row batch leaf (fold masks) for a grid x data
    dispatch: the item axis edge-padded to a multiple of n_grid (copies
    of the last item, sliced off by the caller), the row axis
    zero-padded to a multiple of n_data in lockstep with the replicated
    arrays (``zero_pad_rows``)."""
    return zero_pad_rows(pad_to_multiple(a, n_grid), n_data, axis=1)


def _shard_items(b: int, share: int, k: int) -> List[int]:
    """Real items of each of k shards of ``share`` items when the first
    b of the padded batch are real."""
    return [max(0, min(b, (r + 1) * share) - r * share) for r in range(k)]


def rank_items(b: int, ndev: int) -> List[int]:
    """Real items of each rank when :func:`grid_map` shards b items over
    ndev ranks: the edge-pad copies that fill the last shards are not
    work."""
    return _shard_items(b, -(-b // ndev), ndev)


def mesh_rank_items(mesh, b: int) -> List[int]:
    """Real items of every rank of ``mesh`` (flat, in ``mesh.labels()``
    order) when :func:`grid_map` shards b items over it: on a 2-D mesh
    every rank of a row is credited with the row's items when the
    second axis is ``"data"``; under ``("dcn_grid", "grid")`` the row's
    items split again over its ranks."""
    if not isinstance(mesh, Mesh2D):
        return rank_items(b, mesh.size)
    n_grid = mesh.shape[mesh.axis_names[0]]
    k = mesh.shape[mesh.axis_names[1]]
    per_row = rank_items(b, n_grid)
    if mesh.axis_names[1] == "data":
        return [n for n in per_row for _ in range(k)]
    share = -(-b // n_grid)
    return [n for ri in per_row
            for n in _shard_items(ri, -(-share // k), k)]


def grid_map(fn: Callable, batched: Any, replicated: Any = (),
             mesh=None, key: Optional[str] = None) -> Any:
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
    numpy as numpy).

    On a :class:`Mesh2D` the items shard over its first axis. With a
    ``"data"`` second axis, each row's ranks run the row's shard in
    lockstep (``parallel.spmd.run_ranks``): the replicated arrays, and
    the batch leaves whose second dim is their row count (fold masks),
    are zero-padded to a multiple of the row's rank count in lockstep
    and rank r gets rows ``[r*s, (r+1)*s)``; ``fn`` must weight rows by
    a replicated vector (the zero padding then counts for nothing) and
    make its row contractions through ``parallel.spmd``. Rank 0's result
    is the row's. A ``("dcn_grid", "grid")`` row is a 1-D grid mesh. A
    mesh whose rows span processes runs this process's rows and gathers
    every row's results over the process group in grid order
    (``multihost.gather_rows_results``, which holds every process to the
    same dispatch: ``key`` names the batch, beside its item and row
    counts; a process whose rows raised makes every process raise)."""
    mesh = mesh or default_mesh()
    if any(x is None for x in _leaves(batched)):
        raise ValueError("grid_map: batched pytree contains None leaves; "
                         "remove them before dispatch")
    leaves = _leaves(batched)
    if not leaves:
        raise ValueError("grid_map needs at least one batched leaf")
    if isinstance(mesh, Mesh2D):
        return _grid_map_2d(fn, batched, replicated, mesh, key)
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


def _row_shard(a, k: int, r: int, axis: int):
    """Rank r's contiguous shard of ``a`` along ``axis`` when its rows
    are zero-padded to a multiple of k and split into k shards."""
    a = zero_pad_rows(a, k, axis)
    s = a.shape[axis] // k
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(r * s, (r + 1) * s)
    part = a[tuple(idx)]
    return (part.contiguous() if isinstance(part, torch.Tensor)
            else np.ascontiguousarray(part))


def _grid_map_2d(fn: Callable, batched: Any, replicated: Any,
                 mesh: Mesh2D, key: Optional[str]) -> Any:
    leaves = _leaves(batched)
    b = leaves[0].shape[0]
    n_grid = mesh.shape[mesh.axis_names[0]]
    repl_leaves = _leaves(tuple(replicated))
    n_rows = repl_leaves[0].shape[0] if repl_leaves else -1
    data = mesh.is_2d_data

    def pad_batched(a):
        a = _as_array(a)
        if data and a.ndim >= 2 and a.shape[1] == n_rows:
            return pad_grid_by_data(a, n_grid, mesh.shape["data"])
        return pad_to_multiple(a, n_grid)

    padded = _map(pad_batched, batched)
    share = _leaves(padded)[0].shape[0] // n_grid
    outs = {}
    try:
        _run_rows(fn, padded, replicated, mesh, share, n_rows, outs)
    except Exception as e:
        if not mesh.spans_processes:
            raise
        error = e
    else:
        error = None
    if mesh.spans_processes:
        from .multihost import gather_rows_results
        rows_out = gather_rows_results(
            outs, mesh, (key, b, n_rows), error)
    else:
        rows_out = [outs[i] for i in range(n_grid)]
    dev = mesh.first_device()
    return _map(lambda *parts: _concat(*(_on(p, dev) for p in parts))[:b],
                *rows_out)


def _run_rows(fn: Callable, padded: Any, replicated: Any, mesh: Mesh2D,
              share: int, n_rows: int, outs: dict) -> None:
    """This process's grid rows of :func:`_grid_map_2d` into ``outs``
    ({row index: the row's result})."""
    data = mesh.is_2d_data
    for i in mesh.local_rows:
        sub = mesh.rows[i]
        items = _map(lambda a: a[i * share:(i + 1) * share], padded)
        if not data:
            outs[i] = grid_map(fn, items, replicated, sub)
            continue
        from .spmd import run_ranks
        k = sub.size
        rows_pad = n_rows + (-n_rows) % k

        def on_rank(a, r, sub=sub, k=k, rows_pad=rows_pad):
            # fold masks ride the rows; every other leaf goes whole
            if a.ndim >= 2 and a.shape[1] == rows_pad:
                a = _row_shard(a, k, r, 1)
            return _on(a, sub.devices[r])

        per_rank_items = [_map(lambda a, r=r: on_rank(a, r), items)
                          for r in range(k)]
        repl_sh = [[_on(_row_shard(a, k, r, 0), d)
                    for r, d in enumerate(sub.devices)]
                   for a in replicated]
        res = run_ranks(
            sub, lambda r: fn(per_rank_items[r],
                              *(sh[r] for sh in repl_sh)), n_rows)
        outs[i] = res[0]
