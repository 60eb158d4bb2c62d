"""Data parallelism: row-sharded histograms, contingency tables and
batch scoring over the ranks of a data mesh.

Counterpart of ``transmogrifai_tpu/parallel/data_parallel.py``. There a
``Mesh`` of chips runs one SPMD program under ``shard_map`` and the
row-partitioned partials reduce across chips through
``models.kernels.allreduce_data`` (the Pallas RDMA ring, or ``psum``).
Here one process drives every rank, as JAX's single controller does: a
:class:`DataMesh` is an explicit list of ``torch.device``s, each entry a
rank with its own row shard, buffers and non-blocking CUDA stream, and
the partials reduce through the port's ``allreduce_data`` (the
hand-written CUDA ring ``csrc/ring_allreduce.cu``, or its plain
version). An entry may repeat: several ranks on one card exchange
through the same kernel, with the same flags and barriers that ranks
on peer cards use, the counterpart of the JAX package's forced host
devices.

Stream protocol. Work of rank r is issued on ``mesh.streams[r]``
(``with mesh.rank(r)``). An entry point first calls :meth:`DataMesh.fork`
(each rank stream waits for its card's current stream, where the shards
were copied) and last :meth:`DataMesh.join` (each card's current stream
waits for the rank streams; tensors handed back are recorded on it).

``sharded_statistics`` (SanityChecker statistics over row shards) is
not ported yet; it comes with the SanityChecker.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .mesh import configured_devices, device_labels, zero_pad_rows

__all__ = ["DataMesh", "data_mesh", "shard_rows", "sharded_contingency",
           "sharded_histograms", "sharded_score"]


class DataMesh:
    """The ranks of a row-partitioned computation: ``devices[r]`` holds
    rank r's shard and ``streams[r]`` (None on the CPU) runs its work.
    Devices must all be CUDA or all be the CPU; a device may repeat.
    The ring communicator (``models.kernels``) keeps its buffers on the
    mesh, created at the first ring call."""

    def __init__(self, devices: Sequence):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a data mesh needs at least one device")
        kinds = {d.type for d in devs}
        if kinds == {"cuda"}:
            devs = [torch.device("cuda", torch.cuda.current_device()
                                 if d.index is None else d.index)
                    for d in devs]
            self.streams = [torch.cuda.Stream(device=d) for d in devs]
            if len({s.cuda_stream for s in self.streams}) != len(devs):
                raise RuntimeError("data mesh ranks must have distinct "
                                   "streams")
        elif kinds == {"cpu"}:
            self.streams = [None] * len(devs)
        else:
            raise ValueError(f"a data mesh is all CUDA or all CPU devices, "
                             f"got {device_labels(devs)}")
        self.devices = devs
        self.ring = None            # models.kernels._RingComm, lazily

    @property
    def size(self) -> int:
        return len(self.devices)

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
        return f"DataMesh({self.labels()})"


def data_mesh(devices: Optional[Sequence] = None) -> DataMesh:
    """A data mesh over ``devices``, or over every configured card
    (``TM_MESH_DEVICES``, else all visible) when None. Raises without a
    card unless the caller names CPU devices (``["cpu"] * 4``)."""
    return DataMesh(configured_devices() if devices is None else devices)


def shard_rows(arr, mesh: DataMesh, axis: int = 0) -> List[torch.Tensor]:
    """Split ``arr`` (numpy or torch) along ``axis`` into ``mesh.size``
    contiguous row shards, zero-padding the row count to a multiple of
    the mesh size first (zero rows carry zero stats and weights, so they
    add exact zeros to every row sum), and place shard r on rank r's
    device."""
    a = zero_pad_rows(arr, mesh.size, axis)
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a
    return [c.to(d).contiguous()
            for c, d in zip(torch.tensor_split(t, mesh.size, dim=axis),
                            mesh.devices)]


def _reduce(parts: List[torch.Tensor], mesh: DataMesh) -> List[torch.Tensor]:
    from ..models.kernels import allreduce_data, ring_reduce_enabled
    # the ring-vs-plain choice resolved once, on the host
    return allreduce_data(parts, mesh,
                          use_ring=ring_reduce_enabled(mesh.devices[0]))


def sharded_histograms(bins, stats_g, pos_g, m: int, B: int,
                       mesh: Optional[DataMesh] = None) -> np.ndarray:
    """Row-partitioned grid histograms with an explicit cross-rank
    reduction: rank r builds the partial (G, m*S, d*B) histogram of its
    own rows with ``models.kernels.histogram_grid`` on its stream, and
    the partials reduce through ``allreduce_data`` (the CUDA ring, or
    its plain version under TM_MESH_RDMA_RING=0 and on the CPU). bins
    (n, d) int32, stats_g (G, n, S) f32, pos_g (G, n) int32. Returns the
    replicated histogram as numpy; padding rows carry zero stats."""
    from ..models.kernels import histogram_grid
    mesh = mesh or data_mesh()
    b_sh = shard_rows(np.asarray(bins, np.int32), mesh)
    s_sh = shard_rows(np.asarray(stats_g, np.float32), mesh, axis=1)
    p_sh = shard_rows(np.asarray(pos_g, np.int32), mesh, axis=1)
    mesh.fork()
    parts = []
    for r in range(mesh.size):
        with mesh.rank(r):
            parts.append(histogram_grid(b_sh[r], s_sh[r], p_sh[r], m, B))
    out = _reduce(parts, mesh)
    mesh.join(*out)
    return out[0].cpu().numpy()


def sharded_contingency(group_cols, y_onehot,
                        mesh: Optional[DataMesh] = None) -> np.ndarray:
    """Contingency table (g, c) for Cramér's V over row shards: per
    rank ``g_r.T @ y_r`` (f32), reduced across ranks. Zero padding rows
    add nothing to any cell."""
    mesh = mesh or data_mesh()
    g_sh = shard_rows(np.asarray(group_cols, np.float32), mesh)
    y_sh = shard_rows(np.asarray(y_onehot, np.float32), mesh)
    mesh.fork()
    parts = []
    for r in range(mesh.size):
        with mesh.rank(r):
            parts.append((g_sh[r].T @ y_sh[r]).contiguous())
    out = _reduce(parts, mesh)
    mesh.join(*out)
    return out[0].cpu().numpy()


def sharded_score(predict_fn: Callable, params: Dict[str, Any], X,
                  mesh: Optional[DataMesh] = None,
                  n_classes: int = 2) -> np.ndarray:
    """Batch-score rows sharded across the mesh (data-parallel
    inference): rank r runs ``predict_fn(params, X_r, n_classes)`` on
    its shard; the outputs are gathered in row order as numpy."""
    from ..models.base import params_on
    mesh = mesh or data_mesh()
    n = np.shape(X)[0]
    x_sh = shard_rows(np.asarray(X, np.float32), mesh)
    mesh.fork()
    outs = []
    for r in range(mesh.size):
        with mesh.rank(r):
            outs.append(predict_fn(params_on(params, mesh.devices[r]),
                                   x_sh[r], n_classes))
    mesh.join(*outs)
    return np.concatenate([o.cpu().numpy() for o in outs])[:n]
