"""Data parallelism: row-sharded histograms, contingency tables and
batch scoring over the ranks of a data mesh.

Counterpart of ``transmogrifai_tpu/parallel/data_parallel.py``. There a
``Mesh`` of chips runs one SPMD program under ``shard_map`` and the
row-partitioned partials reduce across chips through
``models.kernels.allreduce_data`` (the Pallas RDMA ring, or ``psum``).
Here one process drives every rank, as JAX's single controller does: a
data mesh is a ``parallel.mesh.Mesh`` with the "data" axis, each entry a
rank with its own row shard, buffers and non-blocking CUDA stream (the
stream protocol is the mesh module's), and the partials reduce through
the port's ``allreduce_data`` / ``allgather_data`` (the hand-written
CUDA ring ``csrc/ring_allreduce.cu``, or its plain version). An entry
may repeat: several ranks on one card exchange through the same kernel,
with the same flags and barriers that ranks on peer cards use, the
counterpart of the JAX package's forced host devices.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, get_mesh, zero_pad_rows

__all__ = ["data_mesh", "shard_rows", "sharded_statistics",
           "sharded_contingency", "sharded_histograms", "sharded_score"]

#: rows sharded_statistics takes at most: its counts are f32 sums
#: (exact below 2**24) and its average ranks f32 halves (exact below
#: 2**23)
MAX_STATISTICS_ROWS = 1 << 23


def data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh with a "data" (row) axis over ``devices``, or over
    every configured card (``TM_MESH_DEVICES``, else all visible) when
    None. Raises without a card unless the caller names CPU devices
    (``["cpu"] * 4``)."""
    return get_mesh(devices, axis="data")


def shard_rows(arr, mesh: Mesh, axis: int = 0) -> List[torch.Tensor]:
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


def _reduce(parts: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    from ..models.kernels import allreduce_data, ring_reduce_enabled
    # the ring-vs-plain choice resolved once, on the host
    return allreduce_data(parts, mesh,
                          use_ring=ring_reduce_enabled(mesh.devices[0]))


def sharded_histograms(bins, stats_g, pos_g, m: int, B: int,
                       mesh: Optional[Mesh] = None) -> np.ndarray:
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


def sharded_statistics(X, y, mesh: Optional[Mesh] = None
                       ) -> Dict[str, np.ndarray]:
    """SanityChecker statistics over row shards (the JAX package's
    ``sharded_statistics``): every key of
    ``ops.sanity_checker.compute_statistics``, as numpy, computed from
    rank r's contiguous shard of the rows (zero-padded to a multiple of
    the mesh size, the padding masked out of every sum; ``n`` is the
    true row count) with four cross-rank calls, the ring's policy
    (``TM_MESH_RDMA_RING``) resolved once:

    1. ``allreduce_data`` of the packed first-pass sums (Σx, Σx², Σy,
       Σy²) -> mean, variance, std, y_mean, y_std;
    2. ``allgather_data`` of each rank's (2, d) column minima and maxima
       (the ring only sums), reduced on every rank;
    3. ``allgather_data`` of each rank's (x | y) columns, padding rows
       set to +inf so they rank above every real value, as the JAX
       package does: every rank ranks the full columns with the port's
       average-rank rule (``rank_columns`` on the card, the host ranks
       on the CPU, ``host_ranks_enabled``) and takes its own rows' ranks
       and the real rows' rank means;
    4. ``allreduce_data`` of the packed second-pass products of the
       standardised shard (``xs.T @ ys``, ``xs.T @ xs``) and of its
       centred ranks (Σ rx², Σ ry², ``rx.T @ ry``).

    The ``std > 0`` guards are ``statistics``'s. Every rank ends with
    the same bits; rank 0's are returned. Counts and rank sums are f32:
    exact below 2**24 rows, and the half-integer average ranks below
    2**23, so more than ``MAX_STATISTICS_ROWS`` rows raise."""
    from ..models.kernels import (allgather_data, allreduce_data,
                                  ring_reduce_enabled)
    from ..ops.sanity_checker import (host_rank_columns, host_ranks_enabled,
                                      rank_columns)
    mesh = mesh or data_mesh()
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    n, d = X.shape
    if n > MAX_STATISTICS_ROWS:
        raise ValueError(f"sharded_statistics takes at most "
                         f"{MAX_STATISTICS_ROWS} rows (f32 average ranks "
                         f"are exact below 2**23), got {n}")
    mask = np.zeros(n + (-n) % mesh.size, np.float32)
    mask[:n] = 1.0
    x_sh, y_sh, m_sh = (shard_rows(a, mesh) for a in (X, y, mask))
    use_ring = ring_reduce_enabled(mesh.devices[0])
    host_ranks = host_ranks_enabled(mesh.devices[0])
    ranks = range(mesh.size)
    inf = float("inf")
    mesh.fork()
    sums, extrema, cols = [], [], []
    with torch.inference_mode():
        for r in ranks:
            with mesh.rank(r):
                x, yy, m = x_sh[r], y_sh[r], m_sh[r]
                m1 = m[:, None] > 0
                xf, yf = x * m[:, None], yy * m
                sums.append(torch.cat([xf.sum(0), (xf * xf).sum(0),
                                       yf.sum().reshape(1),
                                       (yf * yf).sum().reshape(1)]))
                extrema.append(torch.stack([
                    torch.where(m1, x, inf).amin(0),
                    torch.where(m1, x, -inf).amax(0)]))
                cols.append(torch.where(
                    m1, torch.cat([x, yy[:, None]], 1), inf).contiguous())
        sums = allreduce_data(sums, mesh, use_ring)
        extrema = allgather_data(extrema, mesh, use_ring)
        cols = allgather_data(cols, mesh, use_ring)
        if host_ranks:       # the CPU's ranks: one host pass, every rank
            full = host_rank_columns(cols[0].reshape(-1, d + 1).cpu()
                                     .numpy())
        firsts, prods = [], []
        for r in ranks:
            with mesh.rank(r):
                s, dev = sums[r], mesh.devices[r]
                mean = s[:d] / n
                var = torch.clamp(s[d:2 * d] / n - mean * mean, min=0.0)
                std = torch.sqrt(var)
                y_mean = s[2 * d] / n
                y_std = torch.sqrt(torch.clamp(s[2 * d + 1] / n
                                               - y_mean ** 2, min=0.0))
                firsts.append(dict(
                    mean=mean, std=std, variance=var,
                    min=extrema[r][:, 0].amin(0),
                    max=extrema[r][:, 1].amax(0),
                    y_mean=y_mean, y_std=y_std))
                R = (torch.from_numpy(full).to(dev) if host_ranks
                     else rank_columns(cols[r].reshape(-1, d + 1)))
                r_mean = R[:n].sum(0) / n           # padding rows are last
                lo = r * x_sh[r].shape[0]
                own = R[lo:lo + x_sh[r].shape[0]]
                x, yy, m = x_sh[r], y_sh[r], m_sh[r]
                m1 = m[:, None] > 0
                zero = torch.zeros((), device=dev)
                safe_std = torch.where(std > 0, std, torch.ones_like(std))
                xs = torch.where(m1, (x - mean) / safe_std, zero)
                ys = torch.where(m > 0, (yy - y_mean) / torch.where(
                    y_std > 0, y_std, torch.ones_like(y_std)), zero)
                rx = torch.where(m1, own[:, :d] - r_mean[:d], zero)
                ry = torch.where(m > 0, own[:, d] - r_mean[d], zero)
                prods.append(torch.cat([
                    xs.T @ ys, (xs.T @ xs).reshape(-1),
                    (rx * rx).sum(0), (ry * ry).sum().reshape(1),
                    rx.T @ ry]))
        prods = allreduce_data(prods, mesh, use_ring)
        with mesh.rank(0):
            p, out = prods[0], firsts[0]
            std = out["std"]
            rx_sd = torch.sqrt(torch.clamp(p[d + d * d:2 * d + d * d] / n,
                                           min=1e-12))
            ry_sd = torch.sqrt(torch.clamp(p[2 * d + d * d] / n,
                                           min=1e-12))
            out.update(
                corr_label=torch.where(std > 0, p[:d] / n,
                                       torch.full_like(std, float("nan"))),
                corr_ff=p[d:d + d * d].reshape(d, d) / n,
                spearman=p[2 * d + d * d + 1:] / (n * rx_sd * ry_sd))
    mesh.join(*out.values())
    return {k: v.cpu().numpy() for k, v in out.items()}


def sharded_contingency(group_cols, y_onehot,
                        mesh: Optional[Mesh] = None) -> np.ndarray:
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
                  mesh: Optional[Mesh] = None,
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
