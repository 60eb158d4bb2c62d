"""Ranks of a data mesh in lockstep: one host thread per rank.

The JAX package runs a row-sharded fit as one SPMD program: GSPMD cuts
the rows over the ``"data"`` axis and inserts a cross-chip reduction at
every row contraction. Here one process drives the ranks, and
:func:`run_ranks` gives each rank of a 1-D data mesh a host thread of
its own that runs the same fit code on its row shard, on its stream.
The fit code marks its row contractions: :func:`row_sum` sums per-rank
partials, :func:`gather_rows` gathers row-sharded tensors in origin
order. Outside :func:`run_ranks` both return their inputs as they are,
so the one-device path is unchanged to the bit.

At a collective every rank thread deposits its part and waits; rank 0's
thread makes the one exchange over all parts (``allreduce_data`` /
``allgather_data``: the CUDA ring on the card, its plain version on the
CPU, the policy resolved once per :func:`run_ranks`) and every thread
takes its own result. A rank that raises breaks the barrier, so the
others stop at their next collective instead of waiting forever; the
first real error is re-raised in the caller.

Rows: the caller zero-pads the rows to a multiple of the mesh size and
gives rank r the contiguous shard ``[r * s, (r + 1) * s)``
(``parallel.data_parallel.shard_rows``); zero rows carry zero weight.
Draws made over every row (a forest's bootstrap, a boosted row
subsample) are cut to a rank's own with :func:`own_rows`
(:func:`total_rows` gives their length).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

#: a rank waiting at a collective longer than this raises (a peer that
#: died without breaking the barrier, or a protocol fault)
BARRIER_TIMEOUT_S = 600.0

_TLS = threading.local()


class RankGroup:
    """The collective state of one :func:`run_ranks` call."""

    def __init__(self, mesh, n_rows: int, use_ring: bool):
        self.mesh = mesh
        self.size = mesh.size
        #: real rows over all ranks, and rows of one rank's shard
        self.n_rows = int(n_rows)
        self.shard = -(-self.n_rows // self.size)
        self.use_ring = bool(use_ring)
        self._barrier = threading.Barrier(self.size,
                                          timeout=BARRIER_TIMEOUT_S)
        self._slots: List[Any] = [None] * self.size
        self._out: Optional[List[torch.Tensor]] = None

    def abort(self) -> None:
        self._barrier.abort()

    def exchange(self, r: int, part: torch.Tensor,
                 op: Callable) -> torch.Tensor:
        """Rank r's share of ``op(parts, mesh, use_ring)`` over every
        rank's ``part``; rank 0's thread makes the call."""
        self._slots[r] = part
        self._barrier.wait()
        if r == 0:
            try:
                self._out = op(list(self._slots), self.mesh, self.use_ring)
            except BaseException:
                self._barrier.abort()
                raise
        self._barrier.wait()
        return self._out[r]


def current() -> Optional[Tuple[RankGroup, int]]:
    """(group, rank) of the calling thread inside :func:`run_ranks`, else
    None."""
    return getattr(_TLS, "ctx", None)


def total_rows(n_local: int) -> int:
    """The real rows over every rank inside :func:`run_ranks` (``n_local``
    is this rank's shard); outside it, ``n_local``."""
    ctx = current()
    return n_local if ctx is None else ctx[0].n_rows


def own_rows(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The calling rank's rows of ``t``, whose ``dim`` spans every real
    row (a draw made over all rows): zero-padded to the shard layout and
    cut to the rank's shard. Outside :func:`run_ranks`, ``t``."""
    ctx = current()
    if ctx is None:
        return t
    g, r = ctx
    from .mesh import zero_pad_rows
    full = zero_pad_rows(t, g.size, axis=dim)
    return full.narrow(dim, r * g.shard, g.shard)


def _packed(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    for p in parts:
        if p.dtype != torch.float32:
            raise TypeError(f"spmd: collectives take float32, got "
                            f"{p.dtype}")
    return torch.cat([p.reshape(-1) for p in parts])


def row_sum(*parts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-rank partial row sums -> their sums over the data mesh, one
    exchange for all ``parts`` (packed into one buffer). Outside
    :func:`run_ranks` the parts are returned as they are."""
    ctx = current()
    if ctx is None:
        return parts
    g, r = ctx
    from ..models.kernels import allreduce_data
    flat = g.exchange(r, _packed(parts), allreduce_data)
    out, off = [], 0
    for p in parts:
        out.append(flat[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    return tuple(out)


def gather_rows(*parts: Tuple[torch.Tensor, int]) -> Tuple[torch.Tensor, ...]:
    """Row-sharded tensors -> every real row in origin order, one
    exchange for all. Each entry is (tensor, row dim); the row dims hold
    the rank's shard rows and come back holding the real rows (the zero
    padding dropped). Outside :func:`run_ranks`, the tensors as they
    are."""
    ctx = current()
    if ctx is None:
        return tuple(t for t, _ in parts)
    g, r = ctx
    from ..models.kernels import allgather_data
    cols = []
    for t, dim in parts:
        if t.shape[dim] != g.shard:
            raise ValueError(f"gather_rows: {t.shape[dim]} rows on rank "
                             f"{r}, the shard holds {g.shard}")
        cols.append(t.movedim(dim, 0).reshape(g.shard, -1))
    if any(c.dtype != torch.float32 for c in cols):
        raise TypeError("spmd: collectives take float32")
    packed = torch.cat(cols, dim=1).contiguous()
    full = g.exchange(r, packed, allgather_data)
    full = full.reshape(g.size * g.shard, -1)[:g.n_rows]
    out, off = [], 0
    for (t, dim), c in zip(parts, cols):
        w = c.shape[1]
        lead = t.movedim(dim, 0).shape[1:]
        out.append(full[:, off:off + w].reshape((g.n_rows,) + lead)
                   .movedim(0, dim))
        off += w
    return tuple(out)


_LINALG_READY = False


def _load_cuda_linalg(device: torch.device) -> None:
    """Load torch's CUDA linear-algebra library once, on the calling
    thread: its loader runs at the first such op and raises ("lazy
    wrapper should be called at most once") when two rank threads reach
    their first Cholesky together."""
    global _LINALG_READY
    if not _LINALG_READY:
        torch.linalg.cholesky_ex(torch.ones((1, 1), device=device))
        _LINALG_READY = True


def run_ranks(mesh, fn: Callable[[int], Any], n_rows: int,
              use_ring: Optional[bool] = None) -> List[Any]:
    """``fn(r)`` for every rank r of the 1-D data mesh ``mesh``, each on
    a thread of its own inside ``mesh.rank(r)``, in lockstep at the
    collectives of this module; returns the per-rank results. ``n_rows``
    is the real row count the shards split. The caller's grad or
    inference mode and NaN checking (``profiling.debug_nans``) hold in
    every rank thread. ``use_ring`` is the exchange policy (None:
    ``kernels.ring_reduce_enabled`` of the mesh's first device)."""
    from ..models.kernels import ring_reduce_enabled
    from ..profiling import nan_checks
    if use_ring is None:
        use_ring = ring_reduce_enabled(mesh.devices[0])
    group = RankGroup(mesh, n_rows, use_ring)
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    results: List[Any] = [None] * mesh.size
    errors: List[Optional[BaseException]] = [None] * mesh.size

    def body(r: int) -> None:
        _TLS.ctx = (group, r)
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.inference_mode(inference))
                stack.enter_context(torch.set_grad_enabled(grad))
                stack.enter_context(mesh.rank(r))
                stack.enter_context(nan_checks())
                results[r] = fn(r)
        except BaseException as e:      # surfaced by the caller below
            errors[r] = e
            group.abort()
        finally:
            _TLS.ctx = None

    if mesh.is_cuda:
        _load_cuda_linalg(mesh.devices[0])
    mesh.fork()
    threads = [threading.Thread(target=body, args=(r,),
                                name=f"tm-rank-{r}", daemon=True)
               for r in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [e for e in errors
            if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]
    broken = [e for e in errors if e is not None]
    if broken:
        raise RuntimeError("spmd: a rank's collective timed out after "
                           f"{BARRIER_TIMEOUT_S} s") from broken[0]
    mesh.join(*(t for res in results for t in _tensors(res)))
    return results


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []
