"""Multi-process runtime over ``torch.distributed``.

Counterpart of ``transmogrifai_tpu/parallel/multihost.py``. There every
host runs the same program, ``jax.distributed.initialize`` wires the
processes into one runtime, and meshes span every host's devices. Here
:func:`initialize_distributed` joins this process to a ``gloo`` process
group from the same launch contract (``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID``), and a mesh's entries for another
process are :class:`DeviceHandle`\\ s that carry its index.

Mesh layout policy (the JAX package's): the axis with the heaviest
communication stays inside a process and the embarrassingly parallel
axis crosses processes. :func:`hybrid_mesh` builds a
``parallel.mesh.Mesh2D`` whose first axis (``"dcn_grid"``) spans
processes: a process owns its row, runs its shard of the grid items on
that row's ranks (each row's data exchanges ride the CUDA ring inside
the process), and the rows' results are gathered over the process group
in grid order (:func:`gather_rows_results`). So the cross-process axis
carries only gathered results (metrics, fitted parameters), and it uses
``gloo`` on the CPU and on the card alike: NCCL refuses two ranks on
one GPU. A data axis that would cross processes raises, naming
:func:`hybrid_mesh` (``Mesh2D``); the JAX ``hybrid_mesh`` never builds
one either.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["initialize_distributed", "hybrid_mesh", "host_device_groups",
           "process_info", "process_index", "DeviceHandle",
           "world_devices", "gather_rows_results"]

#: a process-group rendezvous or collective waiting on a peer longer
#: than this raises
DIST_TIMEOUT_S = 300.0


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def _initialized() -> bool:
    dist = _dist()
    return dist is not None and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the process group (0 when there is none)."""
    return _dist().get_rank() if _initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: float = DIST_TIMEOUT_S) -> dict:
    """Join this process to the multi-process runtime.

    Arguments default from the environment (``COORDINATOR_ADDRESS`` /
    ``NUM_PROCESSES`` / ``PROCESS_ID``, the JAX package's launch
    contract). With no coordinator and no process count it is a no-op
    (one process); a second call once the group exists is a no-op too.
    Otherwise all three are needed (nothing is auto-detected): the
    ``gloo`` group rendezvouses at ``tcp://<coordinator_address>`` and a
    peer that does not arrive within ``timeout_s`` raises. Returns
    :func:`process_info`."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if ((coordinator_address is not None or num_processes is not None)
            and not _initialized()):
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "initialize_distributed needs the coordinator address, "
                "the process count and this process's id (arguments or "
                "COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID), got "
                f"{coordinator_address!r}, {num_processes!r}, "
                f"{process_id!r}")
        dist = _dist()
        if dist is None:
            raise RuntimeError("torch.distributed is not available")
        dist.init_process_group(
            "gloo", init_method=_init_method(str(coordinator_address)),
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout_s))
    return process_info()


def _local_devices() -> List[torch.device]:
    from .mesh import configured_devices
    return configured_devices()


def _all_gather(obj: Any) -> List[Any]:
    """``obj`` from every process, in process order (one process: [obj])."""
    if not _initialized() or process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    _dist().all_gather_object(out, obj)
    return out


def process_info() -> dict:
    """{"process_id", "num_processes", "device_count",
    "local_device_count"}: ``device_count`` is the world's total, from an
    all-gather of every process's configured device count (0 in a
    process that sees no card: the port's meshes hold no CPU device
    unless a caller names one)."""
    try:
        local = len(_local_devices())
    except RuntimeError:            # no card visible
        local = 0
    return {"process_id": process_index(),
            "num_processes": process_count(),
            "device_count": int(sum(_all_gather(local))),
            "local_device_count": local}


@dataclass(frozen=True)
class DeviceHandle:
    """A mesh entry of some process: ``device`` as that process names
    it, ``id`` its place in the world's device list, ``label`` its
    attribution label (``p<process>/<device label>``)."""
    process_index: int
    device: torch.device
    id: int
    label: str


def world_devices(local: Optional[Sequence] = None) -> List[DeviceHandle]:
    """Every process's devices (``local`` here; None: the configured
    devices) as handles, in process order."""
    from .mesh import device_labels
    local = [torch.device(d) for d in (_local_devices() if local is None
                                       else local)]
    mine = [(str(d), lab) for d, lab in zip(local, device_labels(local))]
    out: List[DeviceHandle] = []
    for pid, devs in enumerate(_all_gather(mine)):
        for dev, lab in devs:
            out.append(DeviceHandle(pid, torch.device(dev), len(out),
                                    f"p{pid}/{lab}"))
    return out


def host_device_groups(devices: Sequence, per_host: Optional[int] = None
                       ) -> np.ndarray:
    """(n_hosts, per_host) array of devices grouped by owning process:
    by each entry's ``process_index`` when they span several (hosts in
    process order, entries by ``id`` within one), else contiguous chunks
    of ``per_host`` (one process standing in for several)."""
    devs = list(devices)
    by_proc: Dict[int, list] = {}
    for d in devs:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    if len(by_proc) > 1:
        counts = {len(v) for v in by_proc.values()}
        if len(counts) != 1:
            raise ValueError(f"uneven devices per host: "
                             f"{ {k: len(v) for k, v in by_proc.items()} }")
        rows = [sorted(v, key=lambda d: getattr(d, "id", 0))
                for _, v in sorted(by_proc.items())]
        out = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, r in enumerate(rows):
            for j, d in enumerate(r):
                out[i, j] = d
        return out
    if per_host is None:
        per_host = len(devs)
    if per_host < 1 or len(devs) % per_host:
        raise ValueError(f"{len(devs)} devices not divisible by "
                         f"per_host={per_host}")
    out = np.empty((len(devs) // per_host, per_host), dtype=object)
    for i, d in enumerate(devs):
        out[i // per_host, i % per_host] = d
    return out


def hybrid_mesh(devices: Optional[Sequence] = None,
                per_host: Optional[int] = None,
                axes: tuple = ("dcn_grid", "data")):
    """A ``parallel.mesh.Mesh2D`` whose FIRST axis crosses processes and
    second stays within one: the default axes put grid items across
    processes and each item's row reductions inside a process; pass
    ``axes=("dcn_grid", "grid")`` to split a large grid over both.
    ``devices`` None: :func:`world_devices` (every process's configured
    devices); plain local devices in a multi-process world are gathered
    the same way; one process may stand in for several hosts with
    ``per_host``."""
    from .mesh import Mesh2D
    if devices is None:
        devs = world_devices()
    else:
        devs = list(devices)
        if process_count() > 1 and not all(isinstance(d, DeviceHandle)
                                           for d in devs):
            devs = world_devices(devs)
    return Mesh2D(host_device_groups(devs, per_host).tolist(), tuple(axes))


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


#: this process's cross-process ``grid_map`` gathers so far: every
#: process makes the same gathers in the same order, so the count names
#: the dispatch a gather belongs to
_GATHERS = [0]


def gather_rows_results(outs: Dict[int, Any], mesh, key: Any = None,
                        error: Optional[BaseException] = None
                        ) -> List[Any]:
    """Every row's ``grid_map`` result in grid order, from this process's
    rows (``outs``: {row index: result}) and every other process's, over
    the process group (tensors travel as CPU tensors).

    Each process sends its dispatch's key (this gather's place in its
    sequence and ``key``, the caller's description of the batch) and
    the gather raises on every process when the keys differ: processes
    out of step would otherwise pair rows of different batches. A
    process whose own rows raised passes ``error`` and sends no rows;
    every process then raises after the gather (the failing one its own
    error, the others a ``RuntimeError`` naming it, or an out-of-memory
    error when it ran out of memory, so that every process takes the
    same chunked retry). A row no process reports raises."""
    _GATHERS[0] += 1
    mine = {"key": (_GATHERS[0], key),
            "error": None if error is None else (
                type(error).__name__, str(error),
                isinstance(error, torch.cuda.OutOfMemoryError)),
            "rows": {} if error is not None
            else {i: _to_host(v) for i, v in outs.items()}}
    parts = _all_gather(mine)
    if error is not None:
        raise error
    keys = [p["key"] for p in parts]
    if any(k != keys[0] for k in keys):
        raise RuntimeError(f"processes gathered the rows of different "
                           f"dispatches (gather number, batch) by process: "
                           f"{keys}")
    for pid, p in enumerate(parts):
        if p["error"] is not None:
            name, msg, oom = p["error"]
            cls = torch.cuda.OutOfMemoryError if oom else RuntimeError
            raise cls(f"process {pid} failed its mesh rows: {name}: {msg}")
    merged: Dict[int, Any] = {}
    for p in parts:
        merged.update(p["rows"])
    n = len(mesh.device_rows)
    missing = [i for i in range(n) if i not in merged]
    if missing:
        raise RuntimeError(f"no process reported mesh rows {missing}")
    return [merged[i] for i in range(n)]
