"""The ONE atomic artifact-write path (tmp + fsync + rename) and the (the port's copy of
``transmogrifai_tpu/resilience/atomic.py``)
completeness sentinel every loader checks.

Before this module each artifact writer hand-rolled its own durability
(or none): ``WorkflowModel.save`` wrote ``workflow.json`` in place,
``export_portable`` wrote three files sequentially, the registry
manifest did tmp+rename without fsync, and the stream checkpoint did
the full dance privately. A crash mid-save could leave a
loadable-LOOKING corrupt model — the worst failure mode a serving
registry can ingest. Now:

* :func:`atomic_file` / :func:`atomic_write_json` /
  :func:`atomic_write_npz` — stage to ``<path>.tmp.<pid>``, flush,
  ``fsync``, ``os.replace``, then fsync the parent DIRECTORY. Readers
  of the final path never see a torn file; an OS crash after the
  replace still finds the payload on disk, and directory-entry
  ordering holds across files (a later sentinel rename cannot outlive
  an earlier payload rename).
* :data:`SENTINEL` (``_SUCCESS``, the Hadoop idiom) — multi-file
  artifact dirs write it LAST via :func:`mark_complete`; every load
  path calls :func:`require_complete` first and rejects a sentinel-less
  dir with :class:`IncompleteArtifactError` naming what to do.

Fault hook: every commit passes the ``stages.persistence.save``
injection point. The ``partial-write`` kind makes this helper commit a
TRUNCATED payload to the final path — deliberately simulating the torn
artifact a non-atomic writer leaves — so tests can prove the loaders'
rejection actually fires (resilience.faults).
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Iterator, Optional

from . import faults

#: completeness marker written LAST into a multi-file artifact dir
SENTINEL = "_SUCCESS"


class IncompleteArtifactError(ValueError):
    """A multi-file artifact dir without its completeness sentinel: the
    save crashed mid-way (or the dir was built by hand) — loading it
    could serve a torn model."""


def _fsync_dir(path: str) -> None:
    """fsync the directory containing `path`: POSIX gives no durability
    (or cross-file ordering) for the rename's directory entry until the
    dir itself syncs — without this, a power loss could keep a LATER
    file's rename (the sentinel) while dropping an earlier payload's,
    leaving a sentinel-stamped dir with old/missing files. Best-effort:
    some filesystems refuse O_RDONLY dir fsync."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _commit(tmp: str, path: str) -> None:
    """The guarded rename. partial-write injection lands HERE: commit a
    half-truncated payload to the final path, then raise — the torn
    file a crashed non-atomic writer would have left."""
    try:
        faults.fault_point("stages.persistence.save", path=path)
    except faults.PartialWriteFault:
        size = os.path.getsize(tmp)
        with open(tmp, "r+b") as f:
            f.truncate(max(size // 2, 1))
        os.replace(tmp, path)
        raise
    os.replace(tmp, path)
    _fsync_dir(path)


@contextlib.contextmanager
def atomic_file(path: str, mode: str = "wb") -> Iterator[Any]:
    """Yield a file object whose contents land at ``path`` atomically
    (flush + fsync + rename) when the block exits cleanly; on error the
    temp file is removed and ``path`` is untouched."""
    tmp = f"{path}.tmp.{os.getpid()}"
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        _commit(tmp, path)
    except BaseException:
        if not f.closed:
            f.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_bytes(path: str, data: bytes) -> None:
    with atomic_file(path, "wb") as f:
        f.write(data)


def atomic_write_json(path: str, doc: Any, *, indent: Optional[int] = 1,
                      default=None) -> None:
    atomic_write_bytes(path, json.dumps(doc, indent=indent,
                                        default=default).encode())


def atomic_write_npz(path: str, arrays: Dict[str, Any]) -> None:
    import numpy as np
    with atomic_file(path, "wb") as f:
        np.savez(f, **arrays)


def mark_complete(dir_path: str) -> str:
    """Stamp an artifact dir complete — call ONLY after every file in
    the dir has committed. Returns the sentinel path."""
    path = os.path.join(dir_path, SENTINEL)
    atomic_write_bytes(path, b"")
    return path


def clear_complete(dir_path: str) -> None:
    """Remove the sentinel BEFORE rewriting an artifact in place, so a
    crash mid-rewrite is detectable (the dir reverts to incomplete)."""
    with contextlib.suppress(OSError):
        os.unlink(os.path.join(dir_path, SENTINEL))


def is_complete(dir_path: str) -> bool:
    return os.path.exists(os.path.join(dir_path, SENTINEL))


def require_complete(dir_path: str, what: str = "artifact") -> None:
    """Loud gate for loaders: a dir without the sentinel was never
    fully saved (crash mid-save) or predates/bypasses the atomic
    writers — either way it must not load as a model."""
    if not is_complete(dir_path):
        raise IncompleteArtifactError(
            f"{dir_path}: {what} has no {SENTINEL} completeness sentinel "
            f"— the save did not finish (crashed mid-write?) or the dir "
            f"predates / bypassed the atomic export path. Re-export the "
            f"artifact rather than serving a possibly-torn model; for a "
            f"LEGACY artifact you have verified by hand, create an empty "
            f"{SENTINEL} file in the dir to migrate it")
