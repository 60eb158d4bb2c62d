"""The atomic file-write path and the completeness sentinel every
artifact loader checks (from ``transmogrifai_tpu.resilience.atomic``).

* :func:`atomic_file` / :func:`atomic_write_json` — stage to
  ``<path>.tmp.<pid>``, flush, ``fsync``, ``os.replace``, then fsync the
  parent directory: a reader of the final path never sees a torn file
  (the selector's fit checkpoint writes through it). Every commit
  passes the ``stages.persistence.save`` fault point; its
  ``partial-write`` kind commits a truncated payload, the torn file a
  non-atomic writer would leave.
* :data:`SENTINEL` (``_SUCCESS``, written LAST by the JAX package's
  atomic exporter) and :func:`require_complete`, which rejects a
  sentinel-less dir with :class:`IncompleteArtifactError` naming what
  to do.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Iterator, Optional

from . import faults

#: completeness marker written LAST into a multi-file artifact dir
SENTINEL = "_SUCCESS"


class IncompleteArtifactError(ValueError):
    """A multi-file artifact dir without its completeness sentinel: the
    save crashed mid-way (or the dir was built by hand) — loading it
    could serve a torn model."""


def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path`` (the rename's entry is not
    durable until it does). Best-effort: some filesystems refuse it."""
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
    """The guarded rename; a partial-write injection commits a
    half-truncated payload to the final path, then raises."""
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
    when the block exits cleanly; on error the temp file is removed and
    ``path`` is untouched."""
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
