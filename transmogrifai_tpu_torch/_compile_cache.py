"""Where the port's CUDA kernels are built: the build-cache policy.

Counterpart of ``transmogrifai_tpu/_compile_cache.py``. The JAX package
caches XLA's compiled programs; the port compiles nothing with XLA and
calls no ``torch.compile``. What it compiles is its hand-written CUDA
kernels (``_cuda_build``): one shared library per ``csrc/<name>.cu``,
named by a hash of the source and the ``nvcc`` flags (the cache key),
kept in a build directory and reused by every later process. The
directory follows the JAX package's precedence:

1. a directory a caller already chose (:func:`set_build_dir`, as
   ``OpParams.compilation_cache_location`` does for a run) is respected;
2. ``TM_NO_COMPILE_CACHE=1`` builds into a directory of this process's
   own under the temp dir, never reused by another process;
3. ``TM_COMPILE_CACHE_DIR`` names the directory;
4. otherwise ``_build/`` in the package (``.gitignore`` lists it).

Libraries a process already loaded stay loaded when the directory
changes: the choice governs where the next build lands and is looked
for.
"""
from __future__ import annotations

import os
import tempfile
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))

#: the default build directory
DEFAULT_BUILD_DIR = os.path.join(_HERE, "_build")

_LOCK = threading.Lock()
_CHOSEN: Optional[str] = None
_PROCESS_DIR: Optional[str] = None


def _process_dir() -> str:
    global _PROCESS_DIR
    with _LOCK:
        if _PROCESS_DIR is None:
            _PROCESS_DIR = tempfile.mkdtemp(prefix="tm_kernels_")
        return _PROCESS_DIR


def build_dir() -> str:
    """The directory kernels are built into and loaded from now."""
    if _CHOSEN:
        return _CHOSEN
    if os.environ.get("TM_NO_COMPILE_CACHE") == "1":
        return _process_dir()
    return os.environ.get("TM_COMPILE_CACHE_DIR") or DEFAULT_BUILD_DIR


def chosen_build_dir() -> Optional[str]:
    """The directory a caller chose (:func:`set_build_dir`), or None."""
    return _CHOSEN


def set_build_dir(path: Optional[str]) -> Optional[str]:
    """Choose the build directory (None: back to the environment's and
    the default's); returns the previous choice, so a caller can restore
    it."""
    global _CHOSEN
    with _LOCK:
        prev, _CHOSEN = _CHOSEN, (os.path.abspath(path) if path else None)
        return prev


def enable_persistent_cache() -> Optional[str]:
    """The persistent build directory in effect: a caller's choice is
    respected untouched, ``TM_NO_COMPILE_CACHE=1`` gives None (builds go
    to a per-process directory), else ``TM_COMPILE_CACHE_DIR`` or the
    default."""
    if _CHOSEN:
        return _CHOSEN
    if os.environ.get("TM_NO_COMPILE_CACHE") == "1":
        return None
    return build_dir()
