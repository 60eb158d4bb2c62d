"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. At first
use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library
in the build directory (``_compile_cache.build_dir``: ``_build/`` by
default, listed in ``.gitignore``; the file name carries a hash of the
source and flags, so an edited source rebuilds) and loaded with
``ctypes``. Processes may share the directory: a build lands under a
name of its own and is renamed into place atomically. Nothing here includes PyTorch's headers, which keeps a
build at seconds rather than minutes.

Nothing is compiled at import time: a wrapper calls :func:`load_library`
the first time it launches on a CUDA tensor. :func:`build_all` compiles
every source at once, one ``nvcc`` process each, all started together.
A failed build raises with the compiler's output; it never falls back.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

from ._compile_cache import build_dir

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")

#: ``-Xptxas -v`` makes nvcc report each kernel's registers, shared
#: memory and spills; :data:`BUILD_LOG` keeps that report per kernel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> the compiler's report from the build this process ran
#: (empty when the library was already built)
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the CUDA
    toolkit's default install location."""
    cands = []
    # opaudit: disable=trace-env -- which compiler builds a library, read at every build; the library's name hashes its source and flags, and a loaded one serves the process by design
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use")


def _source(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    if not os.path.exists(src):
        raise FileNotFoundError(f"no CUDA source for kernel {name!r}: {src}")
    return src


def library_path(name: str) -> str:
    """Where ``name``'s shared library lives once built, in the build
    directory in effect now."""
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for ``name`` if its library is missing; returns
    (popen or None, tmp path, final path)."""
    so = library_path(name)
    if os.path.exists(so):
        return None, None, so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _source(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, proc, tmp: str, so: str) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed building kernel {name!r} "
            f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)         # atomic: a reader never loads a torn .so
    BUILD_LOG[name] = out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per
    process (a library once loaded stays loaded whatever the build
    directory becomes). Raises on a failed build."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = _LIBS[name] = ctypes.CDLL(library_path(name))
        return lib


def kernel_names() -> List[str]:
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` in parallel (one nvcc each, all
    started before any is waited on), then load them all."""
    with _LOCK:
        names = [n for n in kernel_names() if n not in _LIBS]
        started = [(n, *_start(n)) for n in names]
        errors = []
        for n, proc, tmp, so in started:
            try:                # wait for every nvcc before raising
                _finish(n, proc, tmp, so)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]
        for n, _proc, _tmp, so in started:
            _LIBS[n] = ctypes.CDLL(so)
        return dict(_LIBS)
