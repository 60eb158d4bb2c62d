"""Versioned model registry with zero-downtime hot-swap.

Counterpart of ``transmogrifai_tpu/serving/registry.py`` for the port.
The serving engine never holds a model directly — it asks the registry
for a version at each micro-batch dispatch, which is what makes
hot-swap safe and downtime-free:

1. `register()` loads and (optionally) WARMS the new version — every
   shape bucket runs once on the device before the version is ever
   eligible for traffic.
2. `set_default()` is an atomic pointer flip under the registry lock —
   requests dispatched after the flip score on the new version,
   requests already in flight finish on the old one.
3. The old version DRAINS: its in-flight count is tracked by
   `acquire()`/release, and `retire()` waits until the count hits zero
   before dropping the backend reference (releasing its device
   tensors). Nothing in flight is ever cut off.

Versions load from two artifact layouts (auto-detected): a portable
export (`manifest.json` + params.npz, written by the JAX package's
``portable_export``) -> a :class:`workflow.FusedScorer` over the port's
stage chain on the registry's device, and a registry root
(`registry.json`) naming many versions. Every load resolves its device
with ``resolve_device``: CUDA unless ``device="cpu"`` is asked for.

Multi-model serving (the model plane behind the engine's (model,
bucket) dispatcher):

* **Aliases** — ``alias(name, target)`` registers a tenant-facing
  model id over an existing version WITHOUT loading anything new;
  requests routed under different aliases of one backend CO-BATCH into
  a single device dispatch (the engine groups by backend identity).
* **LRU'd weight cache** — ``max_loaded`` (``TM_MODEL_CACHE``) bounds
  how many versions sit warm at once. Evicted versions keep their
  loader and RELOAD on next acquire — cold loads run on the acquiring
  (submitting) thread, never on the dispatcher hot path. The serving
  DEFAULT and any version with in-flight batches are never evicted.
* **Single-flight loads** — a cold version's load runs under that
  version's own condition variable, so N concurrent acquires on one
  cold model load it ONCE.
* **Loud misses** — an unknown model id raises :class:`ModelNotFound`
  (a KeyError subclass) at lookup; nothing ever silently falls back to
  the default version.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .._device import resolve_device
from .fusion import backend_caps


class ModelNotFound(KeyError):
    """Registry miss: the requested model/version id is not registered
    (and is not an alias of anything registered). Deliberately LOUD —
    the request fails with this error at submit instead of silently
    scoring the registry default. A KeyError subclass so ``except
    KeyError`` callers keep working; NOT retryable — the id is equally
    unknown on every replica."""

    retryable = False


#: TM_MODEL_* env knobs for the multi-model serving plane — ONE catalog
#: (parse_env_fields strictness: a typo'd TM_MODEL_ name raises) shared
#: by the registry (cache bound) and the engine config (metrics top-K).
#: The JAX package's TM_MODEL_CROSS_BATCH has no counterpart: the port
#: always co-batches across models in a drain pass.
_MODEL_ENV_FIELDS: Dict[str, tuple] = {
    "TM_MODEL_CACHE": ("cache", int),
    "TM_MODEL_TOPK": ("topk", int),
}


def model_env_fields(environ: Optional[Dict[str, str]] = None,
                     **overrides) -> Dict[str, Any]:
    """Parse the TM_MODEL_* knob surface (strict; explicit overrides
    win). Returns whichever of {cache, topk} are set."""
    from ..resilience.config import parse_env_fields
    return parse_env_fields("TM_MODEL_", _MODEL_ENV_FIELDS,
                            what="model-plane env var",
                            environ=environ, overrides=overrides)


class _FusedBackend:
    """Scoring backend over workflow.FusedScorer (the port's device
    tail).

    prepare() runs the request normalization + boundary assembly
    (submit-thread work); launch() queues the bucketed device tail
    without waiting on it and finalize() materializes it (the one
    ``.cpu()``), so the engine's drain pass can queue every model's
    sub-batch before waiting on any. Results are identical to
    FusedScorer.score_arrays on the same rows."""

    kind = "workflow"

    def __init__(self, scorer):
        self.scorer = scorer

    @property
    def buckets(self):
        return self.scorer.buckets

    @property
    def stats(self):
        return self.scorer.stats

    @property
    def result_names(self):
        return self.scorer.result_names

    def prepare(self, data) -> Tuple[int, List[np.ndarray]]:
        return self.scorer._boundary_host(data)

    def run(self, n: int, vals: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
        sc = self.scorer
        with sc.stats.timed():
            return sc._finalize(sc._dispatch(n, vals))

    def launch(self, n: int, vals: Sequence[np.ndarray]):
        """Queue the device tail WITHOUT materializing results: the
        engine's cross-model drain pass launches every model's
        sub-batch back to back, then finalizes."""
        sc = self.scorer
        with sc.stats.timed():
            return sc._dispatch(n, vals)

    def finalize(self, parts) -> Dict[str, np.ndarray]:
        sc = self.scorer
        with sc.stats.timed():
            return sc._finalize(parts)

    def warm(self, sample=None) -> int:
        """Run every shape bucket once on the device BEFORE the version
        takes traffic (first-touch allocations and library loads land
        here, not on live requests). `sample` (any scoreable data, e.g.
        one row) supplies realistic boundary dtypes; without it float32
        zeros warm the dense columns and int32 zeros the hashed-index
        columns (``index_boundary``). Returns the number of warm runs. Books
        NO batch/row/padding/seconds: warm rows are not served
        traffic."""
        from ..workflow import _pad_rows, to_device

        sc = self.scorer
        if sample is not None:
            n, vals = self.prepare(sample)
            if n == 0:
                raise ValueError("warm sample has zero rows")
        else:
            # hashed-index columns warm as integer ids (bucket 0), never
            # as f32: a float id column would not be the request's dtype
            n = 1
            vals = [np.zeros(1, np.int32 if name in sc.index_boundary
                             else np.float32) for name in sc.boundary]
        runs = 0
        for b in (sc.buckets or (n,)):
            dev = [to_device(_pad_rows(v[:min(n, b)], b), sc.device)
                   for v in vals]
            for o in sc.run_tail(dev):
                o.cpu()             # block: the device really ran it
            runs += 1
        return runs


class ModelVersion:
    """One registered version: a backend + in-flight accounting.

    `loader` supports LAZY versions (registry roots with deploy
    history): the artifact loads on first acquire(), so startup memory
    and time track the versions that actually serve, not every version
    ever deployed."""

    def __init__(self, name: str, backend, source: Optional[str] = None,
                 loader=None):
        self.name = name
        self.backend = backend
        # dispatch capabilities (two-phase launch/finalize, stackable
        # head) resolved ONCE per publish and carried on every lease —
        # the engine's hot path used to re-run getattr + callable
        # probes per dispatch (see fusion.BackendCaps)
        self.caps = None if backend is None else backend_caps(backend)
        self.source = source
        # RETAINED across loads (not nulled on first use): an LRU
        # eviction drops the backend but keeps the loader, so the
        # version can reload cold on its next acquire
        self._loader = loader
        self.registered_at = time.time()
        self.warmed = False
        self.retired = False
        self.released = False
        self.inflight = 0
        self.loads = 0              # completed loader runs (1 = first)
        self._loading = False       # a loader run is in flight
        self._cond = threading.Condition()

    def _try_acquire_loaded(self):
        """Refcount + return the backend IF already loaded, else None
        (caller must then _load_and_acquire outside the registry lock)."""
        with self._cond:
            if self.backend is not None and not self.released:
                self.inflight += 1
                return self.backend
            if self.released or self._loader is None:
                raise RuntimeError(
                    f"model version {self.name!r} already released")
            return None

    def _load_and_acquire(self):
        """Cold (first-use or post-eviction) load, guarded by THIS
        version's cond only — a multi-second artifact load must stall
        neither the global registry lock (every other version's
        submit/dispatch/status) nor this version's own info() probes.
        SINGLE-FLIGHT: exactly one thread runs the loader (the
        ``_loading`` flag, flipped under the cond; the loader itself
        runs OUTSIDE it); a herd of concurrent acquires on one cold
        model loads once — the rest wait on the cond and wake to
        the loaded backend. Returns (backend, loaded_now):
        loaded_now=False is the coalesced-waiter case the cache stats
        count. If the loader raises, waiters wake to an unloaded
        version and the next one retries the load."""
        with self._cond:
            while self._loading:
                self._cond.wait()
            if self.backend is not None and not self.released:
                self.inflight += 1
                return self.backend, False      # another thread's load
            if self.released or self._loader is None:
                raise RuntimeError(
                    f"model version {self.name!r} already released")
            self._loading = True
            loader = self._loader
        loaded = None
        caps = None
        try:
            loaded = loader()
            if loaded is not None:
                # resolve OUTSIDE the cond: caps detection walks the
                # scorer's stage metadata and must not extend the
                # publish critical section
                caps = backend_caps(loaded)
        finally:
            with self._cond:
                self._loading = False
                if loaded is not None:
                    # caps before backend: any thread that observes the
                    # published backend must also observe its caps
                    self.caps = caps
                    self.backend = loaded
                    self.loads += 1
                    # refcount in the SAME hold that publishes the
                    # backend: a concurrent LRU eviction sweep must
                    # never see it loaded-but-unpinned in between
                    self.inflight += 1
                self._cond.notify_all()
        return loaded, True

    def _evict(self) -> bool:
        """Drop the loaded backend (its device tensors) while
        KEEPING the loader, so the version reloads on next acquire —
        the LRU cache's eviction arm. Refuses (returns False) when the
        version is busy (in-flight batches), not reloadable (no
        loader: registered from an in-memory model), released, or not
        loaded at all."""
        with self._cond:
            if (self.backend is None or self.released or self.retired
                    or self._loader is None or self.inflight > 0):
                return False
            self.backend = None
            self.caps = None
            self.warmed = False
            return True

    def _release(self):
        with self._cond:
            self.inflight -= 1
            if self.inflight != 0:
                # nothing to wake: _drain waits for inflight == 0 and
                # load waiters are woken by the loader's own finally —
                # skipping the no-op notify keeps release at one lock
                # round on the per-request hot path
                return
            if self.retired and not self.released:
                self.backend = None     # free params / device programs
                self.caps = None
                self.released = True
            self._cond.notify_all()

    def _drain(self, timeout: Optional[float]) -> bool:
        """Wait for in-flight batches to finish; release on success."""
        with self._cond:
            ok = self._cond.wait_for(lambda: self.inflight == 0, timeout)
            if ok and not self.released:
                self.backend = None
                self.caps = None
                self.released = True
            return ok

    def info(self) -> Dict[str, Any]:
        with self._cond:
            return {"source": self.source, "warmed": self.warmed,
                    "retired": self.retired, "released": self.released,
                    "inflight": self.inflight,
                    "loaded": self.backend is not None,
                    "kind": getattr(self.backend, "kind", None),
                    "registered_at": self.registered_at}


def _load_backend(path: str, buckets=True, device=None):
    """Build a version's backend from a portable artifact directory;
    returns (backend, source path)."""
    from ..resilience.faults import fault_point
    fault_point("serving.registry.load", path=path)
    if os.path.exists(os.path.join(path, "manifest.json")):
        from .. import portable
        pm = portable.load(path, device=device)     # checks _SUCCESS
        return _FusedBackend(pm.compile_scoring(buckets=buckets)), path
    raise ValueError(
        f"{path}: not a portable export (manifest.json); the port serves "
        f"portable artifacts only")


class _Lease:
    """The `with registry.acquire(...) as (vname, backend)` handle: a
    slotted enter/exit pair over an already-taken in-flight count.
    ``version`` is None for the acquire_if_loaded cold case (backend
    None, nothing held, exit is a no-op). ``caps`` is the version's
    publish-time BackendCaps (None when cold): the engine reads it off
    the lease instead of re-probing the backend per dispatch."""

    __slots__ = ("name", "backend", "caps", "_version")

    def __init__(self, name, backend, version, caps=None):
        self.name = name
        self.backend = backend
        self.caps = caps
        self._version = version

    def __enter__(self):
        return self.name, self.backend

    def __exit__(self, exc_type, exc, tb):
        if self._version is not None:
            self._version._release()
        return False


class ModelRegistry:
    """Thread-safe named-version registry; see module docstring.

    ``max_loaded`` (default: the ``TM_MODEL_CACHE`` knob, else
    unbounded) is the LRU warm-capacity bound: once more than
    ``max_loaded`` versions hold a loaded backend, the least-recently-
    acquired RELOADABLE version (lazy-registered, idle, non-default)
    is evicted — its device tensors drop, its loader
    stays, and the next acquire reloads it cold."""

    def __init__(self, max_loaded: Optional[int] = None):
        if max_loaded is None:
            max_loaded = model_env_fields().get("cache")
        if max_loaded is not None and int(max_loaded) < 1:
            raise ValueError(
                "max_loaded (TM_MODEL_CACHE) must be >= 1 — the serving "
                "default always stays warm; unset the knob for an "
                "unbounded cache")
        self.max_loaded = int(max_loaded) if max_loaded is not None else None
        self._lock = threading.RLock()
        self._versions: Dict[str, ModelVersion] = {}
        self._aliases: Dict[str, str] = {}      # model id -> target name
        self._pending: set = set()      # names mid-register (load/warm)
        self._default: Optional[str] = None
        #: LRU recency: name -> monotonically increasing touch stamp
        self._touch_seq = 0
        self._touched: Dict[str, int] = {}
        self._cache_lock = threading.Lock()
        self._cache_counters = {"cold_loads": 0, "reloads": 0,
                                "evictions": 0, "coalesced_loads": 0}

    def _cache_bump(self, key: str, n: int = 1) -> None:
        with self._cache_lock:
            self._cache_counters[key] += n

    def cache_stats(self) -> Dict[str, Any]:
        """The model-cache block: capacity + loaded gauge +
        the eviction/reload/single-flight counters (never silent —
        every cold load and every coalesced herd waiter is a count)."""
        with self._lock:
            loaded = sum(1 for v in self._versions.values()
                         if v.backend is not None and not v.released)
            aliases = len(self._aliases)
        with self._cache_lock:
            out = dict(self._cache_counters)
        out.update({"capacity": self.max_loaded, "loaded": loaded,
                    "aliases": aliases})
        return out

    # -- registration -----------------------------------------------------
    def register(self, name: str, model, *, buckets=True,
                 warm_sample=None, warm: bool = True,
                 make_default: bool = False, source: Optional[str] = None,
                 device=None) -> ModelVersion:
        """Add a version. `model` may be a portable artifact directory
        path, a ``portable.PortableModel`` or an already built
        ``workflow.FusedScorer``. ``device`` places it: None loads a
        path onto CUDA (raising without it) and keeps an in-memory
        model on the device it was built for; an explicit device moves
        it there. Warming (one run per bucket) happens HERE — before
        the version can become default — so a later flip is pure
        pointer swap.

        `warm_sample` (one scoreable row is enough) warms with the
        request's own dtypes; without it the fallback warms dense
        columns with float32 zeros and hashed-index columns with int32
        zeros (bucket 0), never turning ids into f32."""
        from ..portable import PortableModel
        from ..workflow import FusedScorer
        with self._lock:
            # RESERVE the name before the (slow) load/warm below: two
            # concurrent registers of the same name must not both pass
            # this check and silently replace each other's version
            if ((name in self._versions
                 and not self._versions[name].released)
                    or name in self._aliases or name in self._pending):
                raise ValueError(f"version {name!r} already registered")
            self._pending.add(name)
        try:
            if isinstance(model, str):
                backend, source = _load_backend(
                    model, buckets=buckets, device=resolve_device(device))
            elif isinstance(model, PortableModel):
                backend = _FusedBackend(
                    model.compile_scoring(buckets=buckets, device=device))
            elif isinstance(model, FusedScorer):
                if device is not None \
                        and resolve_device(device) != model.device:
                    raise ValueError(
                        f"scorer lives on {model.device}, not {device}; "
                        f"register its PortableModel to move it")
                backend = _FusedBackend(model)
            else:
                raise TypeError(f"cannot register {type(model).__name__}")
            v = ModelVersion(name, backend, source=source)
            if warm:
                backend.warm(warm_sample)
                v.warmed = True
            with self._lock:
                self._versions[name] = v
                if make_default or self._default is None:
                    self._default = name
            return v
        finally:
            with self._lock:
                self._pending.discard(name)

    def register_lazy(self, name: str, path: str, *, buckets=True,
                      make_default: bool = False,
                      device=None) -> ModelVersion:
        """Add a version whose artifact loads on FIRST acquire() —
        registry roots carry deploy history, and only versions that
        actually serve should cost startup time and memory. The device
        resolves NOW (None: CUDA, raising without it)."""
        dev = resolve_device(device)
        with self._lock:
            if ((name in self._versions
                 and not self._versions[name].released)
                    or name in self._aliases or name in self._pending):
                raise ValueError(f"version {name!r} already registered")
            v = ModelVersion(
                name, None, source=path,
                loader=lambda: _load_backend(path, buckets=buckets,
                                             device=dev)[0])
            self._versions[name] = v
            if make_default or self._default is None:
                self._default = name
            return v

    def alias(self, name: str, target: str) -> None:
        """Register model id ``name`` as an ALIAS of ``target``: a
        tenant-facing id over an existing version, loading nothing new.
        Requests submitted under different aliases of one version
        resolve to the SAME backend object, which is what lets the
        engine co-batch them into one device dispatch (per-model
        gather/scatter around the shared program). ``target`` may
        itself be an alias (resolved at registration, so chains stay
        one hop deep and cycles are unconstructible)."""
        with self._lock:
            if ((name in self._versions
                 and not self._versions[name].released)
                    or name in self._aliases or name in self._pending):
                raise ValueError(f"version {name!r} already registered")
            self._aliases[name] = self._resolve_locked(target)

    # -- lookup -----------------------------------------------------------
    @property
    def default_version(self) -> Optional[str]:
        with self._lock:
            return self._default

    def versions(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {n: v.info() for n, v in self._versions.items()}

    def aliases(self) -> Dict[str, str]:
        """{alias model id: target version name} — tenant-facing ids
        over shared backends (see :meth:`alias`)."""
        with self._lock:
            return dict(self._aliases)

    def _resolve_locked(self, name: Optional[str]) -> str:
        resolved = name or self._default
        seen = None     # allocated only on an alias hop (hot path:
        #                 direct version names and the default pointer
        #                 resolve with zero allocations)
        while resolved in self._aliases:
            if seen is None:
                seen = set()
            elif resolved in seen:      # defensive: alias() forbids this
                raise ModelNotFound(
                    f"alias cycle at model id {resolved!r}")
            seen.add(resolved)
            resolved = self._aliases[resolved]
        if resolved is None or resolved not in self._versions:
            raise ModelNotFound(f"no such model version: {name!r}")
        return resolved

    def resolve(self, name: Optional[str] = None) -> str:
        """Canonical version name for a model id (follows aliases;
        None = the default). Raises :class:`ModelNotFound` on an
        unknown id — THE loud registry-miss error the engine surfaces
        at submit instead of the old silent default-model scoring."""
        with self._lock:
            return self._resolve_locked(name)

    def get(self, name: Optional[str] = None) -> ModelVersion:
        with self._lock:
            return self._versions[self._resolve_locked(name)]

    def _touch_locked(self, name: str) -> None:
        self._touch_seq += 1
        self._touched[name] = self._touch_seq

    def acquire(self, name: Optional[str] = None) -> "_Lease":
        """Context manager yielding (version_name, backend) with the
        version's in-flight count held — a retire/drain cannot release
        the backend out from under a dispatching batch. For loaded
        versions (the hot path) the name is resolved and the count
        taken under ONE registry lock hold, so a concurrent
        set_default is either fully before or fully after this
        dispatch; a COLD version's load (first use, or a reload after
        LRU eviction) runs outside the registry lock (under its own
        cond, single-flight), so loading catalog history never stalls
        the serving default. Aliases resolve here: the yielded name is
        the CANONICAL version, which is how requests submitted under
        different aliases of one artifact end up co-batchable (same
        backend object). Returns a slotted :class:`_Lease` rather than
        a generator-backed contextmanager: acquire runs once per
        SUBMIT, and the generator frame + contextlib wrapper were
        measurable against the fast request plane's µs budget."""
        with self._lock:
            resolved = self._resolve_locked(name)
            v = self._versions[resolved]
            self._touch_locked(resolved)
            backend = v._try_acquire_loaded()
        if backend is None:
            reload = v.loads > 0
            backend, loaded_now = v._load_and_acquire()
            if loaded_now:
                self._cache_bump("reloads" if reload else "cold_loads")
                self._enforce_cache_limit()
            else:
                self._cache_bump("coalesced_loads")
        return _Lease(resolved, backend, v,
                      v.caps if backend is not None else None)

    def acquire_if_loaded(self, name: Optional[str] = None) -> "_Lease":
        """Like :meth:`acquire` but NEVER loads: yields
        ``(version_name, backend)`` for a warm version, or
        ``(version_name, None)`` when the version is currently cold
        (lazy not-yet-loaded, or LRU-evicted) — the caller decides how
        to proceed without paying an artifact load on ITS thread. The
        engine's dispatcher uses this: an evicted model's queued
        requests score on the backend object they were PREPARED under
        (still alive via the request's own reference — eviction
        changes memory residency, never the model), and the next
        submit's acquire() reloads on a submitting thread, keeping
        multi-second loads off the dispatch hot path for every other
        model and tenant. Released/retired versions still raise."""
        with self._lock:
            resolved = self._resolve_locked(name)
            v = self._versions[resolved]
            self._touch_locked(resolved)
            backend = v._try_acquire_loaded()
        return _Lease(resolved, backend, v if backend is not None
                      else None,
                      v.caps if backend is not None else None)

    def _enforce_cache_limit(self) -> None:
        """Evict least-recently-acquired reloadable versions until the
        loaded population fits ``max_loaded``. The default and any
        version with in-flight batches are skipped (``_evict`` re-checks
        under the version cond); versions registered from in-memory
        models have no loader and can never be evicted — they count
        toward the population but are pinned warm."""
        if self.max_loaded is None:
            return
        while True:
            with self._lock:
                loaded = [n for n, v in self._versions.items()
                          if v.backend is not None and not v.released]
                if len(loaded) <= self.max_loaded:
                    return
                victims = sorted(
                    (n for n in loaded if n != self._default),
                    key=lambda n: self._touched.get(n, 0))
            for n in victims:
                v = self._versions.get(n)
                if v is not None and v._evict():
                    self._cache_bump("evictions")
                    break
            else:
                return      # nothing evictable (all busy/pinned)

    # -- swap -------------------------------------------------------------
    def set_default(self, name: str) -> Optional[str]:
        """Atomic pointer flip; returns the previous default name.
        Aliases resolve (the default pointer always names a CANONICAL
        version, so eviction pinning and rollback flips stay
        unambiguous); an unknown name raises ModelNotFound."""
        with self._lock:
            name = self._resolve_locked(name)
            if self._versions[name].released:
                raise ValueError(f"version {name!r} was released")
            prev, self._default = self._default, name
            return prev

    def retire(self, name: str, drain_timeout: Optional[float] = 30.0
               ) -> bool:
        """Mark a non-default version retired and wait for its in-flight
        batches to drain, then release its backend. Returns False if the
        drain timed out (the version releases itself when the last
        in-flight batch finishes)."""
        with self._lock:
            if name == self._default:
                raise ValueError(
                    f"cannot retire the default version {name!r}; "
                    f"set_default to another version first")
            v = self._versions[name]
            v.retired = True
        return v._drain(drain_timeout)

    def hot_swap(self, name: str, model, *, buckets=True, warm_sample=None,
                 retire_old: bool = True,
                 drain_timeout: Optional[float] = 30.0,
                 device=None) -> Optional[str]:
        """register(warm) -> atomic flip -> drain+release the old
        default. Returns the old default's name. Requests in flight on
        the old version complete; requests dispatched after the flip use
        the new one — zero downtime, warm buckets on the flip."""
        self.register(name, model, buckets=buckets, warm_sample=warm_sample,
                      warm=True, device=device)
        prev = self.set_default(name)
        if prev is not None and prev != name and retire_old:
            self.retire(prev, drain_timeout=drain_timeout)
        return prev

    # -- persistence ------------------------------------------------------
    @staticmethod
    def from_dir(root: str, buckets=True, device=None) -> "ModelRegistry":
        """Build a registry from a directory of version artifacts on
        ``device`` (None: CUDA, raising without it).

        With a `registry.json` manifest (the JAX package's
        portable_export.write_registry_manifest), its version list and
        default are authoritative; otherwise every subdirectory holding
        a portable export is indexed and the lexicographically last
        becomes the default. Only the DEFAULT version loads eagerly —
        deploy history stays lazy (loads on first acquire)."""
        dev = resolve_device(device)
        reg = ModelRegistry()
        man_path = os.path.join(root, "registry.json")
        if os.path.exists(man_path):
            with open(man_path) as f:
                doc = json.load(f)
            if doc.get("format") != 1:
                raise ValueError(
                    f"unsupported registry manifest format "
                    f"{doc.get('format')!r} in {man_path}")
            names = sorted(doc["versions"])
            default = doc.get("default") or (names[-1] if names else None)
            for name in names:
                info = doc["versions"][name]
                path = os.path.join(root, info["path"])
                # the exported bucket set is authoritative for this
                # version unless the caller overrides with an explicit
                # tuple: serving pads to the same bucket shapes the
                # exporter recorded
                vb = (tuple(info["scoreBuckets"])
                      if buckets is True and info.get("scoreBuckets")
                      else buckets)
                if name == default:
                    reg.register(name, path, buckets=vb, warm=False,
                                 device=dev)
                else:
                    reg.register_lazy(name, path, buckets=vb, device=dev)
            if default:
                reg.set_default(default)
            return reg
        entries = [e for e in sorted(os.listdir(root))
                   if os.path.isdir(os.path.join(root, e))
                   and os.path.exists(os.path.join(root, e,
                                                   "manifest.json"))]
        if not entries:
            raise ValueError(f"{root}: no loadable model versions")
        for entry in entries[:-1]:
            reg.register_lazy(entry, os.path.join(root, entry),
                              buckets=buckets, device=dev)
        reg.register(entries[-1], os.path.join(root, entries[-1]),
                     buckets=buckets, warm=False, make_default=True,
                     device=dev)
        return reg


def build_registry(source, *, buckets=True, version: str = "v1",
                   warm_sample=None, warm: bool = True,
                   device=None) -> ModelRegistry:
    """One registry from any serving source — THE shared decision for
    "is this a registry root or a plain model/artifact": a directory
    containing ``registry.json`` loads via :meth:`ModelRegistry.from_dir`
    (its manifest names versions and the default); anything else (a
    portable-export artifact dir, a ``portable.PortableModel`` or a
    built ``FusedScorer``) registers as ``version`` and becomes the
    default. An already built :class:`ModelRegistry` passes through
    unchanged — a whole catalog (versions + aliases)."""
    if isinstance(source, ModelRegistry):
        return source
    if isinstance(source, str) and os.path.exists(
            os.path.join(source, "registry.json")):
        return ModelRegistry.from_dir(source, buckets=buckets,
                                      device=device)
    registry = ModelRegistry()
    registry.register(version, source, buckets=buckets,
                      warm_sample=warm_sample, warm=warm,
                      make_default=True, device=device)
    return registry
