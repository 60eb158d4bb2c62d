"""Learned kernel cost model: shape/config descriptors -> predicted ms.

Counterpart of ``transmogrifai_tpu/autotune/costmodel.py``, with the
same structure (a small feature-based model over analytic work terms,
TpuGraphs-style, which only has to RANK launch configurations) pointed
at the Hopper kernels' own launch choices instead of VMEM blocks:

* the tree histogram (``csrc/tree_histogram.cu`` behind
  ``models.kernels.histogram_grid``): :data:`CONFIG_KEYS` are the sort's
  chunk rows and the reduce pass's grid cap. Each leaves the output
  BITWISE equal to the static launch: the sort is a stable counting
  sort, so its chunking cannot reorder a node's rows; every reduce
  thread sums its own cells in run order. The features a warp of the
  histogram pass owns stay 4: on every shape measured on the card (all
  d = 28) 4 was the fastest, so no choice there was worth a template
  instantiation. The
  knobs that would change the f32 grouping of the sums (``RUN_ROWS`` /
  ``run_rows``, ``TILE_ROWS``, ``HIST_STAGES``) are NOT candidates: the
  port promises that an instance's histogram is the same alone or
  inside any batch (``models/kernels.py``), and the grid-sharded and
  2-D sweeps' bitwise gates rest on that promise;
* the fused serving kernel (``csrc/fused_linear_scores.cu``):
  :data:`SERVE_CONFIG_KEYS` is ``block_rows``, the rows a block covers
  before the grid-stride cap; a warp owns a row, so any grid gives the
  same bits.

Candidate screens run the launch rule itself (``launch_plan``, and on
the card the scorer's C entry through ``launch_blocks_on_card``), so a
candidate is labelled with the config that executes. Everything is DETERMINISTIC: measurements are
canonically sorted before a closed-form ridge solve, and
``choose_config`` breaks prediction ties lexicographically; the static
default is always a candidate.

Artifacts carry their own format tags (``"cuda-1"``,
``"serve-cuda-1"``): a model the JAX package saved (``format: 1`` /
``"serve-1"``, fitted on TPU measurements) is refused, and so is any
measurement keyed by the TPU's launch knobs (``block_n``,
``rows_per_step``, ``double_buffer``, the legacy ``block_<n>_ms``
timings): no TPU-fitted coefficient or TPU measurement can steer a
Hopper launch.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models import kernels as _hist
from ..models import serving_kernels as _serve

#: shape keys, in canonical order (the histogram kernel's signature)
SHAPE_KEYS = ("G", "n", "d", "B", "S", "m")
#: config keys, in canonical order (the kernel's bitwise launch choices)
CONFIG_KEYS = ("sort_chunk_rows", "reduce_blocks")

#: the static launch the kernel runs when the autotuner is off — always
#: a candidate (as executed), so the chooser never predicts worse
STATIC_DEFAULT_CONFIG = dict(_hist.STATIC_LAUNCH_CONFIG)

#: the TPU package's launch knobs: a measurement or artifact keyed by
#: them was taken on a TPU and is refused
TPU_CONFIG_KEYS = ("block_n", "rows_per_step", "double_buffer")

#: candidate values besides the static ones
SORT_CHUNK_MIN = 256
REDUCE_BLOCKS_CHOICES = (_hist.REDUCE_BLOCKS // 4, _hist.REDUCE_BLOCKS,
                         _hist.REDUCE_BLOCKS * 4)

#: artifact format tags (the JAX package's are 1 and "serve-1")
FORMAT = "cuda-1"
SERVE_FORMAT = "serve-cuda-1"
_JAX_FORMATS = {1: "KernelCostModel", "serve-1": "ServingCostModel"}


def shape_key(shape: Dict[str, int]) -> Tuple[int, ...]:
    """Canonical hashable form of a shape dict (KeyError on missing).
    A launch over per-instance bins (``Gbins`` > 1 binned matrices) adds
    ``Gbins`` to the key, so no decision for a shared-bins shape (the
    six keys alone) is ever reused for it."""
    key = tuple(int(shape[k]) for k in SHAPE_KEYS)
    gbins = int(shape.get("Gbins", 1))
    return key if gbins == 1 else key + (gbins,)


def _gbins(shape: Dict[str, int]) -> int:
    return int(shape.get("Gbins", 1))


def _check_config_keys(config: Dict[str, Any], keys: Sequence[str],
                       what: str) -> None:
    """Raise when ``config`` is keyed by anything but ``keys`` — naming
    the foreign keys, and saying so when they are the TPU's."""
    foreign = sorted(set(config) - set(keys))
    if foreign:
        tpu = [k for k in foreign if k in TPU_CONFIG_KEYS]
        raise ValueError(
            f"{what} config keyed by {foreign}, not this port's "
            f"{list(keys)}" + (f": {tpu} are the TPU kernels' launch "
                               f"knobs, and a TPU measurement cannot steer "
                               f"a Hopper launch" if tpu else ""))


def config_key(config: Dict[str, Any]) -> Tuple[int, ...]:
    """Canonical sortable form of a config dict — the deterministic
    tie-break order for choose_config (a missing key is its static
    value; a foreign key raises)."""
    _check_config_keys(config, CONFIG_KEYS, "histogram")
    return tuple(int(config.get(k, STATIC_DEFAULT_CONFIG[k]))
                 for k in CONFIG_KEYS)


def _plan(shape: Dict[str, int], config: Dict[str, Any]
          ) -> Optional[Dict[str, int]]:
    """``launch_plan`` of the shape under ``config`` — the launch rule
    itself, so the screen cannot drift from it — or None when the
    kernel would refuse it."""
    G, n, d, B, S, m = shape_key(shape)[:6]
    try:
        return _hist.launch_plan(G, n, d, S, m, B, config, _gbins(shape))
    except ValueError:
        return None


def executed_config(shape: Dict[str, int],
                    config: Dict[str, Any]) -> Dict[str, int]:
    """``config`` as the kernel runs it at ``shape``: a sort chunk of at
    least n rows is one chunk of n rows, and a reduce cap above the
    blocks the pass needs is the blocks it needs."""
    G, n, d, B, S, m = shape_key(shape)[:6]
    cfg = dict(STATIC_DEFAULT_CONFIG, **config)
    config_key(cfg)
    need = max(1, -(-G * m * S * d * B // 256))
    return {"sort_chunk_rows": min(int(cfg["sort_chunk_rows"]), max(n, 1)),
            "reduce_blocks": min(int(cfg["reduce_blocks"]), need)}


def candidate_configs(shape: Dict[str, int], *,
                      max_block: int = 4096) -> List[Dict[str, Any]]:
    """The deterministic candidate set the chooser ranks: power-of-two
    sort chunks from SORT_CHUNK_MIN up to ``max_block`` and three
    reduce caps, each as executed
    (:func:`executed_config`; equal executions dedupe) and screened by
    the launch rule. The static default as executed is ALWAYS included,
    so argmin can never leave the chooser worse than the static
    launch."""
    chunks = []
    c = SORT_CHUNK_MIN
    while c <= max_block:
        chunks.append(c)
        c *= 2
    seen = set()
    cands: List[Dict[str, Any]] = []
    raw = [{"sort_chunk_rows": ch, "reduce_blocks": rb}
           for ch in chunks for rb in REDUCE_BLOCKS_CHOICES]
    raw.append(dict(STATIC_DEFAULT_CONFIG))
    for cfg in raw:
        ex = executed_config(shape, cfg)
        key = config_key(ex)
        if key in seen or _plan(shape, ex) is None:
            continue
        seen.add(key)
        cands.append(ex)
    return sorted(cands, key=config_key)


#: feature names, fixed order — serialized with the model so a loaded
#: model refuses feature-set drift instead of silently mispredicting
FEATURE_NAMES = ("const", "sort_blocks_k", "sort_chunk_krows",
                 "hist_warps_m", "mma_m", "hbm_gbytes", "partial_gfloats",
                 "reduce_grid_k", "reduce_passes")


def featurize(shape: Dict[str, int], config: Dict[str, Any]) -> np.ndarray:
    """Analytic work terms of one (shape, config) launch of the Hopper
    histogram kernel:

    * ``sort_blocks_k`` / ``sort_chunk_krows``: the sort's blocks (G x
      chunks) and the rows one scatter warp walks in order;
    * ``hist_warps_m``: the histogram pass's warps (blocks x warps from
      ``launch_plan``);
    * ``mma_m`` / ``hbm_gbytes``: the tensor-core ``mma`` count
      (millions) and the bytes one call must move (``histogram_cost``);
    * ``partial_gfloats``: the partial floats the reduce pass reads;
    * ``reduce_grid_k`` / ``reduce_passes``: its grid and each thread's
      grid-stride passes.
    """
    G, n, d, B, S, m = shape_key(shape)[:6]
    ex = executed_config(shape, config)
    plan = _hist.launch_plan(G, n, d, S, m, B, ex, _gbins(shape))
    cost = _hist.histogram_cost(G, n, d, S, m, B, _gbins(shape))
    cells = G * m * S * d * B
    grid = plan["reduce_grid"]
    return np.array([
        1.0, G * plan["sort_chunks"] / 1e3, plan["sort_chunk_rows"] / 1e3,
        plan["blocks"] * plan["warps"] / 1e6, cost["mma"] / 1e6,
        cost["bytes"] / 1e9, plan["partial_floats"] / 1e9, grid / 1e3,
        float(math.ceil(max(cells, 1) / (grid * 256)))], dtype=np.float64)


def _canon_measurement(rec: Dict[str, Any]) -> Tuple:
    return (shape_key(rec["shape"]), config_key(rec["config"]),
            float(rec["ms"]), float(rec.get("weight", 1.0)))


def _ridge(X: np.ndarray, y: np.ndarray, w: np.ndarray,
           ridge: float) -> np.ndarray:
    """Closed-form weighted ridge solve: a measurement of weight w enters
    the normal equations scaled by sqrt(w)."""
    if np.any(w < 0):
        raise ValueError("measurement weights must be >= 0")
    sw = np.sqrt(w)[:, None]
    Xw, yw = X * sw, y * sw[:, 0]
    return np.linalg.solve(Xw.T @ Xw + ridge * np.eye(X.shape[1]),
                           Xw.T @ yw)


def _check_artifact(doc: Dict[str, Any], fmt: str,
                    features: Sequence[str], what: str) -> None:
    got = doc.get("format")
    if got != fmt:
        jax_kind = _JAX_FORMATS.get(got) if isinstance(got, (int, str)) \
            else None
        if jax_kind is not None:
            raise ValueError(
                f"{what} artifact has format {got!r}: a JAX-package "
                f"{jax_kind}, fitted on TPU measurements of VMEM blocks; "
                f"this port's {what} takes format {fmt!r} (refit it on "
                f"the card's own launch measurements)")
        raise ValueError(f"unsupported {what} format {got!r} (expected "
                         f"{fmt!r})")
    if tuple(doc.get("features", ())) != tuple(features):
        raise ValueError(
            f"{what} feature set drifted: artifact has "
            f"{doc.get('features')!r}, this build expects "
            f"{list(features)!r}")


class _RidgeModel:
    """The shared half of both cost models: a ridge-regressed linear
    model over a fixed featurizer, fitted over canonically SORTED
    measurements (closed form, no iteration, no seed), so identical
    measurement sets in any order give bit-identical coefficients and
    therefore identical ``choose_config`` answers."""

    FORMAT = ""
    FEATURES: Tuple[str, ...] = ()
    WHAT = ""

    def __init__(self, coef: Optional[np.ndarray] = None,
                 n_measurements: int = 0):
        self.coef = None if coef is None else np.asarray(coef, np.float64)
        self.n_measurements = int(n_measurements)

    # subclasses: the featurizer, the canonical sort key, the candidates
    _featurize: Callable
    _canon: Callable
    _candidates: Callable
    _config_key: Callable

    @classmethod
    def fit(cls, measurements: Sequence[Dict[str, Any]],
            ridge: float = 1e-3):
        if not measurements:
            raise ValueError(
                f"cannot fit a {cls.WHAT} on zero measurements")
        rows = sorted(measurements, key=cls._canon)
        X = np.stack([cls._featurize(r["shape"], r["config"]) for r in rows])
        y = np.array([float(r["ms"]) for r in rows], np.float64)
        w = np.array([float(r.get("weight", 1.0)) for r in rows],
                     np.float64)
        return cls(coef=_ridge(X, y, w, ridge), n_measurements=len(rows))

    def predict_ms(self, shape: Dict[str, int],
                   config: Dict[str, Any]) -> float:
        if self.coef is None:
            raise ValueError(f"{self.WHAT} is not fitted")
        return float(type(self)._featurize(shape, config) @ self.coef)

    def choose_config(self, shape: Dict[str, int],
                      candidates: Optional[Sequence[Dict[str, Any]]] = None,
                      **screen) -> Tuple[Dict[str, Any], float]:
        """(best config, predicted ms) over the candidate set, argmin of
        predicted ms with a LEXICOGRAPHIC tie-break on the config key —
        fully deterministic given the coefficients. The static default
        is always in the set, so the choice is never predicted slower
        than the static launch."""
        if candidates is None:
            candidates = type(self)._candidates(shape, **screen)
        key = type(self)._config_key
        scored = sorted(((self.predict_ms(shape, c), key(c), c)
                         for c in candidates), key=lambda t: (t[0], t[1]))
        best_ms, _, best = scored[0]
        return dict(best), best_ms

    def to_json(self) -> Dict[str, Any]:
        return {"format": self.FORMAT, "features": list(self.FEATURES),
                "coef": [float(c) for c in self.coef],
                "n_measurements": self.n_measurements}

    @classmethod
    def from_json(cls, doc: Dict[str, Any]):
        _check_artifact(doc, cls.FORMAT, cls.FEATURES, cls.WHAT)
        return cls(coef=np.asarray(doc["coef"], np.float64),
                   n_measurements=int(doc.get("n_measurements", 0)))

    def save(self, path: str) -> None:
        from ..resilience import atomic
        atomic.atomic_write_json(path, self.to_json())

    @classmethod
    def load(cls, path: str):
        with open(path) as f:
            return cls.from_json(json.load(f))


class KernelCostModel(_RidgeModel):
    """Ridge-regressed linear cost model of the Hopper histogram kernel
    over :func:`featurize` terms (artifact format ``"cuda-1"``)."""

    FORMAT = FORMAT
    FEATURES = FEATURE_NAMES
    WHAT = "cost model"
    _featurize = staticmethod(featurize)
    _canon = staticmethod(_canon_measurement)
    _candidates = staticmethod(candidate_configs)
    _config_key = staticmethod(config_key)


# ---------------------------------------------------------------------------
# measurement harvesting (the training-data loaders)
# ---------------------------------------------------------------------------

_TPU_TUNE_KEY_RE = re.compile(r"^block_(\d+)(_sub_(\d+))?_ms$")


def _structured(record: Dict[str, Any], keys: Sequence[str],
                what: str) -> List[Dict[str, Any]]:
    """The structured ``measurements`` of one bench result: entries
    with a ``skipped`` marker dropped, every config's keys checked (a
    TPU-keyed one raises), an optional ``weight`` carried through. A
    record that names its backend must name ``cuda`` (the JAX bench's
    records name ``tpu`` or ``cpu``; its serving sweep's ``block_rows``
    is a VMEM row block, not this kernel's)."""
    backend = record.get("backend")
    if backend is not None and backend != "cuda":
        raise ValueError(
            f"{what} tune record measured on backend {backend!r}, not "
            f"'cuda': a measurement of another device cannot steer a "
            f"Hopper launch")
    out: List[Dict[str, Any]] = []
    for entry in record.get("measurements") or ():
        if not isinstance(entry, dict) or entry.get("skipped"):
            continue
        if "shape" in entry and "config" in entry and "ms" in entry:
            _check_config_keys(entry["config"], keys, what)
            m = {"shape": dict(entry["shape"]),
                 "config": dict(entry["config"]),
                 "ms": float(entry["ms"])}
            if "weight" in entry:
                m["weight"] = float(entry["weight"])
            out.append(m)
    return out


def measurements_from_tune_record(record: Dict[str, Any]
                                  ) -> List[Dict[str, Any]]:
    """Harvest training measurements from one ``kernel_autotune`` or
    ``hist_block_tune`` bench result: the structured ``measurements``
    list (entries with a ``skipped`` marker dropped, no prose parsed).
    A measurement keyed by the TPU's launch knobs raises, naming them,
    and so does a record carrying the TPU sweep's legacy
    ``block_<n>[_sub_<k>]_ms`` timings."""
    legacy = sorted(k for k in record if _TPU_TUNE_KEY_RE.match(k))
    if legacy:
        raise ValueError(
            f"tune record carries TPU block timings {legacy} (the JAX "
            f"package's block_n / rows_per_step sweep); a TPU measurement "
            f"cannot steer a Hopper launch")
    return _structured(record, CONFIG_KEYS, "histogram")


def _section_entries(capture: Dict[str, Any],
                     names: Sequence[str]) -> List[Dict[str, Any]]:
    """The ok results of the named sections of a BENCH_CAPTURE-style
    state dict, then their ``_history`` entries in sorted order."""
    entries = []
    for name in names:
        ent = capture.get(name)
        if isinstance(ent, dict):
            entries.append(ent)
        for key, hist in sorted((capture.get("_history") or {}).items()):
            if key.startswith(name + "@") and isinstance(hist, dict):
                entries.append(hist)
    return [e["result"] for e in entries
            if e.get("ok") and isinstance(e.get("result"), dict)]


def measurements_from_capture(capture: Dict[str, Any]
                              ) -> List[Dict[str, Any]]:
    """Harvest every histogram measurement out of a capture state dict:
    the ``kernel_autotune`` and ``hist_block_tune`` sections and their
    ``_history`` entries. The repo's ``BENCH_CAPTURE.json`` holds TPU
    sweeps, so it raises (see :func:`measurements_from_tune_record`)."""
    out: List[Dict[str, Any]] = []
    for res in _section_entries(capture, ("kernel_autotune",
                                          "hist_block_tune")):
        out.extend(measurements_from_tune_record(res))
    return out


# ---------------------------------------------------------------------------
# serving-kernel cost model (fused cross-model scoring)
# ---------------------------------------------------------------------------
# The same recipe pointed at csrc/fused_linear_scores.cu: shape = the
# fused launch signature (model count, request rows, feature width,
# label width), config = the rows a block covers before the grid-stride
# cap. Measurements may carry a ``weight`` (e.g. from the engine's
# observed batch-shape mix), which the fit honours.

#: fused serving-kernel shape keys, canonical order
SERVE_SHAPE_KEYS = ("K", "n", "p", "L")
#: fused serving-kernel config keys, canonical order
SERVE_CONFIG_KEYS = ("block_rows",)

#: the static launch (one row a warp): always a candidate, as executed
SERVE_STATIC_DEFAULT_CONFIG = dict(_serve.STATIC_LAUNCH_CONFIG)


def serve_shape_key(shape: Dict[str, int]) -> Tuple[int, ...]:
    """Canonical hashable form of a fused-serving shape dict."""
    return tuple(int(shape[k]) for k in SERVE_SHAPE_KEYS)


def serve_config_key(config: Dict[str, Any]) -> Tuple[int, ...]:
    """Canonical sortable form — the deterministic tie-break order."""
    _check_config_keys(config, SERVE_CONFIG_KEYS, "fused serving")
    return (int(config.get("block_rows",
                           SERVE_STATIC_DEFAULT_CONFIG["block_rows"])),)


def serve_grid(shape: Dict[str, int], config: Dict[str, Any]) -> int:
    """The grid a config asks for at ``shape`` before the C entry's
    occupancy cap: ceil(n / block_rows) blocks."""
    return max(1, -(-int(shape["n"]) // int(config["block_rows"])))


def serve_candidate_configs(shape: Dict[str, int], *,
                            max_block: int = 4096,
                            grid: Optional[Callable[[int], int]] = None
                            ) -> List[Dict[str, Any]]:
    """Deterministic candidate row blocks: the static one and powers of
    two from 16 up to ``max_block``, screened by the launch rule
    (``launch_config``) and deduped by the grid each executes (the
    smallest block of each grid names it). ``grid`` maps a
    ``block_rows`` to the blocks the launch runs; on the card it is the
    C entry's own answer (``launch_blocks_on_card``), without it the grid
    before the cap (:func:`serve_grid`)."""
    blocks = [SERVE_STATIC_DEFAULT_CONFIG["block_rows"]]
    b = 2 * blocks[0]
    while b <= max_block:
        blocks.append(b)
        b *= 2
    cands: List[Dict[str, Any]] = []
    seen = set()
    for br in sorted(set(blocks)):
        cfg = {"block_rows": br}
        try:
            _serve.launch_config(cfg)
        except ValueError:
            continue
        blocks = (serve_grid(shape, cfg) if grid is None
                  else int(grid(br)))
        if blocks in seen:
            continue
        seen.add(blocks)
        cands.append(cfg)
    return cands


#: fused serving feature names, fixed order (serialized with the model)
SERVE_FEATURE_NAMES = ("const", "blocks_k", "rows_per_warp",
                       "products_g", "hbm_gbytes", "staged_w_gbytes",
                       "models")


def serve_featurize(shape: Dict[str, int],
                    config: Dict[str, Any]) -> np.ndarray:
    """Analytic work terms of one fused (shape, config) launch: the
    blocks of the grid before the cap and the rows a warp takes in
    order, the rows x (p+1) x L products, the bytes one launch must
    move (``fused_prefix_cost``, identity form), and the bytes the
    blocks stage (each block copies W into shared memory once)."""
    K, n, p, L = serve_shape_key(shape)
    serve_config_key(config)
    br = int(config["block_rows"])
    blocks = serve_grid(shape, config)
    cost = _serve.fused_prefix_cost(n, p, p, K, L, L)
    staged = blocks * 4.0 * K * (p + 1) * L
    return np.array([1.0, blocks / 1e3, br / _serve.WARPS_PER_BLOCK,
                     n * (p + 1) * L / 1e9, cost["bytes"] / 1e9,
                     staged / 1e9, float(K)], dtype=np.float64)


def _canon_serve_measurement(rec: Dict[str, Any]) -> Tuple:
    return (serve_shape_key(rec["shape"]), serve_config_key(rec["config"]),
            float(rec["ms"]), float(rec.get("weight", 1.0)))


class ServingCostModel(_RidgeModel):
    """Ridge-regressed linear cost model of the fused serving kernel over
    :func:`serve_featurize` terms (artifact format ``"serve-cuda-1"``),
    with optional per-measurement WEIGHTS: a measurement carrying
    ``weight: w`` enters the normal equations scaled by sqrt(w)."""

    FORMAT = SERVE_FORMAT
    FEATURES = SERVE_FEATURE_NAMES
    WHAT = "serving cost model"
    _featurize = staticmethod(serve_featurize)
    _canon = staticmethod(_canon_serve_measurement)
    _candidates = staticmethod(serve_candidate_configs)
    _config_key = staticmethod(serve_config_key)


def serve_measurements_from_tune_record(record: Dict[str, Any]
                                        ) -> List[Dict[str, Any]]:
    """Harvest fused-serving training measurements from one
    ``fused_serving`` bench result: the structured ``measurements``
    list (skips dropped, an optional ``weight`` carried through, a
    foreign config key raising)."""
    return _structured(record, SERVE_CONFIG_KEYS, "fused serving")


def serve_measurements_from_capture(capture: Dict[str, Any]
                                    ) -> List[Dict[str, Any]]:
    """Harvest every fused-serving measurement out of a capture state
    dict: the ``fused_serving`` section and its ``_history`` entries."""
    out: List[Dict[str, Any]] = []
    for res in _section_entries(capture, ("fused_serving",)):
        out.extend(serve_measurements_from_tune_record(res))
    return out
