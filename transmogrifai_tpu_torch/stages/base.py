"""Stage framework: typed Estimator/Transformer bases by arity (the
port's copy of ``transmogrifai_tpu/stages/base.py``).

Reference: core/src/main/scala/com/salesforce/op/stages/
(OpPipelineStage.scala, base/{unary,binary,ternary,quaternary,sequence}/,
OpTransformer.scala). Stages are pure: an Estimator's `fit` consumes a
Dataset and returns a fitted Transformer (the "model"); a Transformer's
`transform` appends one output column. Fitted parameters are plain
JSON-able values plus numpy arrays (serialized by stages.persistence);
a model stage's fitted tensors persist as numpy arrays too.

The port adds two things to the JAX package's protocol:

* **Column-name wiring.** A fitted stage built from a portable artifact
  (``portable.from_portable``) has no feature DAG around it: it is
  constructed with keyword params and wired to plain column names with
  :meth:`PipelineStage.wire`.
* **A device per stage.** ``make_device_fn()`` returns a plain function
  on tensors (None for host-only stages); :meth:`Transformer.to` moves a
  fitted stage's tensors to a device (``WorkflowModel.to``,
  ``compile_scoring(device=...)``), and an estimator that fits on a
  device carries a transient ``device`` attribute that
  ``Workflow.train(device=...)`` sets.

Class keys (:func:`stage_class_key`) are the JAX package's: a class of
``transmogrifai_tpu_torch.<module>`` persists as
``transmogrifai_tpu.<module>.<Class>``, so a model saved by either
package loads in the other. :func:`resolve_stage_class` maps such a key
back to the port's module and never imports the JAX package (every
module of the JAX package that defines a stage class has its port).

Local-scoring parity: `make_row_fn()` mirrors the reference's OpTransformer
row function (transformKeyValue) — a Map->value function requiring no
workflow machinery. The workflow's scoring fast-path composes these.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from ..dataset import Dataset, column_to_numpy
from ..features import types as ft
from ..features.feature import Feature, TransientFeature, make_uid

STAGE_REGISTRY: Dict[str, Any] = {}

_AMBIGUOUS = object()  # sentinel: bare class name clashes; qualified key required


#: the JAX package's name, which every persisted class key carries
REFERENCE_PACKAGE = "transmogrifai_tpu"
PORT_PACKAGE = "transmogrifai_tpu_torch"


def stage_class_key(cls: type) -> str:
    """Module-qualified class key, in the JAX package's namespace for
    the port's own classes (so either package loads the other's
    artifacts)."""
    mod = cls.__module__
    if mod == PORT_PACKAGE or mod.startswith(PORT_PACKAGE + "."):
        mod = REFERENCE_PACKAGE + mod[len(PORT_PACKAGE):]
    return f"{mod}.{cls.__qualname__}"


def _port_module(module: str) -> str:
    """A saved key's module -> the port module that defines it (keys of
    either package's namespace map to the port's)."""
    for pkg in (PORT_PACKAGE, REFERENCE_PACKAGE):
        if module == pkg or module.startswith(pkg + "."):
            return PORT_PACKAGE + module[len(pkg):]
    return module


def resolve_stage_class(name: str) -> Type["PipelineStage"]:
    cls = STAGE_REGISTRY.get(name)
    if cls is None and "." in name:
        # module-qualified name from a saved artifact: registration is a
        # class-definition side effect, so import the defining PORT
        # module and retry (a key naming the JAX package resolves to
        # the port's module of the same path; the JAX package itself is
        # never imported)
        import importlib
        module, qual = name.rsplit(".", 1)
        port_mod = _port_module(module)
        rel = port_mod[len(PORT_PACKAGE) + 1:] \
            if port_mod.startswith(PORT_PACKAGE + ".") else None
        try:
            importlib.import_module(port_mod)
        except ImportError:
            pass        # fall through to the unknown-class error below
        key = (REFERENCE_PACKAGE + port_mod[len(PORT_PACKAGE):]
               if rel is not None or port_mod == PORT_PACKAGE
               else port_mod) + "." + qual
        cls = STAGE_REGISTRY.get(key)
    if cls is _AMBIGUOUS:
        raise ValueError(f"stage class name {name!r} is ambiguous — "
                         f"use its module-qualified name")
    if cls is None:
        raise ValueError(f"unknown stage class {name!r} — import its "
                         f"module before loading")
    return cls


class PipelineStage:
    """Base pipeline stage: params + input wiring + one output feature."""

    #: expected FeatureType (base) per input; Sequence stages use in_type
    in_types: Tuple[Type[ft.FeatureType], ...] = ()
    #: output feature type
    out_type: Type[ft.FeatureType] = ft.FeatureType
    #: short operation name used in derived feature names
    operation_name: str = "stage"
    #: what the training executor does when this stage's fit exhausts
    #: its retry budget: "fail" (default) aborts the train with the
    #: stage's error; "degrade" SKIPS the stage — its output is dropped
    #: from the remaining plan (prune_layers cascade) and the train
    #: completes with a ``train_summaries["degraded"]`` record. Only
    #: advisory stages (sensitive-feature analyzers, optional
    #: enrichments feeding variadic combiners) should degrade; the
    #: opcheck linter flags a degrade-marked output that a model
    #: consumes non-optionally (TM-LINT-010).
    failure_policy: str = "fail"

    def __init__(self, uid: Optional[str] = None, **params: Any):
        self.uid = uid or make_uid(type(self).__name__)
        self.params: Dict[str, Any] = dict(params)
        self.inputs: Tuple[TransientFeature, ...] = ()
        self._output: Optional[Feature] = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        # Qualified key prevents collisions (e.g. every estimator's nested
        # `Model` class); bare name kept as an alias only while unambiguous.
        STAGE_REGISTRY[stage_class_key(cls)] = cls
        if STAGE_REGISTRY.setdefault(cls.__name__, cls) is not cls:
            STAGE_REGISTRY[cls.__name__] = _AMBIGUOUS

    # -- wiring ----------------------------------------------------------
    def check_input_types(self, features: Sequence[Feature]) -> None:
        if self.in_types and len(self.in_types) != len(features):
            raise TypeError(
                f"{type(self).__name__} takes {len(self.in_types)} inputs, "
                f"got {len(features)}")
        expected = self.in_types or ((self.in_type,) * len(features)
                                     if hasattr(self, "in_type") else ())
        for f, t in zip(features, expected):
            if not issubclass(f.wtype, t):
                raise TypeError(
                    f"{type(self).__name__} input {f.name!r}: expected "
                    f"{t.__name__}, got {f.wtype.__name__}")

    def with_failure_policy(self, policy: str) -> "PipelineStage":
        """Opt this stage instance into a training failure policy
        ("fail" | "degrade"); see the class attribute for semantics."""
        from ..resilience.policy import FAILURE_POLICIES
        if policy not in FAILURE_POLICIES:
            raise ValueError(f"unknown failure_policy {policy!r}; one of "
                             f"{FAILURE_POLICIES}")
        self.failure_policy = policy
        return self

    def set_input(self, *features: Feature) -> "PipelineStage":
        self.check_input_types(features)
        self.inputs = tuple(TransientFeature.of(f) for f in features)
        self._output = Feature(
            name=self.make_output_name(features),
            wtype=self.output_type(features),
            origin_stage=self,
            parents=features,
            is_response=self.output_is_response(features),
        )
        return self

    def output_type(self, features: Sequence[Feature]) -> Type[ft.FeatureType]:
        return self.out_type

    def output_is_response(self, features: Sequence[Feature]) -> bool:
        return False

    def make_output_name(self, features: Sequence[Feature]) -> str:
        base = "-".join(f.name for f in features[:4]) or "f"
        return f"{base}_{self.operation_name}_{self.uid.split('_')[-1]}"

    @property
    def output(self) -> Feature:
        if self._output is None:
            raise RuntimeError(f"{type(self).__name__}.set_input not called")
        return self._output

    def get_output(self) -> Feature:
        return self.output

    def wire(self, input_names: Sequence[str],
             output_name: str) -> "PipelineStage":
        """Wire the stage to plain column names (a stage loaded from a
        portable artifact, which carries no feature DAG)."""
        self.inputs = tuple(TransientFeature(str(n), ft.FeatureType)
                            for n in input_names)
        self._output = Feature(name=str(output_name), wtype=self.out_type,
                               origin_stage=self)
        return self

    @property
    def input_names(self) -> List[str]:
        return [f.name for f in self.inputs]

    @property
    def output_name(self) -> str:
        return self.output.name

    # -- persistence hooks (stages.persistence drives these) -------------
    def stage_params_json(self) -> Dict[str, Any]:
        return dict(self.params)

    def __repr__(self):
        return f"{type(self).__name__}(uid={self.uid})"


class Transformer(PipelineStage):
    """A stage that maps a Dataset to a Dataset (appends its output
    column). ``Transformer(input_names, output_name, **params)`` builds
    a stage wired to plain column names (see :meth:`wire`)."""

    #: the device the stage's tensors live on (transient, never
    #: persisted): None for host-only stages and for device functions
    #: that hold no tensors of their own (they run wherever their
    #: inputs lie)
    device = None

    def __init__(self, input_names: Optional[Sequence[str]] = None,
                 output_name: Optional[str] = None, *,
                 uid: Optional[str] = None, **params: Any):
        super().__init__(uid=uid, **params)
        if output_name is not None:
            self.wire(input_names or (), output_name)

    def to(self, device) -> "Transformer":
        """Move the stage's fitted tensors to ``device`` (in place;
        returns the stage). Host-only stages just record it."""
        import torch
        self.device = torch.device(device)
        return self

    def transform(self, ds: Dataset) -> Dataset:
        arr, otype, manifest = self._transform_columns(ds)
        return ds.with_column(self.output.name, arr, otype, manifest=manifest)

    # -- default implementations -----------------------------------------
    def _transform_columns(self, ds: Dataset):
        """Bulk transform. Default: row loop over `transform_value`.

        Vectorized/device stages override this with numpy/torch compute.
        Returns (column_array, output_type, manifest_or_None).
        """
        names = self.input_names
        in_types = [ds.ftype(n) for n in names]
        cols = [ds.pycolumn(n) for n in names]  # one vectorized pass each
        fn = self.transform_value
        out: List[Any] = []
        for row in zip(*cols):
            res = fn(*[t(v) for t, v in zip(in_types, row)])
            out.append(res.value if isinstance(res, ft.FeatureType) else res)
        otype = self.output.wtype
        return column_to_numpy(out, otype), otype, None

    def transform_value(self, *values: ft.FeatureType):
        raise NotImplementedError(
            f"{type(self).__name__} must implement transform_value or "
            f"_transform_columns")

    # -- fused device scoring (reference: OpTransformer collapse) ---------
    def make_device_fn(self) -> Optional[Callable]:
        """Return a plain fn(*input_tensors) -> output_tensor operating on
        whole device columns, or None when the stage is host-only.

        The workflow's FusedScorer composes the maximal device-able stage
        suffix into ONE function run on its device (the reference
        collapses contiguous OpTransformer row fns into one DataFrame
        pass). Contract: the fn must produce the same values as
        `_transform_columns` for float inputs; response-typed inputs may
        arrive as zero placeholders at scoring time and must be ignored.
        """
        return None

    #: True when `transform` has a side effect on the stage itself
    #: (e.g. VectorsCombiner caching its concatenated manifest for
    #: persistence). The training executor's lifetime pruning may skip
    #: the transform of an output no later stage consumes — but never
    #: for these stages, whose skipped side effect would change the
    #: saved artifact. The opcheck linter (lint/ast_checks.py) flags
    #: transforms that cache on self WITHOUT this marker as
    #: TM-LINT-202; mutation in `transform_value` is always a defect
    #: (TM-LINT-201 — the row path runs concurrently under the serving
    #: engine regardless of this marker).
    transform_caches_state = False

    #: True only when make_device_fn's float32 outputs are BITWISE
    #: identical to `_transform_columns`' float32 results (selection-only
    #: ops like impute/indicator/concat — not transcendental math). Such
    #: stages are eligible for the training executor's fused per-layer
    #: device transform block (executor.py), which must not perturb what
    #: downstream estimators fit on.
    device_fn_exact = False

    def device_fn_signature(self):
        """Hashable signature that fully determines make_device_fn's
        computation, or None. Required for train-time fusion: the
        executor caches the composed layer block by the group's
        signatures (the JAX package's program-cache key)."""
        return None

    def portable_spec(self):
        """IR node for the portable runtime (portable_export.py), or
        None when the stage has no portable encoding. Contract: the spec
        op + arrays must reproduce make_device_fn's values in numpy f32
        (the export round-trip test pins this)."""
        return None

    # -- local scoring row function (reference: OpTransformer) ------------
    def make_row_fn(self) -> Callable[[Dict[str, Any]], Any]:
        names = self.input_names
        types = [f.wtype for f in self.inputs]
        resps = [f.is_response for f in self.inputs]
        out_name = self.output.name

        def coerce(t: Type[ft.FeatureType], v: Any, is_resp: bool):
            # Scoring-time rows carry no response values; stages that take
            # the label as an input (model stages) ignore it at transform
            # time, so substitute a neutral placeholder instead of failing
            # non-nullable validation (reference: OpTransformer scores
            # label-free rows).
            if v is None and is_resp:
                try:
                    return t(None)
                except ft.FeatureTypeError:
                    return t(0)
            return t(v)

        def row_fn(row: Dict[str, Any]) -> Any:
            vals = [coerce(t, row.get(n), r)
                    for n, t, r in zip(names, types, resps)]
            res = self.transform_value(*vals)
            return res.value if isinstance(res, ft.FeatureType) else res

        row_fn.output_name = out_name
        return row_fn


class Estimator(PipelineStage):
    """A stage whose `fit` learns parameters and yields a Transformer."""

    #: Transformer class instantiated by default `fit`
    model_cls: Optional[Type[Transformer]] = None

    def fit(self, ds: Dataset) -> Transformer:
        model_args = self.fit_fn(ds)
        model = self._make_model(model_args)
        return model

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        raise NotImplementedError

    def _make_model(self, model_args: Dict[str, Any]) -> Transformer:
        if self.model_cls is None:
            raise NotImplementedError(f"{type(self).__name__} needs model_cls")
        model = self.model_cls(uid=self.uid + "_model", **model_args)
        # precedence: fit_fn results > estimator params > model-class
        # defaults. Filtering on `k not in model.params` instead silently
        # dropped any user setting whose name the model DEFAULTS (e.g.
        # DateListVectorizerEstimator(pivot="mode_day") fit "since")
        model.params.update({k: v for k, v in self.params.items()
                             if k not in model_args})
        # share wiring: the model emits the estimator's output feature
        model.inputs = self.inputs
        model._output = self._output
        return model

    def fit_transform(self, ds: Dataset) -> Tuple[Transformer, Dataset]:
        m = self.fit(ds)
        return m, m.transform(ds)


# ---------------------------------------------------------------------------
# Typed arities (reference: stages/base/{unary,binary,...}/)
# ---------------------------------------------------------------------------

class UnaryTransformer(Transformer):
    in_type: Type[ft.FeatureType] = ft.FeatureType

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if "in_type" in cls.__dict__ or not cls.in_types:
            cls.in_types = (cls.in_type,)


class BinaryTransformer(Transformer):
    in_types = (ft.FeatureType, ft.FeatureType)


class TernaryTransformer(Transformer):
    in_types = (ft.FeatureType, ft.FeatureType, ft.FeatureType)


class QuaternaryTransformer(Transformer):
    in_types = (ft.FeatureType,) * 4


class SequenceTransformer(Transformer):
    """Variadic inputs of one type (reference: base/sequence/)."""
    in_type: Type[ft.FeatureType] = ft.FeatureType
    in_types = ()  # variadic

    def check_input_types(self, features):
        for f in features:
            if not issubclass(f.wtype, self.in_type):
                raise TypeError(
                    f"{type(self).__name__} input {f.name!r}: expected "
                    f"{self.in_type.__name__}, got {f.wtype.__name__}")


class BinarySequenceTransformer(Transformer):
    """One fixed input plus a variadic tail (reference: base/binary sequence)."""
    in_type1: Type[ft.FeatureType] = ft.FeatureType
    in_type: Type[ft.FeatureType] = ft.FeatureType
    in_types = ()

    def check_input_types(self, features):
        if not features:
            raise TypeError("needs at least the fixed input")
        if not issubclass(features[0].wtype, self.in_type1):
            raise TypeError(f"first input must be {self.in_type1.__name__}")
        for f in features[1:]:
            if not issubclass(f.wtype, self.in_type):
                raise TypeError(f"tail inputs must be {self.in_type.__name__}")


class UnaryEstimator(Estimator):
    in_type: Type[ft.FeatureType] = ft.FeatureType

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if "in_type" in cls.__dict__ or not cls.in_types:
            cls.in_types = (cls.in_type,)


class BinaryEstimator(Estimator):
    in_types = (ft.FeatureType, ft.FeatureType)


class TernaryEstimator(Estimator):
    in_types = (ft.FeatureType,) * 3


class QuaternaryEstimator(Estimator):
    in_types = (ft.FeatureType,) * 4


class SequenceEstimator(Estimator):
    in_type: Type[ft.FeatureType] = ft.FeatureType
    in_types = ()

    def check_input_types(self, features):
        for f in features:
            if not issubclass(f.wtype, self.in_type):
                raise TypeError(
                    f"{type(self).__name__} input {f.name!r}: expected "
                    f"{self.in_type.__name__}, got {f.wtype.__name__}")


class BinarySequenceEstimator(Estimator):
    in_type1: Type[ft.FeatureType] = ft.FeatureType
    in_type: Type[ft.FeatureType] = ft.FeatureType
    in_types = ()

    def check_input_types(self, features):
        BinarySequenceTransformer.check_input_types(self, features)  # type: ignore


# ---------------------------------------------------------------------------
# Lambda stages (reference: UnaryLambdaTransformer etc.)
# ---------------------------------------------------------------------------

class LambdaTransformer(Transformer):
    """Wrap a plain python function as a stage.

    Persistable only when the function is importable (a module-level def):
    persistence stores its module-qualified name and re-imports on load.
    Lambdas/closures serialize with a clear error at save time.
    """

    in_types = ()

    def __init__(self, fn: Callable, out_type: Type[ft.FeatureType],
                 operation_name: str = "lambda", uid: Optional[str] = None,
                 **params):
        super().__init__(uid=uid, **params)
        self.fn = fn
        self.out_type = out_type
        self.operation_name = operation_name

    def check_input_types(self, features):
        pass

    def transform_value(self, *values):
        return self.fn(*values)

    def stage_params_json(self) -> Dict[str, Any]:
        import importlib
        fn = self.fn
        qual = getattr(fn, "__qualname__", "")
        mod = getattr(fn, "__module__", "")
        if "<lambda>" in qual or "<locals>" in qual or not mod:
            raise ValueError(
                f"LambdaTransformer({self.uid}) wraps a non-importable "
                f"function {qual!r}; use a module-level def to persist it")
        try:
            resolved = getattr(importlib.import_module(mod), qual.split(".")[0])
        except Exception as e:  # pragma: no cover
            raise ValueError(f"cannot re-import {mod}.{qual}: {e}") from e
        if resolved is not fn:
            raise ValueError(f"{mod}.{qual} does not resolve back to the "
                             f"wrapped function; cannot persist")
        d = dict(self.params)
        d.update({"fnModule": mod, "fnName": qual,
                  "outType": self.out_type.__name__,
                  "operationName": self.operation_name})
        return d

    @classmethod
    def from_params_json(cls, uid: str, params: Dict[str, Any]) -> "LambdaTransformer":
        import importlib
        p = dict(params)
        mod, name = p.pop("fnModule"), p.pop("fnName")
        out_type = ft.FeatureTypeFactory.by_name(p.pop("outType"))
        op = p.pop("operationName", "lambda")
        fn = getattr(importlib.import_module(mod), name)
        return cls(fn, out_type, operation_name=op, uid=uid, **p)


def transformer(in_types: Sequence[Type[ft.FeatureType]],
                out_type: Type[ft.FeatureType], operation_name: str = "fn"):
    """Decorator: turn a value-level function into a Transformer factory."""
    def deco(fn):
        def make(*features: Feature) -> Feature:
            t = LambdaTransformer(fn, out_type, operation_name=operation_name)
            t.in_types = tuple(in_types)
            return t.set_input(*features).output
        make.__name__ = fn.__name__
        return make
    return deco
