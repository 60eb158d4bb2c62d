"""Stage framework: typed Estimator/Transformer bases.

Counterpart of ``transmogrifai_tpu/stages/base.py`` (reference:
core/src/main/scala/com/salesforce/op/stages/). One protocol serves both
halves of the port:

* **Fitting.** An Estimator is wired with ``set_input(*features)``;
  ``fit(ds)`` runs ``fit_fn`` and returns the fitted Transformer (the
  "model"), which shares the estimator's input wiring and output
  feature; ``fit_transform`` also appends the model's output column.
* **Serving.** A fitted stage built from a portable artifact
  (``portable.from_portable``) has no feature DAG around it: it is
  constructed as ``Transformer(input_names, output_name, **params)`` and
  wired to plain column names. Either way a stage exposes
  ``input_names``, ``output_name``, ``params`` and ``make_device_fn()``
  — a plain function on tensors that lie on the stage's device, which
  the port's FusedScorer composes.

Not carried over (no caller in the port yet): the persistence registry
(``STAGE_REGISTRY``), failure policies, the row-by-row default
transform and row functions for local scoring, lambda stages and the
unary/ternary/quaternary/sequence arities.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

from ..dataset import Dataset
from ..features import types as ft
from ..features.feature import Feature, TransientFeature, make_uid


class PipelineStage:
    """Base pipeline stage: params + input wiring + one output feature."""

    #: expected FeatureType (base) per input
    in_types: Tuple[Type[ft.FeatureType], ...] = ()
    #: output feature type
    out_type: Type[ft.FeatureType] = ft.FeatureType
    #: short operation name used in derived feature names
    operation_name: str = "stage"

    def __init__(self, uid: Optional[str] = None, **params: Any):
        self.uid = uid or make_uid(type(self).__name__)
        self.params: Dict[str, Any] = dict(params)
        self.inputs: Tuple[TransientFeature, ...] = ()
        self._output: Optional[Feature] = None

    # -- wiring ----------------------------------------------------------
    def check_input_types(self, features: Sequence[Feature]) -> None:
        if self.in_types and len(self.in_types) != len(features):
            raise TypeError(
                f"{type(self).__name__} takes {len(self.in_types)} inputs, "
                f"got {len(features)}")
        for f, t in zip(features, self.in_types):
            if not issubclass(f.wtype, t):
                raise TypeError(
                    f"{type(self).__name__} input {f.name!r}: expected "
                    f"{t.__name__}, got {f.wtype.__name__}")

    def set_input(self, *features: Feature) -> "PipelineStage":
        self.check_input_types(features)
        self.inputs = tuple(TransientFeature.of(f) for f in features)
        self._output = Feature(
            name=self.make_output_name(features),
            wtype=self.out_type,
            origin_stage=self,
            parents=features,
        )
        return self

    def wire(self, input_names: Sequence[str],
             output_name: str) -> "PipelineStage":
        """Wire the stage to plain column names (a stage loaded from a
        portable artifact, which carries no feature DAG)."""
        self.inputs = tuple(TransientFeature(str(n), ft.FeatureType)
                            for n in input_names)
        self._output = Feature(name=str(output_name), wtype=self.out_type,
                               origin_stage=self)
        return self

    def make_output_name(self, features: Sequence[Feature]) -> str:
        base = "-".join(f.name for f in features[:4]) or "f"
        return f"{base}_{self.operation_name}_{self.uid.split('_')[-1]}"

    @property
    def output(self) -> Feature:
        if self._output is None:
            raise RuntimeError(f"{type(self).__name__}.set_input not called")
        return self._output

    @property
    def input_names(self) -> List[str]:
        return [f.name for f in self.inputs]

    @property
    def output_name(self) -> str:
        return self.output.name

    def __repr__(self):
        return f"{type(self).__name__}(uid={self.uid})"


class Transformer(PipelineStage):
    """A stage that maps a Dataset to a Dataset (appends its output
    column). ``Transformer(input_names, output_name, **params)`` builds
    a stage wired to plain column names (see :meth:`wire`)."""

    def __init__(self, input_names: Optional[Sequence[str]] = None,
                 output_name: Optional[str] = None, *,
                 uid: Optional[str] = None, **params: Any):
        super().__init__(uid=uid, **params)
        if output_name is not None:
            self.wire(input_names or (), output_name)

    def transform(self, ds: Dataset) -> Dataset:
        arr, otype, manifest = self._transform_columns(ds)
        return ds.with_column(self.output.name, arr, otype, manifest=manifest)

    def _transform_columns(self, ds: Dataset):
        """Bulk transform -> (column_array, output_type,
        manifest_or_None)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no host transform")

    def make_device_fn(self) -> Callable:
        """A plain fn(*input_tensors) -> output tensor on whole device
        columns (what the port's FusedScorer composes)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no device function")


class Estimator(PipelineStage):
    """A stage whose `fit` learns parameters and yields a Transformer."""

    #: Transformer class instantiated by default `fit`
    model_cls: Optional[Type[Transformer]] = None

    def fit(self, ds: Dataset) -> Transformer:
        return self._make_model(self.fit_fn(ds))

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        raise NotImplementedError

    def _make_model(self, model_args: Dict[str, Any]) -> Transformer:
        if self.model_cls is None:
            raise NotImplementedError(f"{type(self).__name__} needs model_cls")
        model = self.model_cls(uid=self.uid + "_model", **model_args)
        # precedence: fit_fn results > estimator params > model defaults
        model.params.update({k: v for k, v in self.params.items()
                             if k not in model_args})
        # share wiring: the model emits the estimator's output feature
        model.inputs = self.inputs
        model._output = self._output
        return model

    def fit_transform(self, ds: Dataset) -> Tuple[Transformer, Dataset]:
        m = self.fit(ds)
        return m, m.transform(ds)


class BinaryTransformer(Transformer):
    in_types = (ft.FeatureType, ft.FeatureType)


class BinaryEstimator(Estimator):
    in_types = (ft.FeatureType, ft.FeatureType)
