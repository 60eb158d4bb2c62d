"""Automatic feature engineering: the type -> default-encoder dispatch (the port's copy of
``transmogrifai_tpu/ops/transmogrifier.py``).

Reference: core/.../stages/impl/feature/Transmogrifier.scala — the
`.transmogrify()` entry picks a sensible default vectorizer per feature
type and concatenates everything into one OPVector feature.

The port's dispatch is the JAX package's table. Branches whose encoder
lives in a module a later slice brings (parsers, lda, text_advanced,
maps, sparse) raise ``NotImplementedError`` naming the feature type and
the module; none of them picks another encoder instead.
"""
from __future__ import annotations

from typing import List, Sequence

from ..features import types as ft
from ..features.feature import Feature
from ..stages.base import PipelineStage, not_ported
from . import vectorizers as V

# Categorical text subtypes that default to topK pivot rather than smart
# text; all remaining Text subtypes get cardinality-adaptive smart text
_CATEGORICAL_TEXT = (ft.PickList, ft.ComboBox, ft.ID, ft.City, ft.Street,
                     ft.State, ft.Country, ft.PostalCode)


def _specialized_vector_feature(f: Feature) -> "Feature | None":
    """Parser chains for types with richer-than-text default encodings
    (Transmogrifier.scala dispatches these through RichTextFeature ops):
    Email/URL pivot their domain, Phone pivots validity, Base64 pivots
    detected MIME type, DateList gets its recency/gap stats. The
    parsers are not ported yet, so each of these types raises."""
    t = f.wtype
    if issubclass(t, (ft.Email, ft.URL, ft.Phone, ft.Base64, ft.DateList)):
        raise not_ported(f"transmogrify of {t.__name__} (feature "
                         f"{f.name!r})", "ops.parsers")
    return None


def default_vector_feature(f: Feature, textarea: str = "lda",
                           **kwargs) -> Feature:
    """The ONE dispatch both transmogrify() and Feature.vectorize() use:
    specialized parser chains first, then the per-type encoder table."""
    if textarea not in ("lda", "smart"):
        # validate HERE too: the specialized-chain early return below
        # would otherwise swallow a typo'd knob without a signal
        raise ValueError(f"textarea must be 'lda' or 'smart', "
                         f"got {textarea!r}")
    special = _specialized_vector_feature(f)
    if special is not None:
        if kwargs:
            raise TypeError(
                f"vectorize(**kwargs) unsupported for {f.wtype.__name__}: "
                f"its default encoding is a multi-stage parser chain")
        return special
    stage = default_vectorizer(f, textarea=textarea)
    if stage is None:
        return f
    for k, v in kwargs.items():
        if k in stage.params:
            stage.params[k] = v
        else:
            raise TypeError(f"{type(stage).__name__} has no param {k!r}")
    return stage.set_input(f).output


def default_vectorizer(f: Feature,
                       textarea: str = "lda") -> PipelineStage:
    """Pick the default encoder stage for a feature's type.

    Dispatch order mirrors the reference's Transmogrifier table: most
    specific type first. `textarea` picks the long-form-text default:
    "lda" (this framework's default — topic proportions are denser and
    more informative for long documents on the MXU) or "smart" (the
    reference-exact route through SmartTextVectorizer, for migrations
    that need bit-for-bit dispatch parity — see docs/MIGRATION.md).
    """
    if textarea not in ("lda", "smart"):
        raise ValueError(f"textarea must be 'lda' or 'smart', "
                         f"got {textarea!r}")
    t = f.wtype
    if issubclass(t, ft.Binary):
        return V.BinaryVectorizer()
    if issubclass(t, (ft.Date, ft.DateTime)):
        return V.DateToUnitCircle()
    if issubclass(t, ft.OPNumeric):
        return V.RealVectorizer()
    if issubclass(t, _CATEGORICAL_TEXT):
        return V.OneHotVectorizer()
    if issubclass(t, ft.TextArea) and textarea == "lda":
        # long free text defaults to topic proportions (OpLDA.scala);
        # shorter Text still goes cardinality-adaptive smart text
        raise not_ported(f"transmogrify of {t.__name__} (feature "
                         f"{f.name!r}, textarea='lda')", "ops.lda")
    if issubclass(t, ft.Text):
        return V.SmartTextVectorizer()
    if issubclass(t, ft.MultiPickList):
        return V.MultiPickListVectorizer()
    if issubclass(t, ft.TextList):
        raise not_ported(f"transmogrify of {t.__name__} (feature "
                         f"{f.name!r})", "ops.text_advanced")
    if issubclass(t, ft.Geolocation):
        return V.GeolocationVectorizer()
    if issubclass(t, ft.OPVector):
        return None  # already vectorized; passes straight to the combiner
    if issubclass(t, ft.OPMap):
        raise not_ported(f"transmogrify of {t.__name__} (feature "
                         f"{f.name!r})", "ops.maps")
    raise TypeError(f"transmogrify: no default vectorizer for "
                    f"{t.__name__} (feature {f.name!r})")


def transmogrify(features: Sequence[Feature],
                 textarea: str = "lda") -> Feature:
    """Vectorize each feature with its default encoder and combine.

    textarea="smart" restores the reference's exact TextArea dispatch
    (SmartTextVectorizer) instead of this framework's LDA default.
    """
    if not features:
        raise ValueError("transmogrify needs at least one feature")
    vectorized: List[Feature] = []
    for f in features:
        if f.is_response:
            raise ValueError(f"cannot transmogrify response feature {f.name!r}")
        vectorized.append(default_vector_feature(f, textarea=textarea))
    return V.VectorsCombiner().set_input(*vectorized).output


def transmogrify_sparse(features: Sequence[Feature],
                        num_buckets: int = 1 << 20,
                        seed: int = 42) -> tuple:
    """Criteo-scale dispatch (hashed-sparse indices plus the dense
    vector, for the sparse selector): its hashing vectorizer lives in
    ``ops/sparse.py``, which is not ported yet, so it raises."""
    raise not_ported("transmogrify_sparse", "ops.sparse")


def _feature_transmogrify(self: Feature, *others: Feature,
                          **kwargs) -> Feature:
    return transmogrify([self, *others], **kwargs)


def _feature_vectorize(self: Feature, **kwargs) -> Feature:
    return default_vector_feature(self, **kwargs)


Feature.register_dsl("transmogrify", _feature_transmogrify)
Feature.register_dsl("vectorize", _feature_vectorize)
