"""Automatic feature engineering: the type -> default-encoder dispatch (the port's copy of
``transmogrifai_tpu/ops/transmogrifier.py``).

Reference: core/.../stages/impl/feature/Transmogrifier.scala — the
`.transmogrify()` entry picks a sensible default vectorizer per feature
type and concatenates everything into one OPVector feature.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Type

from ..features import types as ft
from ..features.feature import Feature
from ..stages.base import PipelineStage
from . import vectorizers as V

# Categorical text subtypes that default to topK pivot rather than smart
# text; all remaining Text subtypes get cardinality-adaptive smart text
_CATEGORICAL_TEXT = (ft.PickList, ft.ComboBox, ft.ID, ft.City, ft.Street,
                     ft.State, ft.Country, ft.PostalCode)


def _specialized_vector_feature(f: Feature) -> "Feature | None":
    """Parser chains for types with richer-than-text default encodings
    (Transmogrifier.scala dispatches these through RichTextFeature ops):
    Email/URL pivot their domain, Phone pivots validity, Base64 pivots
    detected MIME type, DateList gets its recency/gap stats."""
    from . import parsers as P
    t = f.wtype
    if issubclass(t, ft.Email):
        dom = P.EmailToPickList().set_input(f).output
        return V.OneHotVectorizer().set_input(dom).output
    if issubclass(t, ft.URL):
        dom = P.UrlToDomain().set_input(f).output
        return V.OneHotVectorizer().set_input(dom).output
    if issubclass(t, ft.Phone):
        ok = P.IsValidPhoneTransformer().set_input(f).output
        return V.BinaryVectorizer().set_input(ok).output
    if issubclass(t, ft.Base64):
        mime = P.MimeTypeDetector().set_input(f).output
        return V.OneHotVectorizer().set_input(mime).output
    if issubclass(t, ft.DateList):
        return P.DateListVectorizerEstimator().set_input(f).output
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
        from .lda import OpLDA
        return OpLDA(k=8, vocab_size=256)
    if issubclass(t, ft.Text):
        return V.SmartTextVectorizer()
    if issubclass(t, ft.MultiPickList):
        return V.MultiPickListVectorizer()
    if issubclass(t, ft.TextList):
        from .text_advanced import CountVectorizer
        return CountVectorizer()
    if issubclass(t, ft.Geolocation):
        return V.GeolocationVectorizer()
    if issubclass(t, ft.OPVector):
        return None  # already vectorized; passes straight to the combiner
    from .maps import default_map_vectorizer
    mv = default_map_vectorizer(t)
    if mv is not None:
        return mv
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
    """Criteo-scale dispatch: hashed-sparse instead of dense pivots.

    All Text-typed features (PickList, ComboBox, ID, plain Text, ...)
    hash into ONE shared space — K features become an (n, K) int32
    `SparseIndices` matrix; no dense (n, buckets) block ever exists.
    Every other feature keeps its dense default encoder and combines
    into the usual OPVector. Returns ``(sparse_indices, dense_vector)``
    — feed both to the sparse selector::

        sidx, dense = transmogrify_sparse(feats, num_buckets=1 << 20)
        pred = SparseModelSelector().set_input(label, sidx, dense).output

    Reference parity: OPCollectionHashingVectorizer's shared hash space
    (core/.../impl/feature/OPCollectionHashingVectorizer.scala) as the
    default encoding for the high-cardinality regime where topK pivots
    would explode (SURVEY §7 step 7, Criteo scale).
    """
    from .sparse import SparseHashingVectorizer
    if not features:
        raise ValueError("transmogrify_sparse needs at least one feature")
    for f in features:
        if f.is_response:
            raise ValueError(
                f"cannot transmogrify response feature {f.name!r}")
    cats = [f for f in features if issubclass(f.wtype, ft.Text)]
    rest = [f for f in features if not issubclass(f.wtype, ft.Text)]
    if not cats:
        raise ValueError("transmogrify_sparse: no Text-typed features to "
                         "hash — use transmogrify() for all-dense data")
    if not rest:
        raise ValueError(
            "transmogrify_sparse: the sparse model kernels take a dense "
            "numeric block alongside the hashed indices; declare at least "
            "one non-Text feature (numeric/date/geo)")
    sparse = SparseHashingVectorizer(
        num_buckets=num_buckets, seed=seed).set_input(*cats).output
    return sparse, transmogrify(rest)


def _feature_transmogrify(self: Feature, *others: Feature,
                          **kwargs) -> Feature:
    return transmogrify([self, *others], **kwargs)


def _feature_vectorize(self: Feature, **kwargs) -> Feature:
    return default_vector_feature(self, **kwargs)


Feature.register_dsl("transmogrify", _feature_transmogrify)
Feature.register_dsl("vectorize", _feature_vectorize)
