from . import types
from .feature import Feature, FeatureBuilder, TransientFeature, reset_uids
from .manifest import ColumnManifest, ColumnMeta, NULL_INDICATOR, OTHER_INDICATOR

__all__ = ["types", "Feature", "FeatureBuilder", "TransientFeature",
           "reset_uids", "ColumnManifest", "ColumnMeta", "NULL_INDICATOR",
           "OTHER_INDICATOR"]
