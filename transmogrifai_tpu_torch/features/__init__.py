from . import types
from .feature import Feature, FeatureBuilder, TransientFeature, reset_uids

__all__ = ["types", "Feature", "FeatureBuilder", "TransientFeature",
           "reset_uids"]
