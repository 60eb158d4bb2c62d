from .base import MODEL_FAMILIES, PredictionModel, register_family
from . import linear  # registers the linear families

__all__ = ["MODEL_FAMILIES", "PredictionModel", "register_family",
           "linear"]
