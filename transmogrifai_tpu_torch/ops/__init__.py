from .sanity_checker import SanityCheckerModel
from .vectorizers import RealVectorizerModel, VectorsCombiner, impute_device_fn

__all__ = ["SanityCheckerModel", "RealVectorizerModel", "VectorsCombiner",
           "impute_device_fn"]
