from .base import Transformer

__all__ = ["Transformer"]
