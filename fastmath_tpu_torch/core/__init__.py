"""Core utilities: dtype promotion."""
from .dtypes import downcast, upcast_half

__all__ = ["upcast_half", "downcast"]
