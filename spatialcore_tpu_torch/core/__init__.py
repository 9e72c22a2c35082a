"""Core layer: container, logging, provenance and counter-based randomness."""

from .container import SpatialData
from .logging import get_logger
from .metadata import update_metadata
from .rng import feistel_apply, feistel_permutation, key_for

__all__ = ["SpatialData", "feistel_apply", "feistel_permutation", "get_logger",
           "key_for", "update_metadata"]
