"""Core layer: container, logging, provenance and counter-based randomness."""

from .container import AlignedDict, SpatialData
from .logging import get_logger
from .metadata import get_operations, update_metadata
from .rng import feistel_apply, feistel_permutation, key_for

__all__ = ["AlignedDict", "SpatialData", "feistel_apply", "feistel_permutation",
           "get_logger", "get_operations", "key_for", "update_metadata"]
