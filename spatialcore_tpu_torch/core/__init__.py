"""Core layer: container, logging, provenance and counter-based randomness."""

from .container import AlignedDict, SpatialData
from .logging import get_logger
from .metadata import get_operations, update_metadata
from .rng import (batch_permutations, feistel_apply, feistel_permutation,
                  key_for, permutation_keys)

__all__ = ["AlignedDict", "SpatialData", "batch_permutations", "feistel_apply",
           "feistel_permutation", "get_logger", "get_operations", "key_for",
           "permutation_keys", "update_metadata"]
