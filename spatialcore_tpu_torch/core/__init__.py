"""Core layer: container, h5ad IO, logging, provenance, caching,
normalization, gene names and counter-based randomness."""

from .cache import cache_result, clear_cache, get_cache_path
from .container import AlignedDict, Raw, SpatialData, concat
from .genes import (download_ensembl_mapping, is_ensembl_id,
                    load_ensembl_to_hugo_mapping, normalize_gene_names)
from .io import read_h5ad, write_h5ad
from .logging import get_logger, setup_file_logging, setup_logging
from .metadata import (MetadataTracker, get_operations,
                       prepare_metadata_for_h5ad, restore_metadata_from_h5ad,
                       update_metadata)
from .normalization import (check_normalization_status, find_raw_counts_source,
                            log1p, normalize_log1p_from_raw, normalize_total)
from .rng import (batch_permutations, feistel_apply, feistel_permutation,
                  key_for, permutation_keys)

__all__ = [
    "AlignedDict", "Raw", "SpatialData", "concat",
    "read_h5ad", "write_h5ad",
    "get_logger", "setup_logging", "setup_file_logging",
    "MetadataTracker", "update_metadata", "get_operations",
    "prepare_metadata_for_h5ad", "restore_metadata_from_h5ad",
    "cache_result", "clear_cache", "get_cache_path",
    "check_normalization_status", "find_raw_counts_source",
    "normalize_total", "log1p", "normalize_log1p_from_raw",
    "normalize_gene_names", "load_ensembl_to_hugo_mapping", "is_ensembl_id",
    "download_ensembl_mapping",
    "key_for", "permutation_keys", "batch_permutations",
    "feistel_apply", "feistel_permutation",
]
