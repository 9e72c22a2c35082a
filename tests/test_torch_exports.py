"""The port's public names against the JAX package's, subpackage by
subpackage: every name the reference exports is exported by the port too,
unless it is still queued for porting (ROADMAP Queue 1), and every name
the port exports resolves. A porting PR moves names out of the queued
lists; a name may not be both queued and exported.
"""

import importlib

import pytest
import torch

import spatialcore_tpu  # noqa: F401  (the reference's subpackages below)

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

#: names of the reference's ``__all__`` not ported yet, by subpackage, each
#: with its ROADMAP Queue 1 item
QUEUED = {
    "core": {
        # item 16: the rest of core
        "Raw", "concat", "read_h5ad", "write_h5ad", "setup_logging",
        "setup_file_logging", "MetadataTracker", "prepare_metadata_for_h5ad",
        "restore_metadata_from_h5ad", "cache_result", "clear_cache",
        "get_cache_path", "check_normalization_status",
        "find_raw_counts_source", "normalize_total", "log1p",
        "normalize_log1p_from_raw", "normalize_gene_names",
        "load_ensembl_to_hugo_mapping", "is_ensembl_id",
        "download_ensembl_mapping",
    },
    "ops": set(),
    "spatial": {
        # item 12: niches and domains
        "neighborhood_enrichment", "compute_neighborhood_profile",
        "identify_niches", "niche_stability", "make_spatial_domains",
        "get_domain_summary", "detect_platform", "calculate_domain_distances",
        "get_distance_matrix",
    },
}


@pytest.mark.parametrize("sub", sorted(QUEUED))
def test_port_exports_the_reference_names(sub):
    ref = importlib.import_module(f"spatialcore_tpu.{sub}")
    port = importlib.import_module(f"spatialcore_tpu_torch.{sub}")
    queued = QUEUED[sub]
    assert queued <= set(ref.__all__), sorted(queued - set(ref.__all__))
    missing = set(ref.__all__) - queued - set(port.__all__)
    assert not missing, f"not exported by the port: {sorted(missing)}"
    ported = queued & set(port.__all__)
    assert not ported, f"ported, so no longer queued: {sorted(ported)}"
    unresolved = [n for n in port.__all__ if not hasattr(port, n)]
    assert not unresolved, unresolved
    assert len(set(port.__all__)) == len(port.__all__)
