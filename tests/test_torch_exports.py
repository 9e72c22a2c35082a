"""The port's public names against the JAX package's, subpackage by
subpackage (``core``, ``ops``, ``spatial``, ``utils``, ``stats``,
``annotation``, the modules ``nmf`` and ``diffusion``, and the top level's
IO): every name the reference exports is exported by the port too, unless
it is still queued for porting (ROADMAP Queue 1), and every name the port
exports resolves. A porting PR moves names out of the queued lists; a name
may not be both queued and exported.
"""

import importlib

import pytest
import torch

import spatialcore_tpu  # noqa: F401  (the reference's subpackages below)

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

#: ROADMAP Queue 1 item 14, the training half of annotation: training,
#: the pipeline, loading, the ontology and label patterns, label
#: validation, discovery, and the Synapse / CELLxGENE clients
#: (``acquire_reference`` downloads through them)
ITEM_14 = {
    "TrainingConfig", "train_and_annotate", "train_and_annotate_config",
    "train_cell_type_model", "train_celltypist_model", "combine_references",
    "subsample_balanced", "ensure_normalized", "save_model_artifacts",
    "generate_color_scheme", "DEFAULT_EXCLUDE_LABELS", "HIGH_CONTRAST_PALETTE",
    "load_adata_backed", "stratified_sample_indices", "subsample_adata",
    "add_ontology_ids", "search_ontology_index", "load_ontology_index",
    "extract_biological_tokens", "SKIP_LABELS", "BLACKLISTED_CL_IDS",
    "CELL_TYPE_PATTERNS", "get_canonical_term",
    "validate_cell_type_column", "validate_multiple_columns",
    "check_label_ontology_consistency", "CellTypeValidationResult",
    "ValidationIssue",
    "discover_training_data", "DiscoveredDataset", "print_discovery_summary",
    "query_local_references", "make_metadata_template", "query_metadata",
    "query_cellxgene_census", "download_cellxgene_reference",
    "acquire_reference",
}

#: names of the reference's ``__all__`` not ported yet, by subpackage or
#: module, each set under its ROADMAP Queue 1 item
QUEUED = {
    "core": set(),
    "ops": set(),
    "spatial": set(),
    "utils": set(),
    "stats": set(),
    "nmf": set(),
    "diffusion": set(),
    "annotation": ITEM_14,
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


def test_top_level_exports_h5ad_io():
    import spatialcore_tpu_torch as port

    for name in ("read_h5ad", "write_h5ad", "SpatialData"):
        assert name in port.__all__ and hasattr(port, name)
    assert port.read_h5ad is importlib.import_module(
        "spatialcore_tpu_torch.core").read_h5ad


@pytest.mark.parametrize("name", ["stats", "annotation", "nmf", "diffusion"])
def test_top_level_exposes_the_ported_modules(name):
    import spatialcore_tpu_torch as port

    assert name in port.__all__
    assert getattr(port, name) is importlib.import_module(
        f"spatialcore_tpu_torch.{name}")
