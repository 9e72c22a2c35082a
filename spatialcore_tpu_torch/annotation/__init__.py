"""Cell-type annotation: ontology tools, training, the pipeline, and
prediction.

Port of ``spatialcore_tpu/annotation``: the label patterns, label
validation and the ontology matcher, training-data discovery, the
reference combination and "Cap & Fill" balancing, the multinomial LR
trained on the card (AdamW in optax's order, ``torch.save`` checkpoints),
backed loading, acquisition with the Synapse and CELLxGENE clients, the
end-to-end ``train_and_annotate`` pipeline, the ``CellTypeModel`` artifact
(the reference's ``.npz`` + JSON) scored on the card, annotation with one
model or an ensemble, the model registry, confidence transforms and
filters (with the GMM marker validation), the canonical markers, the
annotation benchmark's seven metrics, and the boolean ontology-expression
evaluator. String work stays on the host.
"""

from .expression import (
    DEFAULT_ONTOLOGY_COLUMNS,
    evaluate_ontology_expression,
    get_ontology_ids_in_expression,
)
from .model import CellTypeModel
from .training import (
    DEFAULT_EXCLUDE_LABELS,
    HIGH_CONTRAST_PALETTE,
    combine_references,
    ensure_normalized,
    generate_color_scheme,
    get_panel_genes,
    get_training_summary,
    save_model_artifacts,
    subsample_balanced,
    train_cell_type_model,
    train_celltypist_model,
)
from .annotate import (
    TISSUE_MODEL_PRESETS,
    annotate_cells,
    annotate_celltypist,
    get_annotation_summary,
    get_model_gene_overlap,
    get_models_for_tissue,
)
from .registry import (
    load_registry,
    publish_model,
    register_model,
    resolve_model,
)
from .confidence import (
    ConfidenceMethod,
    compute_confidence_from_obsm,
    extract_decision_scores,
    filter_by_marker_validation,
    filter_low_confidence,
    filter_low_count_types,
    transform_confidence,
)
from .markers import (get_markers_for_type, list_available_cell_types,
                      load_canonical_markers, match_to_canonical)
from .benchmark import (
    benchmark_annotation,
    compare_annotation_methods,
    deg_log2fc,
    gene_overlap,
    marker_quality_metrics,
    unassigned_rate,
)
from .pipeline import TrainingConfig, train_and_annotate, train_and_annotate_config
from .loading import (
    estimate_adata_memory_gb,
    get_available_memory_gb,
    get_loading_summary,
    load_adata_backed,
    stratified_sample_indices,
    subsample_adata,
)
from ..core import (  # reference re-exports these from annotation
    check_normalization_status,
    load_ensembl_to_hugo_mapping,
    normalize_gene_names,
)
from .acquisition import acquire_reference, resolve_uri_to_local
from .cellxgene import (download_cellxgene_reference, list_available_datasets,
                        query_cellxgene_census)
from .synapse import (authenticate_synapse, download_synapse_folder,
                      download_synapse_reference, get_synapse_entity_info,
                      list_synapse_folder)
from .discovery import (
    DiscoveredDataset,
    create_metadata_template,
    discover_training_data,
    load_local_metadata,
    make_metadata_template,
    print_discovery_summary,
    query_local_references,
    query_metadata,
)
from .ontology import (
    BLACKLISTED_CL_IDS,
    SKIP_LABELS,
    UNKNOWN_CELL_TYPE_ID,
    UNKNOWN_CELL_TYPE_NAME,
    OntologyMappingResult,
    add_ontology_ids,
    create_mapping_table,
    extract_biological_tokens,
    has_ontology_ids,
    load_ontology_index,
    search_ontology_index,
)
from .patterns import CELL_TYPE_PATTERNS, get_canonical_term
from .validation import (
    CellTypeValidationResult,
    ValidationIssue,
    check_label_ontology_consistency,
    validate_cell_type_column,
    validate_multiple_columns,
)

__all__ = [
    "train_and_annotate", "train_and_annotate_config", "TrainingConfig",
    "load_adata_backed", "stratified_sample_indices",
    "acquire_reference", "resolve_uri_to_local",
    "discover_training_data", "DiscoveredDataset",
    "print_discovery_summary", "query_local_references", "subsample_adata",
    "query_cellxgene_census", "download_cellxgene_reference",
    "make_metadata_template", "query_metadata",
    "add_ontology_ids", "search_ontology_index", "load_ontology_index",
    "extract_biological_tokens", "SKIP_LABELS", "BLACKLISTED_CL_IDS",
    "CELL_TYPE_PATTERNS", "get_canonical_term",
    "validate_cell_type_column", "validate_multiple_columns",
    "check_label_ontology_consistency", "CellTypeValidationResult",
    "ValidationIssue",
    "evaluate_ontology_expression", "DEFAULT_ONTOLOGY_COLUMNS",
    "CellTypeModel", "train_cell_type_model", "train_celltypist_model",
    "combine_references", "subsample_balanced", "ensure_normalized",
    "save_model_artifacts", "generate_color_scheme",
    "publish_model", "register_model", "resolve_model", "load_registry",
    "DEFAULT_EXCLUDE_LABELS", "HIGH_CONTRAST_PALETTE",
    "annotate_cells", "annotate_celltypist", "get_models_for_tissue",
    "TISSUE_MODEL_PRESETS",
    "transform_confidence", "extract_decision_scores",
    "filter_low_confidence", "filter_low_count_types",
    "filter_by_marker_validation", "ConfidenceMethod",
    "load_canonical_markers", "get_markers_for_type",
    "benchmark_annotation", "compare_annotation_methods",
    "marker_quality_metrics", "deg_log2fc", "gene_overlap",
    "unassigned_rate",
]


def __getattr__(name):
    import importlib

    try:
        return importlib.import_module(f".{name}", __name__)
    except ImportError as e:
        raise AttributeError(name) from e
