"""Cell-type annotation: the scoring path.

Port of the scoring half of ``spatialcore_tpu/annotation``: the
``CellTypeModel`` artifact (the reference's ``.npz`` + JSON) scored on the
card, annotation with one model or an ensemble, the model registry,
confidence transforms and filters (with the GMM marker validation), the
canonical markers, the annotation benchmark's seven metrics, and the
boolean ontology-expression evaluator. Training, the pipeline, loading,
the ontology and label tools and the data-source clients are not ported
yet (ROADMAP Queue 1 item 14).
"""

from ..core import (check_normalization_status, load_ensembl_to_hugo_mapping,
                    normalize_gene_names)
from .acquisition import resolve_uri_to_local
from .annotate import (TISSUE_MODEL_PRESETS, annotate_cells,
                       annotate_celltypist, get_annotation_summary,
                       get_model_gene_overlap, get_models_for_tissue)
from .benchmark import (benchmark_annotation, compare_annotation_methods,
                        deg_log2fc, gene_overlap, marker_quality_metrics,
                        unassigned_rate)
from .confidence import (ConfidenceMethod, compute_confidence_from_obsm,
                         extract_decision_scores, filter_by_marker_validation,
                         filter_low_confidence, filter_low_count_types,
                         transform_confidence)
from .expression import (DEFAULT_ONTOLOGY_COLUMNS,
                         evaluate_ontology_expression,
                         get_ontology_ids_in_expression)
from .markers import (get_markers_for_type, list_available_cell_types,
                      load_canonical_markers, match_to_canonical)
from .model import CellTypeModel
from .registry import (load_registry, publish_model, register_model,
                       resolve_model)

__all__ = [
    "resolve_uri_to_local",
    "evaluate_ontology_expression", "DEFAULT_ONTOLOGY_COLUMNS",
    "CellTypeModel",
    "publish_model", "register_model", "resolve_model", "load_registry",
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
