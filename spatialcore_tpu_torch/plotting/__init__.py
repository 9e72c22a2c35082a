"""QC and validation figures (matplotlib).

Port of ``spatialcore_tpu/plotting``, the original spatialcore's
``plotting`` surface. Figures are built lazily: importing this package (or
``spatialcore_tpu_torch``) does not import matplotlib. The figures read
host numpy (tensors on any device are copied to the host where a figure
reads them); their numeric parts — agreement metrics, silhouettes,
classification counts, metagene scores and GMM thresholds, DEG ranks — run
in torch on ``device``, without sklearn.
"""

from .utils import (
    COLORBLIND_PALETTE,
    DEFAULT_PALETTE,
    despine,
    generate_celltype_palette,
    save_figure,
    setup_figure,
)

__all__ = [
    "DEFAULT_PALETTE", "COLORBLIND_PALETTE", "generate_celltype_palette",
    "setup_figure", "save_figure", "despine",
]


# flat name → submodule, resolved lazily so importing the package never
# pulls matplotlib (reference exposes these flat from plotting/__init__.py)
_FLAT = {
    "celltype": ["plot_celltype_distribution", "plot_celltype_pie",
                 "plot_celltype_embedding", "plot_celltype_umap"],
    "confidence": ["plot_confidence_histogram", "plot_confidence_by_celltype",
                   "plot_model_contribution", "plot_confidence_violin"],
    "spatial": ["plot_spatial_celltype", "plot_spatial_confidence",
                "plot_spatial_gene", "plot_spatial_genes",
                "plot_spatial_multi_gene", "plot_spatial_hotspots",
                "plot_moran_scatter", "plot_correlogram", "plot_co_occurrence",
                "plot_domain_distances", "plot_distance_map"],
    "validation": ["plot_marker_heatmap", "plot_2d_validation",
                   "plot_marker_dotplot", "plot_deg_heatmap",
                   "plot_celltype_confidence_spatial",
                   "plot_celltype_confidence", "plot_ontology_mapping",
                   "plot_ontology_mapping_table", "generate_annotation_plots"],
    "benchmark": ["plot_method_comparison", "plot_confusion_matrix",
                  "classification_report_table", "plot_classification_report",
                  "agreement_metrics", "plot_agreement_heatmap",
                  "plot_silhouette_by_type"],
    "gpairs": ["plot_gpairs"],
    "utils": ["save_palette", "load_palette", "save_celltype_palette",
              "load_celltype_palette", "setup_multi_figure",
              "close_figure", "format_axis_labels"],
}
_FLAT_INDEX = {fn: mod for mod, fns in _FLAT.items() for fn in fns}

__all__ += sorted(_FLAT_INDEX)


def __getattr__(name):
    # Lazy flat-function + submodule access without importing matplotlib
    import importlib

    mod = _FLAT_INDEX.get(name)
    if mod is not None:
        return getattr(importlib.import_module(f".{mod}", __name__), name)
    try:
        return importlib.import_module(f".{name}", __name__)
    except ImportError as e:
        raise AttributeError(name) from e


def __dir__():
    return sorted(set(__all__) | set(_FLAT))
