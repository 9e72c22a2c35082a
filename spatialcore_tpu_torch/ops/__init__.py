"""Compute layer: graphs (kNN, radius, and the exact kNN kernel), global
and local statistics (Moran, Geary, Getis-Ord, Lee's L), the banded and
slot permutation nulls, the distance-band correlogram, FDR and the
streaming global and local nulls. The point-pattern counts live in
``ops.ripley``, which the reference's ``ops`` does not export either."""

from .banded import (NullPlan, banded_getis, banded_lees_l, banded_local_geary,
                     banded_local_moran, banded_local_moran_pvalues,
                     banded_permutation_test, build_null_plan, plan_from_numpy)
from .fdr import apply_fdr, benjamini_hochberg, benjamini_hochberg_discrete, bonferroni
from .getis import GetisOrdResult, getis_ord
from .graph import (SpatialGraph, build_graph, graph_from_numpy, graph_moments,
                    knn_exact, knn_grid, radius_neighbors, spatial_lag)
from .knn_kernel import pallas_knn
from .lee import LeesLResult, lees_l_pairs
from .moran import (QUADRANT_LABELS, LocalGearyResult, LocalMoranResult,
                    classify_quadrants, correlogram_kernel,
                    geary_analytic_moments, geary_observed,
                    join_counts, local_geary, local_geary_multivariate,
                    local_join_counts, local_moran,
                    moran_analytic_moments, moran_observed, p_from_z,
                    permutation_test_global, standardize)
from .streaming import (device_local_sink, host_local_sink, streaming_local_null,
                        streaming_moran_null, tile_widths)

__all__ = ["GetisOrdResult", "LeesLResult", "LocalGearyResult",
           "LocalMoranResult", "NullPlan",
           "QUADRANT_LABELS", "SpatialGraph", "apply_fdr", "banded_getis",
           "banded_lees_l", "banded_local_geary", "banded_local_moran",
           "banded_local_moran_pvalues",
           "banded_permutation_test", "benjamini_hochberg",
           "benjamini_hochberg_discrete", "bonferroni", "build_graph",
           "build_null_plan", "classify_quadrants", "correlogram_kernel",
           "device_local_sink",
           "geary_analytic_moments", "geary_observed", "getis_ord",
           "graph_from_numpy", "graph_moments", "host_local_sink",
           "join_counts", "knn_exact", "knn_grid", "lees_l_pairs",
           "local_geary", "local_geary_multivariate", "local_join_counts",
           "local_moran",
           "moran_analytic_moments", "moran_observed", "p_from_z",
           "pallas_knn", "permutation_test_global", "plan_from_numpy",
           "radius_neighbors",
           "spatial_lag", "standardize", "streaming_local_null",
           "streaming_moran_null", "tile_widths"]
