"""Compute layer: graphs, global and local statistics (Moran, Geary,
Getis-Ord), the banded permutation nulls, FDR and the streaming local
nulls."""

from .banded import (NullPlan, banded_getis, banded_local_geary,
                     banded_local_moran, banded_local_moran_pvalues,
                     banded_permutation_test, build_null_plan, plan_from_numpy)
from .fdr import apply_fdr, benjamini_hochberg, benjamini_hochberg_discrete, bonferroni
from .getis import GetisOrdResult, getis_ord
from .graph import SpatialGraph, build_graph, graph_from_numpy, graph_moments, spatial_lag
from .moran import (QUADRANT_LABELS, LocalGearyResult, LocalMoranResult,
                    classify_quadrants, geary_analytic_moments, geary_observed,
                    local_geary, local_moran,
                    moran_analytic_moments, moran_observed, p_from_z, standardize)
from .streaming import (device_local_sink, host_local_sink, streaming_local_null,
                        tile_widths)

__all__ = ["GetisOrdResult", "LocalGearyResult", "LocalMoranResult", "NullPlan",
           "QUADRANT_LABELS", "SpatialGraph", "apply_fdr", "banded_getis",
           "banded_local_geary", "banded_local_moran",
           "banded_local_moran_pvalues",
           "banded_permutation_test", "benjamini_hochberg",
           "benjamini_hochberg_discrete", "bonferroni", "build_graph",
           "build_null_plan", "classify_quadrants", "device_local_sink",
           "geary_analytic_moments", "geary_observed", "getis_ord",
           "graph_from_numpy", "graph_moments", "host_local_sink",
           "local_geary", "local_moran",
           "moran_analytic_moments", "moran_observed", "p_from_z",
           "plan_from_numpy", "spatial_lag", "standardize",
           "streaming_local_null", "tile_widths"]
