"""Compute layer: graphs, global statistics and the banded permutation null."""

from .banded import NullPlan, banded_permutation_test, build_null_plan, plan_from_numpy
from .graph import SpatialGraph, build_graph, graph_from_numpy, graph_moments, spatial_lag
from .moran import (geary_analytic_moments, geary_observed, moran_analytic_moments,
                    moran_observed, p_from_z, standardize)
from .streaming import tile_widths

__all__ = ["NullPlan", "SpatialGraph", "banded_permutation_test", "build_graph",
           "build_null_plan", "geary_analytic_moments", "geary_observed",
           "graph_from_numpy", "graph_moments", "moran_analytic_moments",
           "moran_observed", "p_from_z", "plan_from_numpy", "spatial_lag",
           "standardize", "tile_widths"]
