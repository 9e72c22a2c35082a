"""Public spatial-statistics API (global Moran's I and Geary's C, apart or
fused, local Moran's I, local Geary's C and its multivariate form,
Getis-Ord Gi* / Gi, Lee's L, global and local join counts)."""

from .autocorrelation import (build_spatial_weights, gearys_c, getis_ord_gi,
                              global_autocorrelation, join_count_statistics,
                              lees_l, lees_l_local, local_gearys_c,
                              local_gearys_c_multivariate, local_join_counts,
                              local_morans_i, morans_i)

__all__ = ["build_spatial_weights", "gearys_c", "getis_ord_gi",
           "global_autocorrelation", "join_count_statistics", "lees_l",
           "lees_l_local", "local_gearys_c", "local_gearys_c_multivariate",
           "local_join_counts", "local_morans_i", "morans_i"]
