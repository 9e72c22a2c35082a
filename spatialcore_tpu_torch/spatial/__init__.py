"""Public spatial-statistics API (global Moran's I and Geary's C, apart or
fused, and their distance-band correlogram, local Moran's I, local Geary's
C and its multivariate form, Getis-Ord Gi* / Gi, Lee's L, global and local
join counts, and the point-pattern statistics: Ripley's K / L, cross-type
K, co-occurrence and Clark-Evans)."""

from .autocorrelation import (build_spatial_weights, gearys_c, getis_ord_gi,
                              global_autocorrelation, join_count_statistics,
                              lees_l, lees_l_local, local_gearys_c,
                              local_gearys_c_multivariate, local_join_counts,
                              local_morans_i, moran_correlogram, morans_i)
from .ripley import (clark_evans, co_occurrence, cross_type_ripleys_k,
                     ripleys_k)

__all__ = ["build_spatial_weights", "clark_evans", "co_occurrence",
           "cross_type_ripleys_k", "gearys_c", "getis_ord_gi",
           "global_autocorrelation", "join_count_statistics", "lees_l",
           "lees_l_local", "local_gearys_c", "local_gearys_c_multivariate",
           "local_join_counts", "local_morans_i", "moran_correlogram",
           "morans_i", "ripleys_k"]
