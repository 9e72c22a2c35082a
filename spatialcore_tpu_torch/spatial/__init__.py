"""Public spatial-statistics API (global Moran's I and Geary's C, apart or
fused, local Moran's I, local Geary's C, Getis-Ord Gi* / Gi, Lee's L)."""

from .autocorrelation import (build_spatial_weights, gearys_c, getis_ord_gi,
                              global_autocorrelation, lees_l, lees_l_local,
                              local_gearys_c, local_morans_i, morans_i)

__all__ = ["build_spatial_weights", "gearys_c", "getis_ord_gi",
           "global_autocorrelation", "lees_l", "lees_l_local",
           "local_gearys_c", "local_morans_i", "morans_i"]
