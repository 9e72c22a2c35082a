"""Public spatial-statistics API (global Moran's I and Geary's C, local
Moran's I, local Geary's C, Getis-Ord Gi* / Gi)."""

from .autocorrelation import (build_spatial_weights, gearys_c, getis_ord_gi,
                              local_gearys_c, local_morans_i, morans_i)

__all__ = ["build_spatial_weights", "gearys_c", "getis_ord_gi",
           "local_gearys_c", "local_morans_i", "morans_i"]
