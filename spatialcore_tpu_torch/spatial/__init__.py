"""Public spatial-statistics API (global Moran's I and Geary's C)."""

from .autocorrelation import build_spatial_weights, gearys_c, morans_i

__all__ = ["build_spatial_weights", "gearys_c", "morans_i"]
