"""spatialcore_tpu_torch: the PyTorch / CUDA port of spatialcore_tpu.

The global permutation null for Moran's I and Geary's C (banded, slot
and streaming, apart or fused), and the local
statistics local Moran's I (LISA), local Geary's C, Getis-Ord Gi* / Gi
and Lee's L with their permutation nulls, FDR and compact streaming, from coordinates
to p-values, with their kernels written by hand for Hopper
(``csrc/``). The JAX package ``spatialcore_tpu`` is the reference every
part of this package is tested against; this package imports ``torch``
and never ``jax``.

Public functions take ``device="cuda"`` by default. A CPU tensor goes
through each kernel's plain PyTorch version; a CUDA tensor goes through
the kernel, or the call raises.
"""

__version__ = "0.1.0"

from .core import SpatialData, get_logger, key_for, update_metadata
from .spatial import (build_spatial_weights, gearys_c, getis_ord_gi,
                      global_autocorrelation, lees_l, lees_l_local,
                      local_gearys_c, local_morans_i, morans_i)

__all__ = ["SpatialData", "__version__", "build_spatial_weights", "gearys_c",
           "get_logger", "getis_ord_gi", "global_autocorrelation", "key_for",
           "lees_l", "lees_l_local", "local_gearys_c", "local_morans_i",
           "morans_i", "update_metadata"]
