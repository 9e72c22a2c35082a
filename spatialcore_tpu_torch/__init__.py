"""spatialcore_tpu_torch: the PyTorch / CUDA port of spatialcore_tpu.

The global permutation null for Moran's I and Geary's C (banded, slot
and streaming, apart or fused) and their distance-band correlogram, join
counts, and the local statistics local Moran's I (LISA), local Geary's C
(also multivariate), Getis-Ord Gi* / Gi, Lee's L and local join counts
with their permutation nulls (banded and slot), FDR and compact
streaming, on kNN or radius graphs, from coordinates to p-values, with
their kernels written by hand for Hopper; and the point-pattern
statistics (Ripley's K / L, cross-type K, co-occurrence, Clark-Evans,
``spatialcore_tpu_torch.spatial``); neighborhood enrichment, niches
(k-means over neighborhood profiles), raster spatial domains and domain
distances; the h5ad container and its IO, normalization and gene names
(``core``); profiling hooks and a Xenium-like simulator (``utils``);
threshold classification and Wilcoxon DEG (``stats``), NMF gene programs
(``nmf``), graph diffusion (``diffusion``) and the cell-type annotation
scoring path with its confidence filters and benchmark (``annotation``). The
kernels are in ``csrc/``. The JAX package ``spatialcore_tpu`` is the
reference every part of this package is tested against; this package
imports ``torch`` and never ``jax``.

Public functions take ``device="cuda"`` by default. A CPU tensor goes
through each kernel's plain PyTorch version; a CUDA tensor goes through
the kernel, or the call raises.
"""

__version__ = "0.1.0"

from . import annotation, diffusion, nmf, stats
from .core import (SpatialData, get_logger, key_for, read_h5ad,
                   update_metadata, write_h5ad)
from .spatial import (build_spatial_weights, gearys_c, getis_ord_gi,
                      global_autocorrelation, join_count_statistics, lees_l,
                      lees_l_local, local_gearys_c,
                      local_gearys_c_multivariate, local_join_counts,
                      local_morans_i, morans_i)

__all__ = ["SpatialData", "__version__", "annotation", "build_spatial_weights",
           "diffusion", "gearys_c",
           "get_logger", "getis_ord_gi", "global_autocorrelation",
           "join_count_statistics", "key_for", "lees_l", "lees_l_local",
           "local_gearys_c", "local_gearys_c_multivariate",
           "local_join_counts", "local_morans_i", "morans_i", "nmf",
           "read_h5ad", "stats", "update_metadata", "write_h5ad"]
