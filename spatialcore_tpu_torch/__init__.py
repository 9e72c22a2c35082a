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
(``nmf``), graph diffusion (``diffusion``), cell-type annotation from
reference h5ads to annotated cells (``annotation``: the ontology and label
tools, training, the pipeline, scoring, confidence and the benchmark), the
QC and validation figures (``plotting``), the statistics sharded over a
``torch.distributed`` device mesh (``parallel``), the R helpers
(``r_bridge``) and the command line (``python -m spatialcore_tpu_torch``). The kernels are in ``csrc/``. The
JAX package ``spatialcore_tpu`` is the reference every part of this
package is tested against; this package imports ``torch`` and never
``jax``.

Public functions take ``device="cuda"`` by default. A CPU tensor goes
through each kernel's plain PyTorch version; a CUDA tensor goes through
the kernel, or the call raises.

Module availability follows the reference's façade: ``core`` is
mandatory; the other modules import through ``_try_import`` and degrade to
a placeholder that raises a helpful error when an optional dependency is
missing. Importing the package never imports matplotlib: ``plotting``
builds its figures lazily.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict, List

__version__ = "0.1.0"

from . import core  # mandatory
from .core import (SpatialData, get_logger, key_for, read_h5ad,
                   update_metadata, write_h5ad)

_OPTIONAL_MODULES = ["ops", "spatial", "stats", "annotation", "plotting",
                     "parallel", "utils", "nmf", "diffusion", "r_bridge"]
_module_errors: Dict[str, str] = {}


class _UnavailableModule(ModuleType):
    """Placeholder raising a helpful ImportError on any attribute access."""

    def __init__(self, name: str, error: str):
        super().__init__(name)
        self._name = name
        self._error = error

    def __getattr__(self, item):
        raise ImportError(
            f"spatialcore_tpu_torch.{self._name} is unavailable: "
            f"{self._error}")


def _try_import(name: str):
    try:
        mod = importlib.import_module(f".{name}", __name__)
        if getattr(mod, "__file__", None) is None:  # bare namespace dir
            raise ImportError(f"module '{name}' has no __init__.py")
        return mod
    except ImportError as e:  # missing optional dependency
        _module_errors[name] = str(e)
        return _UnavailableModule(name, str(e))


ops = _try_import("ops")
spatial = _try_import("spatial")
stats = _try_import("stats")
annotation = _try_import("annotation")
plotting = _try_import("plotting")
parallel = _try_import("parallel")
utils = _try_import("utils")
nmf = _try_import("nmf")
diffusion = _try_import("diffusion")
r_bridge = _try_import("r_bridge")

# the spatial statistics' entry points, importable from the top level
from .spatial import (build_spatial_weights, gearys_c, getis_ord_gi,  # noqa: E402
                      global_autocorrelation, join_count_statistics, lees_l,
                      lees_l_local, local_gearys_c,
                      local_gearys_c_multivariate, local_join_counts,
                      local_morans_i, morans_i)


def available_modules() -> List[str]:
    """Names of successfully imported top-level modules."""
    return ["core"] + [m for m in _OPTIONAL_MODULES if m not in _module_errors]


def print_info() -> None:
    """Print the version and each module's availability."""
    print(f"spatialcore_tpu_torch {__version__}")
    for m in ["core"] + _OPTIONAL_MODULES:
        status = ("ok" if m not in _module_errors
                  else f"unavailable ({_module_errors[m]})")
        print(f"  {m:12s} {status}")


__all__ = [
    "__version__", "SpatialData", "read_h5ad", "write_h5ad", "get_logger",
    "update_metadata", "core", "ops", "spatial", "stats", "annotation",
    "plotting", "parallel", "utils", "nmf", "diffusion", "r_bridge",
    "available_modules", "print_info",
]
