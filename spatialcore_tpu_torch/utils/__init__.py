"""Cross-cutting utilities: profiling hooks, sparse-matrix moments and the
Xenium-like simulator."""

from .profiling import profile_trace, timed, timer
from .simulate import XENIUM_NICHES, simulate_xenium
from .sparse import sparse_gene_moments

__all__ = ["profile_trace", "timer", "timed", "sparse_gene_moments",
           "simulate_xenium", "XENIUM_NICHES"]
