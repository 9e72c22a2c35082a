"""Public spatial-statistics API (global Moran's I and Geary's C, apart or
fused, and their distance-band correlogram, local Moran's I, local Geary's
C and its multivariate form, Getis-Ord Gi* / Gi, Lee's L, global and local
join counts, the point-pattern statistics: Ripley's K / L, cross-type K,
co-occurrence and Clark-Evans; neighborhood enrichment, neighborhood
profiles and niches, spatial domains and domain distances)."""

from .autocorrelation import (build_spatial_weights, gearys_c, getis_ord_gi,
                              global_autocorrelation, join_count_statistics,
                              lees_l, lees_l_local, local_gearys_c,
                              local_gearys_c_multivariate, local_join_counts,
                              local_morans_i, moran_correlogram, morans_i)
from .distance import calculate_domain_distances, get_distance_matrix
from .domains import detect_platform, get_domain_summary, make_spatial_domains
from .neighborhoods import (compute_neighborhood_profile, identify_niches,
                            niche_stability)
from .nhood import neighborhood_enrichment
from .ripley import (clark_evans, co_occurrence, cross_type_ripleys_k,
                     ripleys_k)

__all__ = ["build_spatial_weights", "calculate_domain_distances",
           "clark_evans", "co_occurrence", "compute_neighborhood_profile",
           "cross_type_ripleys_k", "detect_platform", "gearys_c",
           "get_distance_matrix", "get_domain_summary", "getis_ord_gi",
           "global_autocorrelation", "identify_niches",
           "join_count_statistics", "lees_l", "lees_l_local",
           "local_gearys_c", "local_gearys_c_multivariate",
           "local_join_counts", "local_morans_i", "make_spatial_domains",
           "moran_correlogram", "morans_i", "neighborhood_enrichment",
           "niche_stability", "ripleys_k"]
