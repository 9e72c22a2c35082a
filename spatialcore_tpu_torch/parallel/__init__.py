"""Multi-device scaling: mesh construction and sharded statistics.

Port of ``spatialcore_tpu/parallel``. The cell axis and the gene axis of
the data split over a ``torch.distributed`` ``DeviceMesh`` (axes
``("cells", "genes")``, :func:`auto_mesh`). Gene-sharded permutation
nulls need no communication: each rank keeps the whole fixed-degree graph
and null plan and its gene block, and the counter-keyed draws keep every
count bitwise the single-device run's. The cells × genes forms hold each
rank's [N/cs, G/gs] tiles only, for outputs larger than one device.
Results are DTensors; ``.full_tensor()`` gives the whole array.

Run one process a device (``torchrun --nproc-per-node 4 script.py``); in a
plain one-process script :func:`auto_mesh` makes its own one-rank group.
"""

from .mesh import auto_mesh, cell_sharding, gene_sharding, replicated
from .graph import sharded_build_graph, sharded_knn
from .stats import (
    sharded_banded_getis,
    sharded_banded_lees_l,
    sharded_banded_local_geary,
    sharded_banded_local_moran,
    sharded_banded_permutation_test,
    sharded_getis_ord,
    sharded_getis_ord_2d,
    sharded_lees_l,
    sharded_lees_l_2d,
    sharded_local_geary_2d,
    sharded_local_moran,
    sharded_local_moran_2d,
    sharded_moran,
    sharded_permutation_test,
)

__all__ = [
    "auto_mesh", "gene_sharding", "cell_sharding", "replicated",
    "sharded_moran", "sharded_local_moran", "sharded_permutation_test",
    "sharded_lees_l", "sharded_getis_ord", "sharded_local_moran_2d",
    "sharded_local_geary_2d", "sharded_lees_l_2d", "sharded_getis_ord_2d",
    "sharded_banded_permutation_test", "sharded_banded_local_moran",
    "sharded_banded_local_geary", "sharded_banded_getis",
    "sharded_banded_lees_l",
    "sharded_knn", "sharded_build_graph",
]
