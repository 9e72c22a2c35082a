"""One draw step of the int8 local Lee's L null (K7's lee tail), from the
problem.

Bytes: the permuted int8 y codes and the fixed int8 x codes, N x G each,
read once; the int32 observed |Lq| read; the counters read and written
(``counter_bytes`` each way); the graph's N*k edges (4-byte index, int8
weight code) read once; the float32 row scales, N, read once; the float32
per-block partials of the global L, one row of G for every 256 cells,
written once. Operations: 2*N*k*G multiply-adds on the int8 unit.
"""

from . import least_seconds

#: cells a partial of the global L sums (the program's default plan block)
PARTIAL_ROWS = 256


def work(n: int, k: int, genes: int, counter_bytes: int = 1):
    nbytes = (n * genes * (1 + 1 + 4 + 2 * counter_bytes) + n * k * 5 + 4 * n
              + 4 * (-(-n // PARTIAL_ROWS)) * genes)
    return nbytes, 2.0 * n * k * genes, "int8"


def seconds(n: int, k: int, genes: int, counter_bytes: int = 1) -> float:
    return least_seconds(*work(n, k, genes, counter_bytes))
