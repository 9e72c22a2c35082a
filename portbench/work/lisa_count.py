"""One draw step of the int8 local Moran null (K7's moran tail), from the
problem.

Bytes: the permuted int8 code table, N x G, read once; the graph's N*k
edges (4-byte index, int8 weight code) read once; the planes the
statistic needs: the int32 observed |I| read, the counters read and
written (``counter_bytes`` each way). Operations: 2*N*k*G multiply-adds
on the int8 unit.
"""

from . import least_seconds


def work(n: int, k: int, genes: int, counter_bytes: int = 1):
    nbytes = n * genes * (1 + 4 + 2 * counter_bytes) + n * k * 5
    return nbytes, 2.0 * n * k * genes, "int8"


def seconds(n: int, k: int, genes: int, counter_bytes: int = 1) -> float:
    return least_seconds(*work(n, k, genes, counter_bytes))
