"""One draw step of the float local Moran null (``csrc/lisa_float.cu``),
from the problem.

Bytes: the permuted table, N x G values of ``table_bytes`` each (4 for
float32, 2 for bf16), read once; the float32 observed |I| read; the
counters read and written (``counter_bytes`` each way: 2 for P <= 32767,
else 4); the graph's N*k edges (a 4-byte index and a ``table_bytes``
weight) read once. Operations: 2*N*k*G on the float32 unit.
"""

from . import least_seconds


def work(n: int, k: int, genes: int, table_bytes: int = 4, counter_bytes: int = 2):
    nbytes = n * genes * (table_bytes + 4 + 2 * counter_bytes) + n * k * (4 + table_bytes)
    return nbytes, 2.0 * n * k * genes, "f32"


def seconds(n: int, k: int, genes: int, table_bytes: int = 4,
            counter_bytes: int = 2) -> float:
    return least_seconds(*work(n, k, genes, table_bytes, counter_bytes))
