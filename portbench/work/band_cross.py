"""One draw's band cross of the global null (K1-K4), from the problem.

Bytes: the permuted value table, N x G at the null's precision, read
once; the graph's N*k edges, a 4-byte index and a weight at the null's
weight precision (int8 codes for the integer nulls), read once; the [G]
float32 output written once. Operations: 2*N*k*G multiply-adds on the
precision's unit.
"""

from . import least_seconds

VALUE_BYTES = {"int4": 0.5, "int8": 1.0, "bf16": 2.0, "f32": 4.0}


def work(n: int, k: int, genes: int, precision: str):
    integer = precision in ("int4", "int8")
    wbytes = 1.0 if integer else VALUE_BYTES[precision]
    nbytes = n * genes * VALUE_BYTES[precision] + n * k * (4 + wbytes) + 4 * genes
    return nbytes, 2.0 * n * k * genes, "int8" if integer else precision


def seconds(n: int, k: int, genes: int, precision: str) -> float:
    return least_seconds(*work(n, k, genes, precision))
