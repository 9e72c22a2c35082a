"""Frozen operation and byte counts of the kernels the per-layer rooflines
read, counted from the problem's sizes (cells, neighbours, genes,
precision) and never from a plan's layout, so a roofline reads the same
work whatever implements the kernel. Peaks are in ``peaks.json``."""

import json
from pathlib import Path


def peaks() -> dict:
    return json.loads((Path(__file__).with_name("peaks.json")).read_text())


def least_seconds(nbytes: float, ops: float, unit: str) -> float:
    """The larger of the bytes over the HBM rate and the operations over
    the unit's peak."""
    p = peaks()
    return max(nbytes / p["hbm_bytes_per_s"], ops / p["ops_per_s"][unit])
