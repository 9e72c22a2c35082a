"""Memory-aware reference loading: backed h5ad reads + stratified sampling.

Port of ``spatialcore_tpu/annotation/loading.py`` (host numpy and h5py,
so a copy): ``load_adata_backed`` (open a large file lazily, choose
stratified indices from obs alone, read only the sampled rows),
``stratified_sample_indices``, ``subsample_adata``, the memory helpers and
``get_loading_summary``; ``ensure_normalized`` lives in
``annotation.training`` and is re-exported here. The backed read slices CSR
rows straight out of the h5 datasets (indptr → per-row indices/data
spans), so peak memory is O(sampled rows), not O(file). h5py is imported
inside the calls that read a file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..core.compat import param_aliases
from ..core.container import SpatialData
from ..core.io import _read_any, _read_dataframe, read_h5ad
from ..core.logging import get_logger
from ..core.rng import np_rng
from .training import ensure_normalized  # noqa: F401  (re-export for parity)

logger = get_logger("annotation.loading")

BACKED_THRESHOLD_BYTES = 2 * 1024 ** 3  # files ≥2GB load backed


def stratified_sample_indices(
    labels: np.ndarray,
    n_target: int,
    seed: int = 0,
    min_per_class: int = 1,
) -> np.ndarray:
    """Proportional per-class sample of ``n_target`` indices (sorted)."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    if n_target >= n:
        return np.arange(n)
    rng = np_rng(seed, "stratified_sample")
    classes, counts = np.unique(labels, return_counts=True)
    frac = n_target / n
    parts = []
    for cls, cnt in zip(classes, counts):
        idx = np.nonzero(labels == cls)[0]
        take = min(max(int(round(cnt * frac)), min_per_class), cnt)
        parts.append(rng.choice(idx, size=take, replace=False))
    idx = np.concatenate(parts)
    if idx.size > n_target:
        idx = rng.choice(idx, size=n_target, replace=False)
    return np.sort(idx)


def _read_sparse_rows(group: "h5py.Group", rows: np.ndarray) -> sp.csr_matrix:
    """Slice CSR rows out of an h5 sparse group without loading the matrix."""
    enc = group.attrs.get("encoding-type", "")
    shape = tuple(group.attrs["shape"])
    if enc == "csc_matrix":
        # column layout: no cheap row slicing — load and slice (rare path)
        mat = sp.csc_matrix((group["data"][()], group["indices"][()],
                             group["indptr"][()]), shape=shape)
        return mat.tocsr()[rows]
    indptr = group["indptr"][()]
    data_parts, idx_parts = [], []
    new_indptr = np.zeros(rows.size + 1, indptr.dtype)
    d = group["data"]
    ind = group["indices"]
    for i, r in enumerate(rows):
        s, e = indptr[r], indptr[r + 1]
        data_parts.append(d[s:e])
        idx_parts.append(ind[s:e])
        new_indptr[i + 1] = new_indptr[i] + (e - s)
    return sp.csr_matrix(
        (np.concatenate(data_parts) if data_parts else np.empty(0),
         np.concatenate(idx_parts) if idx_parts else np.empty(0, np.int32),
         new_indptr), shape=(rows.size, shape[1]))


@param_aliases(label_column="stratify_by", random_state="seed")
def load_adata_backed(
    path: Union[str, Path],
    max_cells: Optional[int] = None,
    stratify_by: Optional[str] = "cell_type",
    seed: int = 0,
    backed_threshold_bytes: int = BACKED_THRESHOLD_BYTES,
    large_file_threshold_gb: Optional[float] = None,
) -> SpatialData:
    """Load an h5ad, sampling ≤``max_cells`` rows out-of-core when large.

    Small files (< ``backed_threshold_bytes``, or the reference-style
    ``large_file_threshold_gb`` when given) load fully then subset.
    Large files read obs first, choose stratified indices, then materialize
    only those rows of X / layers / obsm.
    """
    import h5py

    if large_file_threshold_gb is not None:
        backed_threshold_bytes = int(large_file_threshold_gb * 1024 ** 3)
    path = Path(path)
    size = path.stat().st_size
    if size < backed_threshold_bytes and max_cells is None:
        return read_h5ad(path)

    with h5py.File(path, "r") as f:
        obs = _read_dataframe(f["obs"])
        n = len(obs)
        if max_cells is None or max_cells >= n:
            rows = np.arange(n)
        elif stratify_by and stratify_by in obs.columns:
            rows = stratified_sample_indices(
                obs[stratify_by].astype(str).to_numpy(), max_cells, seed)
        else:
            rows = np.sort(np_rng(seed, "backed_sample").choice(
                n, size=max_cells, replace=False))
        logger.info(f"Backed load {path.name}: {rows.size:,}/{n:,} cells "
                    f"({size / 1e9:.2f} GB file)")

        var = _read_dataframe(f["var"])
        if "X" in f:
            node = f["X"]
            if isinstance(node, h5py.Group):
                X = _read_sparse_rows(node, rows)
            else:
                X = node[rows.tolist()]
        else:
            X = None
        adata = SpatialData(X=X, obs=obs.iloc[rows].copy(), var=var)
        for attr in ("obsm", "layers"):
            if attr in f:
                for k, v in f[attr].items():
                    if isinstance(v, h5py.Group):
                        getattr(adata, attr)[k] = _read_sparse_rows(v, rows)
                    else:
                        getattr(adata, attr)[k] = v[rows.tolist()]
        if "uns" in f:
            adata.uns.update(_read_any(f["uns"]))
    return adata


@param_aliases(max_cells="n_cells", random_state="seed")
def subsample_adata(
    adata,
    n_cells: int,
    stratify_by: Optional[str] = None,
    seed: int = 0,
    copy: bool = True,
):
    """Deterministic (optionally stratified) subsample of an in-memory
    SpatialData."""
    if n_cells >= adata.n_obs:
        return adata.copy() if copy else adata
    if stratify_by and stratify_by in adata.obs.columns:
        rows = stratified_sample_indices(
            adata.obs[stratify_by].astype(str).to_numpy(), n_cells, seed)
    else:
        rows = np.sort(np_rng(seed, "subsample_adata").choice(
            adata.n_obs, size=n_cells, replace=False))
    return adata[rows]


def estimate_adata_memory_gb(n_cells=None, n_genes=None,
                             dtype_bytes: int = 4,
                             path=None) -> float:
    """Estimated dense-matrix memory in GB.

    ``(n_cells, n_genes, dtype_bytes)`` →
    ``n_cells·n_genes·dtype_bytes / 1024³``; or ``(path)`` / ``path=`` →
    the file's size ×1.5 for CSR overheads.
    """
    if path is None and isinstance(n_cells, (str, Path)):
        n_cells, path = None, n_cells
    if path is not None:
        return round(Path(path).stat().st_size * 1.5 / 1e9, 3)
    if n_cells is None or n_genes is None:
        raise ValueError("Pass (n_cells, n_genes) or path=")
    return (int(n_cells) * int(n_genes) * int(dtype_bytes)) / (1024 ** 3)


def get_available_memory_gb() -> float:
    """Available system memory in GB (psutil when present, /proc fallback)."""
    try:
        import psutil

        return round(psutil.virtual_memory().available / 1e9, 2)
    except ImportError:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    return round(int(line.split()[1]) * 1024 / 1e9, 2)
    return float("nan")


def get_loading_summary(adata) -> dict:
    """Shape/sparsity/memory snapshot of a loaded dataset (X a tensor on
    any device, a numpy array or a scipy sparse matrix)."""
    X = adata.X
    if isinstance(X, torch.Tensor):
        nnz, bytes_ = int(torch.count_nonzero(X)), X.element_size() * X.numel()
    elif sp.issparse(X):
        nnz = int(X.nnz)
        bytes_ = X.data.nbytes + X.indices.nbytes + X.indptr.nbytes
    else:
        nnz, bytes_ = int(np.count_nonzero(X)), X.nbytes
    return {"n_obs": adata.n_obs, "n_vars": adata.n_vars,
            "sparsity": round(1 - nnz / max(adata.n_obs * adata.n_vars, 1), 4),
            "memory_gb": round(bytes_ / 1e9, 3),
            "layers": list(adata.layers.keys()),
            "has_raw": adata.raw is not None}
