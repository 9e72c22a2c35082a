"""SpatialData: the in-memory data bus, with torch tensors as first-class values.

Port of ``spatialcore_tpu/core/container.py``: an AnnData-compatible
container with ``X``, ``obs``, ``var``, ``obsm``, ``varm``, ``obsp``,
``uns``, ``layers`` and ``raw``, slicing (``adata[cells, genes]``, always a
copy), ``Raw`` and ``concat``. On-disk interop with h5ad lives in
``core/io.py``.

Torch tensors are stored as they are. The reference's ``AlignedDict``
normalizes every non-numpy value with ``np.asarray``
(spatialcore_tpu/core/container.py:125-133); on a CUDA tensor that is a
full device-to-host readback (or an error), so here tensors pass through
untouched, and slicing indexes them on their own device. Tensors are
mutable, so ``copy()`` clones them instead of sharing the storage as the
reference does for immutable jax arrays
(spatialcore_tpu/core/container.py:70-81).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch


def _copy_matrix(X):
    if X is None:
        return None
    if isinstance(X, torch.Tensor):
        return X.clone()
    if sp.issparse(X):
        return X.copy()
    return np.array(X, copy=True)


def _resolve_index(idx, names: pd.Index) -> np.ndarray:
    """Resolve obs/var indexers (slice, bool mask, int array, name list) to ints."""
    n = len(names)
    if isinstance(idx, slice):
        return np.arange(n)[idx]
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    idx = np.atleast_1d(np.asarray(idx))  # adata[5] / adata[:, 'GENE']
    if idx.dtype == bool:
        if idx.shape[0] != n:
            raise IndexError(f"Boolean mask length {idx.shape[0]} != axis length {n}")
        return np.flatnonzero(idx)
    if idx.dtype.kind in "iu":
        return idx.astype(np.int64)
    indexer = names.get_indexer(idx)
    if (indexer < 0).any():
        missing = list(np.asarray(idx)[indexer < 0][:5])
        raise KeyError(f"Names not found in axis: {missing}")
    return indexer


def _take(v, rows: np.ndarray, cols: Optional[np.ndarray] = None):
    """``v[rows]`` or ``v[rows][:, cols]`` as a new value; a tensor is
    indexed on its own device."""
    if isinstance(v, torch.Tensor):
        out = v.index_select(0, torch.as_tensor(rows, device=v.device))
        if cols is not None:
            out = out.index_select(1, torch.as_tensor(cols, device=v.device))
        return out
    if cols is None:
        return v[rows].copy()
    if sp.issparse(v):
        return v[rows][:, cols].copy()
    return v[np.ix_(rows, cols)].copy()


def dense_f32(X, device, rows=None, cols=None) -> torch.Tensor:
    """``X`` (a tensor, numpy or scipy sparse matrix), with ``rows`` and
    ``cols`` taken where given, as a dense float32 tensor on ``device``. A
    tensor is indexed where it lies and moved once; other inputs are
    densified on the host."""
    if isinstance(X, torch.Tensor):
        if rows is not None:
            X = X.index_select(0, torch.as_tensor(rows, device=X.device))
        if cols is not None:
            X = X.index_select(1, torch.as_tensor(cols, device=X.device))
        return X.to(device=device, dtype=torch.float32)
    if rows is not None:
        X = X[rows]
    if cols is not None:
        X = X[:, cols]
    if sp.issparse(X):
        X = X.toarray()
    return torch.as_tensor(np.asarray(X, dtype=np.float32), device=device)


class Raw:
    """Frozen snapshot of (X, var) before a transformation, like AnnData.raw."""

    def __init__(self, X, var: pd.DataFrame, obs_names: pd.Index):
        self.X = X
        self.var = var
        self._obs_names = obs_names

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    @property
    def n_vars(self) -> int:
        return self.var.shape[0]

    @property
    def shape(self):
        return (self.X.shape[0], self.var.shape[0])

    def copy(self) -> "Raw":
        return Raw(_copy_matrix(self.X), self.var.copy(), self._obs_names)

    def __getitem__(self, idx) -> "Raw":
        oidx, vidx = idx if isinstance(idx, tuple) else (idx, slice(None))
        oidx = _resolve_index(oidx, self._obs_names)
        vidx = _resolve_index(vidx, self.var.index)
        return Raw(_take(self.X, oidx, vidx), self.var.iloc[vidx].copy(),
                   self._obs_names[oidx])

    def to_adata(self) -> "SpatialData":
        return SpatialData(X=_copy_matrix(self.X), var=self.var.copy(),
                           obs=pd.DataFrame(index=self._obs_names))


def _deep_copy_uns(d):
    if isinstance(d, dict):
        return {k: _deep_copy_uns(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_deep_copy_uns(v) for v in d]
    if isinstance(d, tuple):
        return tuple(_deep_copy_uns(v) for v in d)
    if isinstance(d, (pd.DataFrame, np.ndarray)):
        return d.copy()
    if isinstance(d, torch.Tensor):
        return d.clone()
    return d


class AlignedDict(dict):
    """Dict of arrays whose leading dimension(s) must match container axes."""

    def __init__(self, parent: "SpatialData", axes: Sequence[int], data=None):
        super().__init__()
        self._parent = parent
        self._axes = tuple(axes)
        if data:
            for k, v in data.items():
                self[k] = v

    def __setitem__(self, key: str, value):
        # numpy, scipy sparse and torch tensors are stored as they are;
        # anything else (lists, Series, ...) normalizes to numpy
        if not (sp.issparse(value) or isinstance(value, (np.ndarray, torch.Tensor))):
            value = np.asarray(value)
        expected = [self._parent.shape[ax] for ax in self._axes]
        if len(value.shape) < len(expected):
            raise ValueError(
                f"Value for key '{key}' has shape {tuple(value.shape)}; "
                f"expected at least {len(expected)} dims aligned to {expected}")
        for dim, exp in enumerate(expected):
            if value.shape[dim] != exp:
                raise ValueError(
                    f"Value for key '{key}' has shape {tuple(value.shape)}; "
                    f"dim {dim} must equal {exp}")
        super().__setitem__(key, value)

    # dict.update / setdefault do not call __setitem__: route them through it
    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def __ior__(self, other):
        self.update(other)
        return self

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]


class SpatialData:
    """AnnData-compatible annotated data matrix: obs (cells) × var (genes)."""

    def __init__(
        self,
        X=None,
        obs: Optional[pd.DataFrame] = None,
        var: Optional[pd.DataFrame] = None,
        obsm: Optional[Mapping[str, Any]] = None,
        varm: Optional[Mapping[str, Any]] = None,
        obsp: Optional[Mapping[str, Any]] = None,
        uns: Optional[Dict[str, Any]] = None,
        layers: Optional[Mapping[str, Any]] = None,
        raw: Optional[Raw] = None,
    ):
        if X is None and obs is None:
            raise ValueError("Provide at least X or obs")
        if obs is not None and not isinstance(obs, pd.DataFrame):
            obs = pd.DataFrame(obs)
        if var is not None and not isinstance(var, pd.DataFrame):
            var = pd.DataFrame(var)
        n_obs = X.shape[0] if X is not None else obs.shape[0]
        n_vars = X.shape[1] if X is not None else (var.shape[0] if var is not None else 0)
        if obs is None:
            obs = pd.DataFrame(index=pd.Index([str(i) for i in range(n_obs)]))
        if var is None:
            var = pd.DataFrame(index=pd.Index([str(i) for i in range(n_vars)]))
        if obs.shape[0] != n_obs:
            raise ValueError(f"obs has {obs.shape[0]} rows but X has {n_obs}")
        if X is not None and var.shape[0] != X.shape[1]:
            raise ValueError(
                f"var has {var.shape[0]} rows but X has {X.shape[1]} columns")
        self.X = X
        self.obs = obs
        self.var = var
        self.uns: Dict[str, Any] = dict(uns) if uns else {}
        self.obsm = AlignedDict(self, (0,), obsm)
        self.varm = AlignedDict(self, (1,), varm)
        self.obsp = AlignedDict(self, (0, 0), obsp)
        self.layers = AlignedDict(self, (0, 1), layers)
        self.raw = raw

    @property
    def n_obs(self) -> int:
        return self.obs.shape[0]

    @property
    def n_vars(self) -> int:
        return self.var.shape[0]

    @property
    def shape(self):
        return (self.n_obs, self.n_vars)

    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @obs_names.setter
    def obs_names(self, names):
        self.obs.index = pd.Index(names)

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    @var_names.setter
    def var_names(self, names):
        self.var.index = pd.Index(names)

    def var_names_make_unique(self, join: str = "-") -> None:
        names = self.var.index.astype(str)
        counts: Dict[str, int] = {}
        out = []
        dup = set(names[names.duplicated()])
        for name in names:
            if name in dup:
                k = counts.get(name, 0)
                counts[name] = k + 1
                out.append(name if k == 0 else f"{name}{join}{k}")
            else:
                out.append(name)
        self.var.index = pd.Index(out)

    def copy(self) -> "SpatialData":
        new = SpatialData(X=_copy_matrix(self.X), obs=self.obs.copy(),
                          var=self.var.copy(), uns=_deep_copy_uns(self.uns),
                          raw=self.raw.copy() if self.raw is not None else None)
        for attr in ("obsm", "varm", "obsp", "layers"):
            for k, v in getattr(self, attr).items():
                getattr(new, attr)[k] = _copy_matrix(v)
        return new

    def __getitem__(self, idx) -> "SpatialData":
        oidx, vidx = idx if isinstance(idx, tuple) else (idx, slice(None))
        oi = _resolve_index(oidx, self.obs_names)
        vi = _resolve_index(vidx, self.var_names)
        new = SpatialData(
            X=None if self.X is None else _take(self.X, oi, vi),
            obs=self.obs.iloc[oi].copy(),
            var=self.var.iloc[vi].copy(),
            uns=_deep_copy_uns(self.uns),
            raw=self.raw[oi] if self.raw is not None else None,
        )
        for k, v in self.obsm.items():
            new.obsm[k] = _take(v, oi)
        for k, v in self.varm.items():
            new.varm[k] = _take(v, vi)
        for k, v in self.obsp.items():
            new.obsp[k] = _take(v, oi, oi)
        for k, v in self.layers.items():
            new.layers[k] = _take(v, oi, vi)
        return new

    def get_matrix(self, layer: Optional[str] = None):
        """Return ``X`` or a named layer; ``layer='raw'`` resolves ``.raw.X``
        where ``.raw`` is set, else a layer named "raw" (the reference
        raises there, leaving such a layer unreachable)."""
        if layer is None:
            if self.X is None:
                raise ValueError("This object has no X matrix")
            return self.X
        if layer == "raw" and (self.raw is not None or "raw" not in self.layers):
            if self.raw is None:
                raise ValueError("layer='raw' requested but .raw is not set")
            return self.raw.X
        if layer not in self.layers:
            raise KeyError(f"Layer '{layer}' not found; available: {list(self.layers)}")
        return self.layers[layer]

    def store_raw(self) -> None:
        """Snapshot current (X, var) into ``.raw`` (like ``adata.raw = adata``)."""
        self.raw = Raw(_copy_matrix(self.X), self.var.copy(), self.obs_names)

    def __repr__(self) -> str:
        parts = [f"SpatialData n_obs × n_vars = {self.n_obs} × {self.n_vars}"]
        for attr in ("obs", "var"):
            cols = list(getattr(self, attr).columns)
            if cols:
                parts.append(f"    {attr}: {', '.join(map(repr, cols[:12]))}")
        for attr in ("obsm", "varm", "obsp", "layers", "uns"):
            keys = list(getattr(self, attr).keys())
            if keys:
                parts.append(f"    {attr}: {', '.join(map(repr, keys[:12]))}")
        return "\n".join(parts)


def _stack_rows(mats):
    """Stack per-object matrices along obs: tensors with ``torch.cat`` on
    the first one's device, else scipy CSR if any is sparse, else numpy."""
    if all(isinstance(m, torch.Tensor) for m in mats):
        return torch.cat([m.to(mats[0].device) for m in mats])
    mats = [m.cpu().numpy() if isinstance(m, torch.Tensor) else m for m in mats]
    if any(sp.issparse(m) for m in mats):
        return sp.vstack([sp.csr_matrix(m) for m in mats])
    return np.vstack(mats)


def _outer_columns(X, idx: np.ndarray, n_vars: int):
    """``X`` laid out on the union's ``n_vars`` columns (``idx`` < 0: absent,
    zero)."""
    present = idx >= 0
    if isinstance(X, torch.Tensor):
        out = X.new_zeros((X.shape[0], n_vars))
        out[:, torch.as_tensor(np.flatnonzero(present), device=X.device)] = \
            X[:, torch.as_tensor(idx[present], device=X.device)]
        return out
    if sp.issparse(X):
        out = sp.lil_matrix((X.shape[0], n_vars), dtype=X.dtype)
        out[:, np.flatnonzero(present)] = X[:, idx[present]]
        return out.tocsr()
    out = np.zeros((X.shape[0], n_vars), dtype=X.dtype)
    out[:, present] = X[:, idx[present]]
    return out


def concat(
    objs: Sequence[SpatialData],
    join: str = "inner",
    label: Optional[str] = None,
    keys: Optional[Sequence[str]] = None,
    index_unique: Optional[str] = None,
) -> SpatialData:
    """Concatenate along obs, joining vars (like ``anndata.concat``):
    inner/outer var join, an optional batch ``label`` column from ``keys``,
    optional ``index_unique`` suffixes. Torch tensors stay tensors."""
    if not objs:
        raise ValueError("No objects to concatenate")
    if join not in ("inner", "outer"):
        raise ValueError("join must be 'inner' or 'outer'")

    var_sets = [o.var_names for o in objs]
    all_vars = var_sets[0]
    for v in var_sets[1:]:
        all_vars = all_vars.intersection(v) if join == "inner" else all_vars.union(v)

    mats, obs_frames = [], []
    for i, o in enumerate(objs):
        idx = o.var_names.get_indexer(all_vars)
        if join == "inner":
            mats.append(_take(o.X, np.arange(o.n_obs), idx))
        else:
            mats.append(_outer_columns(o.X, idx, len(all_vars)))
        obs_i = o.obs.copy()
        if label is not None:
            obs_i[label] = keys[i] if keys is not None else str(i)
        if index_unique is not None:
            suffix = keys[i] if keys is not None else str(i)
            obs_i.index = [f"{n}{index_unique}{suffix}" for n in obs_i.index]
        obs_frames.append(obs_i)

    obs = pd.concat(obs_frames, axis=0, join="outer")
    return SpatialData(X=_stack_rows(mats), obs=obs,
                      var=pd.DataFrame(index=all_vars))
