"""SpatialData: the in-memory data bus, with torch tensors as first-class values.

Port of the part of ``spatialcore_tpu/core/container.py`` that the global
statistics use: ``X``, ``obs``, ``var``, ``obsm``, ``uns``, ``layers``,
``copy``, ``get_matrix``, ``n_obs`` and ``var_names``.

Torch tensors are stored as they are. The reference's ``AlignedDict``
normalizes every non-numpy value with ``np.asarray``
(spatialcore_tpu/core/container.py:125-133); on a CUDA tensor that is a
full device-to-host readback (or an error), so here tensors pass through
untouched. Tensors are mutable, so ``copy()`` clones them instead of
sharing the storage as the reference does for immutable jax arrays
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
        uns: Optional[Dict[str, Any]] = None,
        layers: Optional[Mapping[str, Any]] = None,
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
        self.layers = AlignedDict(self, (0, 1), layers)

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

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    def copy(self) -> "SpatialData":
        new = SpatialData(X=_copy_matrix(self.X), obs=self.obs.copy(),
                          var=self.var.copy(), uns=_deep_copy_uns(self.uns))
        for k, v in self.obsm.items():
            new.obsm[k] = _copy_matrix(v)
        for k, v in self.layers.items():
            new.layers[k] = _copy_matrix(v)
        return new

    def get_matrix(self, layer: Optional[str] = None):
        """Return ``X`` or a named layer."""
        if layer is None:
            if self.X is None:
                raise ValueError("This object has no X matrix")
            return self.X
        if layer not in self.layers:
            raise KeyError(f"Layer '{layer}' not found; available: {list(self.layers)}")
        return self.layers[layer]

    def __repr__(self) -> str:
        parts = [f"SpatialData n_obs × n_vars = {self.n_obs} × {self.n_vars}"]
        for attr in ("obsm", "layers", "uns"):
            keys = list(getattr(self, attr).keys())
            if keys:
                parts.append(f"    {attr}: {', '.join(map(repr, keys[:12]))}")
        return "\n".join(parts)
