"""Keyword compatibility with the reference API.

Port of ``spatialcore_tpu/core/compat.py``. Some public functions accept
two spellings of one parameter (``domain_column`` for ``output_column``,
``format_string`` for ``fmt``); ``param_aliases`` lets one canonical
signature take both, so code written against either keeps working.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch


def param_aliases(**aliases: str) -> Callable:
    """Accept alternate keyword spellings: ``alias_name -> canonical``.

    ``@param_aliases(cell_type_column="label_column")`` makes
    ``fn(cell_type_column=...)`` equivalent to ``fn(label_column=...)``.
    Passing both spellings raises ``TypeError``. The mapping is exposed
    as ``fn.__param_aliases__``.
    """

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            for alias, canonical in aliases.items():
                if alias in kwargs:
                    if canonical in kwargs:
                        raise TypeError(
                            f"{fn.__name__}() got '{alias}' and its "
                            f"canonical form '{canonical}' — pass one")
                    kwargs[canonical] = kwargs.pop(alias)
            return fn(*args, **kwargs)

        merged = dict(getattr(fn, "__param_aliases__", {}))
        merged.update(aliases)
        wrapper.__param_aliases__ = merged
        return wrapper

    return deco


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32, as the reference does:
    TF32 off for cuBLAS and cuDNN inside the block, the caller's settings
    restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
