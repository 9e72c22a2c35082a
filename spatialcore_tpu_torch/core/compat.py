"""Keyword compatibility with the reference API.

Port of ``spatialcore_tpu/core/compat.py``. Some public functions accept
two spellings of one parameter (``domain_column`` for ``output_column``,
``format_string`` for ``fmt``); ``param_aliases`` lets one canonical
signature take both, so code written against either keeps working.
"""

from __future__ import annotations

import functools
from typing import Callable


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
