"""Boolean expressions over ontology-ID and boolean obs columns.

Port of ``spatialcore_tpu/annotation/expression.py`` (pandas only): a
tokenizer and recursive-descent parser for the grammar
``expression := term ('|' term)* ; term := factor ('&' factor)* ;
factor := '~' factor | '(' expression ')' | ID``, evaluating masks over the
standard ontology columns. Bare boolean obs-column identifiers
(``is_tumor``) are operands too, so the mixed form
``"CL:0000236 & is_tumor"`` works. ``make_spatial_domains`` uses it for
CURIE filters.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np
import pandas as pd

from ..core.logging import get_logger

logger = get_logger("annotation.expression")

DEFAULT_ONTOLOGY_COLUMNS = [
    "cell_type_ontology_id",
    "disease_ontology_id",
    "tissue_ontology_id",
    "cell_type_ontology_term_id",
    "celltype_ontology_id",
]

_ID_RE = re.compile(r"[A-Za-z][A-Za-z0-9_]*:[A-Za-z0-9]+")
_NAME_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def tokenize(expression: str) -> List[str]:
    """Split into operands (ontology IDs / column names), ``& | ~ ( )``."""
    tokens: List[str] = []
    i, n = 0, len(expression)
    while i < n:
        ch = expression[i]
        if ch.isspace():
            i += 1
            continue
        if ch in "&|~()":
            tokens.append(ch)
            i += 1
            continue
        m = _ID_RE.match(expression, i)
        if m:
            tokens.append(m.group(0).upper())
            i = m.end()
            continue
        m = _NAME_RE.match(expression, i)
        if m:
            tokens.append(m.group(0))
            i = m.end()
            continue
        raise ValueError(
            f"Unexpected character '{ch}' at position {i} in "
            f"expression: '{expression}'")
    return tokens


class _Parser:
    """Recursive descent over the tokenized expression."""

    def __init__(self, tokens: List[str], resolve):
        self.tokens = tokens
        self.pos = 0
        self.resolve = resolve  # operand token -> bool ndarray

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise ValueError("Unexpected end of expression")
        self.pos += 1
        return tok

    def expression(self) -> np.ndarray:
        out = self.term()
        while self.peek() == "|":
            self.next()
            out = out | self.term()
        return out

    def term(self) -> np.ndarray:
        out = self.factor()
        while self.peek() == "&":
            self.next()
            out = out & self.factor()
        return out

    def factor(self) -> np.ndarray:
        tok = self.peek()
        if tok == "~":
            self.next()
            return ~self.factor()
        if tok == "(":
            self.next()
            out = self.expression()
            if self.next() != ")":
                raise ValueError("Missing closing parenthesis")
            return out
        return self.resolve(self.next())


def _find_ontology_columns(adata, ontology_columns: Optional[List[str]]):
    if ontology_columns is not None:
        cols = [c for c in ontology_columns if c in adata.obs.columns]
        if not cols:
            raise ValueError(
                "None of the specified ontology columns found in adata.obs: "
                f"{ontology_columns}")
        return cols
    return [c for c in DEFAULT_ONTOLOGY_COLUMNS if c in adata.obs.columns]


def evaluate_ontology_expression(
    expression: str,
    adata,
    ontology_columns: Optional[List[str]] = None,
) -> pd.Series:
    """Evaluate a boolean ontology/column expression to a per-cell mask.

    Operands: ontology IDs (``CL:0000236``) matched case-insensitively across
    the available ontology columns (OR over columns), or bare boolean obs
    column names. Operators ``& | ~`` and parentheses.
    """
    tokens = tokenize(expression)
    if not tokens:
        raise ValueError("Empty filter expression")
    onto_cols = _find_ontology_columns(adata, ontology_columns)
    n = adata.n_obs

    def resolve(tok: str) -> np.ndarray:
        if ":" in tok:
            if not onto_cols:
                raise ValueError(
                    f"Ontology ID '{tok}' used but no ontology columns exist "
                    f"in adata.obs (looked for {DEFAULT_ONTOLOGY_COLUMNS})")
            mask = np.zeros(n, dtype=bool)
            for col in onto_cols:
                vals = adata.obs[col].astype(str).str.upper()
                mask |= (vals == tok).to_numpy()
            return mask
        if tok in adata.obs.columns:
            col = adata.obs[tok]
            uniq = set(col.dropna().unique())
            if col.dtype == bool or uniq.issubset(
                    {True, False, "True", "False"}):
                if uniq & {"True", "False"}:
                    # object AND categorical dtypes (numpy string
                    # truthiness turns 'False' into True otherwise)
                    col = col.astype(object).map(
                        {"True": True, "False": False,
                         True: True, False: False})
                return col.fillna(False).astype(bool).to_numpy()
            raise ValueError(
                f"Column '{tok}' exists but is not boolean; use equality "
                f"syntax \"{tok} == 'value'\" outside ontology expressions.")
        raise ValueError(
            f"Operand '{tok}' is neither an ontology ID present in "
            f"{onto_cols or 'any ontology column'} nor a boolean obs column.")

    parser = _Parser(tokens, resolve)
    mask = parser.expression()
    if parser.peek() is not None:
        raise ValueError(
            f"Unexpected token '{parser.peek()}' after end of expression")
    n_match = int(mask.sum())
    logger.info(f"Filter '{expression}': {n_match:,}/{n:,} cells match")
    return pd.Series(mask, index=adata.obs.index)


def get_ontology_ids_in_expression(expression: str):
    """The ontology CURIEs referenced by a boolean expression."""
    return [t for t in tokenize(expression) if ":" in t]
