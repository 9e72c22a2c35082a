"""Annotation: the boolean ontology-expression evaluator that spatial
domains use. The rest of the reference's ``annotation`` is not ported yet
(ROADMAP Queue 1 item 14)."""

from .expression import evaluate_ontology_expression

__all__ = ["evaluate_ontology_expression"]
