"""Batched deterministic evaluation and the evaluation suites."""
