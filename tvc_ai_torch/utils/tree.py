"""``tree_map`` over nested dataclasses of tensors (the port's pytrees)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over dataclass instances of the same type;
    every field that is not a dataclass instance is a leaf. A ``None`` leaf
    (an optional field that is off) stays ``None``, and must be ``None`` in
    every tree."""
    if tree is None:
        if any(r is not None for r in rest):
            raise ValueError("tree_map: a None leaf against a value")
        return None
    if not dataclasses.is_dataclass(tree):
        return fn(tree, *rest)
    return dataclasses.replace(
        tree,
        **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        },
    )
