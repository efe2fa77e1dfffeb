"""The parameter collections of ``repro_torch.optim``: a list (or tuple)
or a dict of tensors, mapped leaf by leaf (the reference's
``jax.tree.map`` over its parameter trees)."""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of a list/tuple or dict of tensors; a
    dict keeps ``tree``'s keys, a sequence becomes a list."""
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [fn(*leaves) for leaves in zip(tree, *rest, strict=True)]
    raise TypeError(f"a parameter collection is a list or a dict, got {type(tree).__name__}")


def leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)
