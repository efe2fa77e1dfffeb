"""The parameter collections of ``repro_torch.optim``: a list (or tuple)
of tensors or a dict of tensors, dicts nested to any depth (the language
models' parameter trees), mapped leaf by leaf (the reference's
``jax.tree.map`` over its parameter trees)."""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of a list/tuple or (nested) dict of
    tensors; a dict keeps ``tree``'s keys, a sequence becomes a list."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [fn(*leaves) for leaves in zip(tree, *rest, strict=True)]
    raise TypeError(f"a parameter collection is a list or a dict, got {type(tree).__name__}")


def leaves(tree) -> list:
    """The tensors of ``tree`` in order: a dict's in key order, nested
    dicts depth first."""
    if isinstance(tree, dict):
        out = []
        for v in tree.values():
            out.extend(leaves(v) if isinstance(v, dict) else [v])
        return out
    return list(tree)
