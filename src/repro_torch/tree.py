"""Nested dict/list trees of tensors, walked as ``jax.tree`` walks a pytree:
dict keys sorted, lists in index order. The train state, the optimizer
state and the checkpoints use these paths (``params/layers/0/mixer/wq``)."""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} with '/'-joined paths, in leaf order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def leaves(tree) -> List[Any]:
    return list(flatten(tree).values())


def unflatten_into(template, flat: Dict[str, Any], prefix: str = ""):
    """A tree of ``template``'s structure whose leaves are ``flat[path]``."""
    if isinstance(template, dict):
        return {k: unflatten_into(template[k], flat, f"{prefix}{k}/")
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_into(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return flat[prefix[:-1]]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of trees of the same
    structure in ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
