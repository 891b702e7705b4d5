"""Parameter trees of the port: nested dicts, lists, tuples and NamedTuples
of tensors, walked in the JAX package's pytree order (dict keys sorted, a
NamedTuple's fields in declaration order, sequences by index).

``flatten_with_paths`` names each leaf as the JAX package's checkpoints
do: the path's keys joined by ``/``, a dict key as itself, a sequence
index as its number and a NamedTuple field as ``.name`` (the string of
JAX's ``GetAttrKey``), e.g. ``params/mlp/w/0`` or ``opt/.m/users``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np

from repro_torch.models.layers import tensor_from_jax


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Tuple[list, list]:
    """(keys, children) of an inner node; ``None`` keys for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return [str(k) for k in keys], [node[k] for k in keys]
    if _is_namedtuple(node):
        return ["." + f for f in node._fields], list(node)
    if isinstance(node, (list, tuple)):
        return [str(i) for i in range(len(node))], list(node)
    return None, None


def _rebuild(node, values: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), values))
    if _is_namedtuple(node):
        return type(node)(*values)
    return type(node)(values)


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf), ...] in JAX's leaf order."""
    keys, kids = _children(tree)
    if keys is None:
        return [(prefix, tree)]
    out = []
    for k, c in zip(keys, kids):
        out.extend(flatten_with_paths(c, f"{prefix}/{k}" if prefix else k))
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        keys, kids = _children(node)
        if keys is None:
            return next(it)
        return _rebuild(node, [build(c) for c in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the template has")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which must have the same structure)."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("tree_map: trees differ in structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])


def tree_from_jax(numpy_tree: Any, device="cuda") -> Any:
    """A tree of numpy arrays from the JAX side (``jax.tree_util.tree_map(
    np.asarray, params)``: dicts, lists of blocks, DCN's stacked (L, d, d)
    cross weights) -> the same tree of tensors on ``device``, values and
    dtypes unchanged (bfloat16 through ``tensor_from_jax``)."""
    return tree_map(lambda a: tensor_from_jax(np.asarray(a), device),
                    numpy_tree)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse of ``tree_from_jax``: every tensor leaf as a numpy array
    on the host (bfloat16 is not supported: numpy has none)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
