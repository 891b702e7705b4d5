"""Parameter trees of the port: nested dicts, lists, tuples and NamedTuples
of tensors, walked in the JAX package's pytree order (dict keys sorted, a
NamedTuple's fields in declaration order, sequences by index).

``flatten_with_paths`` names each leaf as the JAX package's checkpoints
do: the path's keys joined by ``/``, a dict key as itself, a sequence
index as its number and a NamedTuple field as ``.name`` (the string of
JAX's ``GetAttrKey``), e.g. ``params/mlp/w/0`` or ``opt/.m/users``.

Also the JAX package's tree helpers of ``utils.py`` (``tree_size``,
``tree_bytes``, ``tree_cast``, ``assert_tree_match``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np

from repro_torch.models.layers import tensor_from_jax


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node, is_leaf=None) -> Tuple[list, list]:
    """(keys, children) of an inner node; ``None`` keys for a leaf (or a
    node ``is_leaf`` takes for one)."""
    if is_leaf is not None and is_leaf(node):
        return None, None
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


def flatten_with_paths(tree: Any, prefix: str = "",
                       is_leaf=None) -> List[Tuple[str, Any]]:
    """[(path, leaf), ...] in JAX's leaf order (``is_leaf``: a predicate
    that ends the walk at a node, as JAX's)."""
    keys, kids = _children(tree, is_leaf)
    if keys is None:
        return [(prefix, tree)]
    out = []
    for k, c in zip(keys, kids):
        out.extend(flatten_with_paths(c, f"{prefix}/{k}" if prefix else k,
                                      is_leaf))
    return out


def tree_leaves(tree: Any, is_leaf=None) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree, is_leaf=is_leaf)]


def tree_unflatten(like: Any, leaves, is_leaf=None) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        keys, kids = _children(node, is_leaf)
        if keys is None:
            return next(it)
        return _rebuild(node, [build(c) for c in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the template has")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf=None) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which must have the same structure)."""
    leaves = tree_leaves(tree, is_leaf)
    others = [tree_leaves(r, is_leaf) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("tree_map: trees differ in structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)],
                          is_leaf)


def tree_size(tree: Any) -> int:
    """Total number of parameters in a tree."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_cast(tree: Any, dtype) -> Any:
    """Every floating leaf cast to ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def is_axes_leaf(x: Any) -> bool:
    """A logical-axes annotation: tuple of str/None (possibly empty)."""
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def assert_tree_match(params: Any, axes: Any) -> None:
    """Assert a params tree and its logical-axes tree line up: the same
    paths (axes tuples are leaves) and per-leaf rank agreement."""
    pl = flatten_with_paths(params)
    al = flatten_with_paths(axes, is_leaf=is_axes_leaf)
    if [k for k, _ in pl] != [k for k, _ in al]:
        raise ValueError(f"tree structure mismatch:\n{[k for k, _ in pl]}"
                         f"\nvs\n{[k for k, _ in al]}")
    for (k, p), (_, a) in zip(pl, al):
        if hasattr(p, "ndim") and len(a) != p.ndim:
            raise ValueError(f"axes rank mismatch at {k}: param shape "
                             f"{tuple(p.shape)} vs axes {a}")


def tree_from_jax(numpy_tree: Any, device="cuda") -> Any:
    """A tree of numpy arrays from the JAX side (``jax.tree_util.tree_map(
    np.asarray, params)``: dicts, lists of blocks, DCN's stacked (L, d, d)
    cross weights) -> the same tree of tensors on ``device``, values and
    dtypes unchanged (bfloat16 and float8_e4m3fn through
    ``tensor_from_jax``)."""
    return tree_map(lambda a: tensor_from_jax(np.asarray(a), device),
                    numpy_tree)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse of ``tree_from_jax``: every tensor leaf as a numpy array
    on the host (bfloat16 is not supported: numpy has none)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
