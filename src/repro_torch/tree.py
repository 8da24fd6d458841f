"""Parameter trees: nested dicts, lists and tuples of tensors (or arrays).

The reference walks its trees with ``jax.tree_util``, whose order is the
one that matters here: dict keys sorted (``t0, t1, t10, t11, ...``),
sequence items in order.  The optimizer sums its global norm and the
checkpoint names its files in that order, so both packages agree leaf for
leaf.  A leaf is anything that is not a dict, list or tuple.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Sequence, Tuple

Path = Tuple[Any, ...]


def flatten_with_path(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util`` order: a path holds the
    dict keys and sequence indices from the root to the leaf."""
    if isinstance(tree, Mapping):
        return [pair for k in sorted(tree)
                for pair in flatten_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in flatten_with_path(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_name(path: Path) -> str:
    """``params/tables/t0/table`` style: the reference's checkpoint names."""
    return "/".join(str(k) for k in path)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(template: Any, new_leaves: Sequence[Any]) -> Any:
    """``template``'s structure with its leaves, in flatten order, replaced
    by ``new_leaves``."""
    n = len(leaves(template))
    if n != len(new_leaves):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {n}")
    return _build(template, iter(new_leaves))


def _build(t: Any, it) -> Any:
    # a module-level function, not a closure: a nested function that
    # calls itself is a reference cycle, which would hold the leaves (a
    # step's gradients) until the garbage collector runs
    if isinstance(t, Mapping):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)
