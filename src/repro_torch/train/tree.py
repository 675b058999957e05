"""Trees of tensors (nested dicts, lists and tuples): the few `jax.tree`
operations the training substrate and the static checker use.  Leaves are
visited in the reference's flatten order (dict keys sorted, lists and
tuples by index), which fixes the order of sums over leaves such as
`optimizer.global_norm` and the paths the static checker reports.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn(leaf, *matching)` over the leaves of `tree`, each called with the
    subtrees of `rest` at the same keys; the result keeps `tree`'s
    container types and key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in flatten order; a path joins the keys and
    indices from the root with "/" (the reference's `_flatten_paths`)."""
    return list(_iter_leaves(tree, ()))


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of `tree`, dict keys sorted as `jax.tree.leaves` does."""
    return [leaf for _, leaf in _iter_leaves(tree, ())]


def _iter_leaves(tree: Any, pre: Tuple[str, ...]) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _iter_leaves(tree[k], pre + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, pre + (str(i),))
    else:
        yield "/".join(pre), tree


def tree_replace(tree: Any, leaves: List[Any]) -> Any:
    """`tree` with its leaves replaced, in `tree_leaves` order, by
    `leaves`."""
    it = iter(leaves)

    def walk(t: Any) -> Any:
        if isinstance(t, dict):
            new = {k: walk(t[k]) for k in sorted(t, key=str)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)

    out = walk(tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_unzip(tree: Any, n: int) -> Tuple[Any, ...]:
    """A tree of nested dicts whose leaves are n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tuple(tree)
