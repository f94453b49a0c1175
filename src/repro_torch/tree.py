"""Trees of tensors: nested dicts and lists, the port's pytrees.

Counterpart of the few ``jax.tree_util`` functions the reference's training
path uses. Leaves are visited in ``jax.tree_util``'s order (dict keys
sorted, list items in order), so that a per-leaf loop (the optimizer's
global norm) sums in the reference's order, and each leaf is named by its
``jax.tree_util.keystr`` path, e.g. ``['opt']['m']['blocks']['attn']['wq']``
(the checkpoint's keys).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching nodes of ``rest``
    (the structure is ``tree``'s: a node of ``rest`` where ``tree`` has a
    leaf goes to ``fn`` whole, as ``flatten_up_to`` does)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def items(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in the reference's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's order."""
    return [leaf for _, leaf in items(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure with ``new_leaves`` (in :func:`leaves` order)."""
    it = iter(new_leaves)
    return _rebuild(tree, {key: next(it) for key, _ in items(tree)}, "")


def _rebuild(tree, order: dict, prefix: str):
    if isinstance(tree, dict):
        return {k: _rebuild(v, order, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, order, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return order[prefix]
