"""Pytrees of tensors: nested dicts and lists, as the reference's
parameter trees, walked in JAX's order (dict keys sorted) so leaf names
and sums agree with the reference; and :func:`value_and_grad`, the
counterpart of ``jax.value_and_grad`` over such a tree."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

__all__ = ["tree_leaves", "tree_map", "tree_unflatten",
           "tree_flatten_with_names", "value_and_grad"]


def tree_flatten_with_names(tree: Any, prefix: str = ""
                            ) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` with paths ``"layers/0/w"`` as the reference's
    checkpoint names them."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten_with_names(tree[k], join(k))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_flatten_with_names(v, join(i))]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_names(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(tree: Any, leaves) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def take(node):
        if isinstance(node, dict):
            return {k: take(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(take(v) for v in node)
        return next(it)

    return take(tree)


def value_and_grad(fn: Callable[[Any], torch.Tensor], params: Any
                   ) -> Tuple[torch.Tensor, Any]:
    """``(fn(params), d fn / d params)``: the gradient tree has the
    structure of ``params``; a leaf that ``fn`` does not reach gets zeros.
    ``params`` are not modified (the gradient flows through detached
    copies that require it)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if gr is None else gr
             for p, gr in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)
