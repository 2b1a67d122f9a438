"""Dtype groups: one flat buffer per parameter dtype.

The reference gives each parameter leaf its own dtype: a bf16 model keeps
its MoE router in f32 (``layers.init_moe``).  The port lays its leaves out
by dtype (``models.convert.FlatLayout``): the param dtype's group first,
then the others, each a flat buffer in ``jax.tree.leaves`` order.

A model whose leaves share one dtype has ONE group, and every buffer stays a
plain tensor.  A mixed-dtype model keeps a :class:`Groups` of tensors, one
per group, for each buffer of its training state, the f32 moments and
momentum included, so every elementwise step (the base optimizer's, the
worker mean, the global step) runs group by group over aligned buffers: one
kernel launch per group, each in its group's dtype.
"""

from __future__ import annotations

from typing import Callable

import torch


class Groups(tuple):
    """One buffer's tensors, one per dtype group, in the layout's group order."""

    def __repr__(self) -> str:
        return f"Groups{tuple.__repr__(self)}"


def parts(buf) -> tuple:
    """The groups of a buffer: its tensors, or the one plain tensor."""
    return tuple(buf) if isinstance(buf, Groups) else (buf,)


def each(fn: Callable, *bufs):
    """``fn`` over the aligned groups of ``bufs``, as a :class:`Groups` of
    its results; for plain tensors, ``fn(*bufs)``."""
    if isinstance(bufs[0], Groups):
        return Groups(fn(*p) for p in zip(*bufs, strict=True))
    return fn(*bufs)


def pick(tree, i: int):
    """Group ``i``'s part of a state tree: each :class:`Groups` replaced by
    its i-th tensor (NamedTuples and tuples kept, plain tensors as they are)."""
    if isinstance(tree, Groups):
        return tree[i]
    if isinstance(tree, tuple):
        picked = (pick(v, i) for v in tree)
        return type(tree)(*picked) if hasattr(tree, "_fields") else tuple(picked)
    return tree


def join(trees: list):
    """The inverse of :func:`pick`: per-group state trees of one form as
    one tree whose tensors are :class:`Groups`."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return Groups(trees)
    if isinstance(first, tuple):
        joined = (join(list(v)) for v in zip(*trees))
        return type(first)(*joined) if hasattr(first, "_fields") else tuple(joined)
    return first
