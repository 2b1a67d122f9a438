"""The port's flat parameter layout, and the bridge from the JAX package's
parameters and training state to it.

Every parameter leaf is a view into a flat buffer of its dtype group, in
the order of ``jax.tree.leaves`` on the reference's params within the group
(dict keys sorted at every level, tuples in order), each leaf shaped as the
JAX leaf (stacked blocks keep their leading layer axis).  A model whose
leaves share one dtype has one group and one buffer; a mixed-dtype model
(an f32 router in a bf16 model) has one per dtype, the param dtype's first
(``repro_torch.groups``).  Training keeps ``(W, N)`` buffers of this layout
for params, gradients and AdamW moments, so each optimizer kernel is one
launch per group over all its leaves.  There is no per-leaf padding.

A rank of a model-parallel group holds its block of every leaf
(:meth:`FlatLayout.shard`: each leaf cut along the dim its placement puts
on the ``model`` axis, ``repro_torch.distributed.sharding``), in the same
order and dtype groups: its buffers are the dense ones with every leaf
replaced by its block.  Under FSDP (:meth:`FlatLayout.cut_zero`) each block
is cut once more, along the dim the placement puts on ``zero`` (a serving
rank's: on ``data``), into the rank's zero block; a leaf with no such dim
stays whole.  :func:`shard_flat` cuts a dense row into a rank's,
:func:`gather_flat` puts the ranks' rows back together.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.groups import Groups, each, parts


def flatten_tree(tree, is_leaf: Callable[[Any], bool] = lambda x: False,
                 prefix: str = "") -> list[tuple[str, Any]]:
    """``[(dotted path, leaf)]`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict) and not is_leaf(tree):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)) and not is_leaf(tree):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(flatten_tree(v, is_leaf, f"{prefix}.{k}" if prefix else k))
    return out


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Names, shapes, dtype groups and offsets of every leaf in the flat
    buffers: one buffer per dtype group (``repro_torch.groups``), each
    leaf at ``offsets[i]`` of group ``groups[i]``'s buffer.  ``numel`` is
    the total over all groups."""

    names: tuple
    shapes: tuple
    offsets: tuple
    leaves: tuple   # the spec tree's leaf values, in layout order
    numel: int
    groups: tuple         # each leaf's group index
    dtypes: tuple         # each group's dtype (None for an untyped spec)
    group_numels: tuple   # each group's element count
    # a model-parallel rank's layout (:meth:`shard`): each leaf's dim on the
    # model axis (None: held whole), the dense shapes, the group size and
    # this rank's index in it, and the model axis (the model group's
    # ``Topology`` view) that ``autograd_leaves`` hands the model
    model_dims: tuple = ()
    dense_shapes: tuple = ()
    model: int = 1
    model_index: int = 0
    axis: Any = dataclasses.field(default=None, compare=False)
    # an FSDP rank's layout (:meth:`cut_zero`): each leaf's dim on the zero
    # (or data) axis (None: whole over it), the group size, this rank's
    # index in it and the zero group's ``Topology`` view
    zero_dims: tuple = ()
    zero: int = 1
    zero_index: int = 0
    zero_axis: Any = dataclasses.field(default=None, compare=False)

    @classmethod
    def from_tree(cls, spec: dict, is_leaf, dtype_of=lambda leaf: None,
                  first=None) -> "FlatLayout":
        """``spec`` leaves are ``(shape, ...)``; ``dtype_of(leaf)`` gives a
        leaf's dtype.  The leaves are grouped by dtype, the group of
        ``first`` leading and the others in order of first appearance;
        within a group they keep the tree's order."""
        flat = flatten_tree(spec, is_leaf)
        dts = [dtype_of(leaf) for _, leaf in flat]
        order = sorted(dict.fromkeys(dts), key=lambda d: d != first)
        names, shapes, offsets, leaves, groups, sizes = [], [], [], [], [], []
        for g, dt in enumerate(order):
            off = 0
            for (name, leaf), d in zip(flat, dts):
                if d != dt:
                    continue
                shape = tuple(leaf[0])
                names.append(name)
                shapes.append(shape)
                offsets.append(off)
                leaves.append(leaf)
                groups.append(g)
                off += math.prod(shape)
            sizes.append(off)
        return cls(tuple(names), tuple(shapes), tuple(offsets), tuple(leaves), sum(sizes),
                   tuple(groups), tuple(order), tuple(sizes))

    @property
    def n_groups(self) -> int:
        return len(self.dtypes)

    @property
    def dense_numel(self) -> int:
        """The element count of the dense layout (``numel`` for a dense
        layout)."""
        if not self.dense_shapes:
            return self.numel
        return sum(math.prod(s) for s in self.dense_shapes)

    @property
    def sharded(self) -> bool:
        """A rank's layout that computes over a model or a zero group:
        :meth:`views` and :meth:`autograd_leaves` give a
        :class:`ShardedParams`."""
        return self.axis is not None or self.zero_axis is not None

    def uncounted_spans(self) -> tuple:
        """Per group, the ``(start, stop)`` of every leaf another rank
        counts in the stat sums: one held whole over the model axis on a
        model rank past the first, or whole over the zero axis on a zero
        rank past the first (each rank of such a group holds the same
        copy)."""
        spans = [[] for _ in range(self.n_groups)]
        none = (None,) * len(self.names)
        for (name, _, off, n, g), d, zd in zip(self._spans(), self.model_dims or none,
                                               self.zero_dims or none):
            if (d is None and self.model_index > 0) or (zd is None and self.zero_index > 0):
                spans[g].append((off, off + n))
        return tuple(tuple(s) for s in spans)

    def dense(self) -> "FlatLayout":
        """The dense layout this rank's layout cuts (itself for a dense
        layout): the same leaves, order and groups at their dense shapes."""
        if not self.dense_shapes:
            return self
        offsets, sizes = [], [0] * self.n_groups
        for shape, g in zip(self.dense_shapes, self.groups):
            offsets.append(sizes[g])
            sizes[g] += math.prod(shape)
        return FlatLayout(self.names, self.dense_shapes, tuple(offsets), self.leaves,
                          sum(sizes), self.groups, self.dtypes, tuple(sizes))

    def dense_index(self, bounds=None, device=None) -> tuple:
        """The rank's map into dense coordinates: per group ``(n, where)``,
        the dense group's element count and, for every element this rank's
        buffer holds (its ``bounds[g] = (start, stop)`` chunk of it where
        given: the worker peers' shard of a ZeRO-sharded global step), its
        index in the dense flat buffer of the group.  ``where`` is a slice
        for a dense layout, else an index tensor on ``device`` (int32 where
        the group's indices fit, else int64), built once from each leaf's
        model and zero blocks (:func:`shard_flat` of the dense positions):
        a leaf held whole maps every copy to the same dense elements."""
        dense = self.dense()
        chunks = bounds or [(0, n) for n in self.group_numels]
        if dense is self:
            return tuple((n, slice(a, b)) for n, (a, b) in zip(self.group_numels, chunks,
                                                              strict=True))
        rows = [torch.arange(n, dtype=torch.int64, device=device) for n in dense.group_numels]
        at = parts(shard_flat(rows[0] if len(rows) == 1 else Groups(rows), dense, self))
        return tuple((n, idx[a:b].to(torch.int32 if n <= 2 ** 31 else torch.int64, copy=True))
                     for n, idx, (a, b) in zip(dense.group_numels, at, chunks, strict=True))

    def _cut(self, dims: dict, ways: int) -> tuple:
        """(shapes, offsets, group sizes) with every leaf cut ``ways`` ways
        along ``dims[name]`` (None: whole)."""
        shapes, offsets, sizes = [], [], [0] * self.n_groups
        for name, shape, g in zip(self.names, self.shapes, self.groups):
            d = dims[name]
            if d is not None:
                if shape[d] % ways:
                    raise ValueError(f"{name}: dim {d} of {shape} does not split {ways} ways")
                shape = shape[:d] + (shape[d] // ways,) + shape[d + 1:]
            shapes.append(shape)
            offsets.append(sizes[g])
            sizes[g] += math.prod(shape)
        return tuple(shapes), tuple(offsets), tuple(sizes)

    def shard(self, dims: dict, model: int, index: int, axis=None) -> "FlatLayout":
        """Rank ``index`` of ``model``'s layout: every leaf cut to its
        block along ``dims[name]`` (None: whole), same order and groups.
        ``axis``: the model group's topology view, which
        :meth:`autograd_leaves` hands the model."""
        shapes, offsets, sizes = self._cut(dims, model)
        return dataclasses.replace(
            self, shapes=shapes, offsets=offsets, numel=sum(sizes),
            group_numels=sizes, model_dims=tuple(dims[n] for n in self.names),
            dense_shapes=self.shapes, model=model, model_index=index, axis=axis)

    def cut_zero(self, dims: dict, zero: int, index: int, axis=None) -> "FlatLayout":
        """FSDP: zero rank ``index`` of ``zero``'s layout of this (model
        block) layout: every leaf's block cut once more along ``dims[name]``
        (its dim on the zero axis; None: whole over it), same order and
        groups.  ``axis``: the zero group's topology view, which the model
        gathers each block over at use."""
        lay = self if self.model_dims else self.shard(dict.fromkeys(self.names), 1, 0)
        shapes, offsets, sizes = lay._cut(dims, zero)
        return dataclasses.replace(
            lay, shapes=shapes, offsets=offsets, numel=sum(sizes), group_numels=sizes,
            zero_dims=tuple(dims[n] for n in self.names), zero=zero, zero_index=index,
            zero_axis=axis)

    def _spans(self):
        for name, shape, off, g in zip(self.names, self.shapes, self.offsets, self.groups):
            yield name, shape, off, math.prod(shape), g

    def empty(self, lead: tuple = (), device=None):
        """Uninitialised buffers of this layout with leading dims ``lead``:
        a tensor for one group, else :class:`Groups`, each in its group's
        dtype."""
        bufs = [torch.empty(lead + (n,), dtype=dt, device=device)
                for dt, n in zip(self.dtypes, self.group_numels)]
        return bufs[0] if len(bufs) == 1 else Groups(bufs)

    def views(self, flat) -> dict:
        """``{path: view}`` into one ``(N,)`` row (a tensor, or
        :class:`Groups` of the groups' rows); a :class:`ShardedParams` for a
        model-parallel rank's layout with its model axis."""
        bufs = parts(flat)
        out = {name: bufs[g][off:off + n].view(shape)
               for name, shape, off, n, g in self._spans()}
        return ShardedParams(self, out) if self.sharded else out

    def autograd_leaves(self, flat, grad) -> dict:
        """``{path: leaf}`` views of the row ``flat`` that require grad and
        whose ``.grad`` is the matching view of ``grad``, so that backward
        accumulates IN PLACE into the flat gradient buffer (zero it first).
        Stacked block leaves (the decoder's and the encoder's) are split
        into a list of per-layer leaves.  A model-parallel rank's layout
        gives a :class:`ShardedParams`, which carries the model axis."""
        pv, gv = self.views(flat), self.views(grad)
        out = ShardedParams(self) if self.sharded else {}
        for name in self.names:
            if name.startswith(STACKED):
                out[name] = [_leaf(p, g) for p, g in zip(pv[name], gv[name])]
            else:
                out[name] = _leaf(pv[name], gv[name])
        return out


STACKED = ("decoder.blocks.", "encoder.blocks.")


class ShardedParams(dict):
    """A model-parallel or FSDP rank's ``{path: leaf}``: each leaf its block
    (:meth:`FlatLayout.shard`, :meth:`FlatLayout.cut_zero`), with the rank's
    layout, whose ``axis`` is the model group and ``zero_axis`` the zero
    (or data) group.  ``models.transformer`` gathers a zero block over the
    zero group where it is used, then computes on the model block
    Megatron-split, or gathers it too.  ``zero_mode``: the backward of that
    gather, ``"sum"`` where the zero ranks compute their own rows of the
    microbatch (the gradient reduce-scattered), ``"slice"`` where each
    computes the whole microbatch (each keeps its slice)."""

    def __init__(self, layout: "FlatLayout", *args):
        super().__init__(*args)
        self.layout = layout
        n = len(layout.names)
        self._dims = dict(zip(layout.names, layout.model_dims or (None,) * n))
        self._zdims = dict(zip(layout.names, layout.zero_dims or (None,) * n))
        self.resolved = False    # transformer.serving_params has run on it
        self.zero_mode = "slice"

    def replace(self, leaves: dict, whole: bool = False) -> "ShardedParams":
        """A copy with ``leaves`` in place of its own; ``whole``: they are
        the dense leaves, held whole from now on (model and zero dims None)."""
        out = ShardedParams(self.layout, {**self, **leaves})
        out._dims = {**self._dims, **(dict.fromkeys(leaves) if whole else {})}
        out._zdims = {**self._zdims, **(dict.fromkeys(leaves) if whole else {})}
        out.resolved, out.zero_mode = self.resolved, self.zero_mode
        return out

    def dim(self, name: str, layer: bool = False):
        """The model dim of leaf ``name`` (None: held whole); ``layer``:
        of one layer of a stacked leaf."""
        return _layer_dim(self._dims[name], name, layer)

    def zdim(self, name: str, layer: bool = False):
        """The zero dim of leaf ``name`` (None: whole over the zero axis);
        ``layer``: of one layer of a stacked leaf."""
        return _layer_dim(self._zdims[name], name, layer)


def _layer_dim(d, name: str, layer: bool):
    return d - 1 if d is not None and layer and name.startswith(STACKED) else d


def _leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    t = p.detach().requires_grad_(True)
    t.grad = g
    return t


def shard_leaf(t: torch.Tensor, dim, model: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``model`` of a dense leaf along ``dim`` (a view;
    the leaf itself for ``dim`` None)."""
    if dim is None:
        return t
    n = t.shape[dim] // model
    return t.narrow(dim, index * n, n)


def gather_leaf(blocks: list, dim) -> torch.Tensor:
    """The dense leaf from every rank's block in rank order (the inverse of
    :func:`shard_leaf`; the first block for ``dim`` None)."""
    return blocks[0] if dim is None else torch.cat(list(blocks), dim=dim)


def _like(flat, numels: tuple):
    """Empty buffers of ``flat``'s leading dims, dtypes and device, with
    ``numels`` elements per group (a tensor, or Groups as ``flat``)."""
    bufs = [torch.empty(t.shape[:-1] + (n,), dtype=t.dtype, device=t.device)
            for t, n in zip(parts(flat), numels, strict=True)]
    return Groups(bufs) if isinstance(flat, Groups) else bufs[0]


def _lead(d, lead) -> Any:
    return None if d is None else d + len(lead)


def shard_flat(flat, dense: FlatLayout, rank: FlatLayout):
    """A rank's buffers (``rank``'s layout) from dense ones of ``dense``'s:
    ``(N,)`` rows or ``(W, N)`` worker rows, a tensor or Groups, each group
    in its own dtype (the f32 momentum of a bf16 model too); each leaf cut
    to its model block, then to its zero block."""
    lead = parts(flat)[0].shape[:-1]
    out = _like(flat, rank.group_numels)
    src, dst = parts(flat), parts(out)
    for i, ((_, shape, off, n, g), (_, _, roff, rn, _)) in enumerate(zip(dense._spans(),
                                                                         rank._spans())):
        leaf = src[g][..., off:off + n].reshape(*lead, *shape)
        block = shard_leaf(leaf, _lead(rank.model_dims[i], lead), rank.model, rank.model_index)
        if rank.zero_dims:
            block = shard_leaf(block, _lead(rank.zero_dims[i], lead), rank.zero,
                               rank.zero_index)
        dst[g][..., roff:roff + rn].copy_(block.reshape(*lead, rn))
    return out


def gather_flat(flats: list, dense: FlatLayout, ranks: list):
    """Dense buffers from every rank's (``flats[r]`` in ``ranks[r]``'s
    layout: each model rank's, or under FSDP each (model, zero) rank's, in
    any order), the inverse of :func:`shard_flat`."""
    lead = parts(flats[0])[0].shape[:-1]
    out = _like(flats[0], dense.group_numels)
    dst = parts(out)
    at = {(lay.model_index, lay.zero_index): (f, lay) for f, lay in zip(flats, ranks)}
    models, zeros = sorted({m for m, _ in at}), sorted({z for _, z in at})
    for i, (name, shape, off, n, g) in enumerate(dense._spans()):
        zd = ranks[0].zero_dims[i] if ranks[0].zero_dims else None
        blocks = []
        for m in models:
            zs = [parts(f)[g][..., lay.offsets[i]:lay.offsets[i] + math.prod(lay.shapes[i])]
                  .reshape(*lead, *lay.shapes[i]) for f, lay in (at[(m, z)] for z in zeros)]
            blocks.append(gather_leaf(zs, _lead(zd, lead)))
        leaf = gather_leaf(blocks, _lead(ranks[0].model_dims[i], lead))
        dst[g][..., off:off + n].copy_(leaf.reshape(*lead, n))
    return out


def from_jax_numpy(tree, cfg, n_workers: int, device=None, rank: FlatLayout = None):
    """The JAX package's params (numpy arrays, nested as the pytree or keyed
    by dotted pytree path) as the port's ``(n_workers, N)`` flat buffers,
    each leaf in its group's dtype (the reference's); every worker row
    holds the same params.  ``rank``: a model-parallel rank's layout
    (:meth:`FlatLayout.shard`, under FSDP :meth:`FlatLayout.cut_zero`),
    whose blocks of each leaf are cut out."""
    from repro_torch.models.transformer import layout

    lay = layout(cfg)
    given = dict(flatten_tree(tree, is_leaf=lambda x: isinstance(x, np.ndarray)))
    if sorted(given) != sorted(lay.names):
        raise ValueError(f"param paths differ from the {cfg.name} layout: "
                         f"missing {sorted(set(lay.names) - set(given))}, "
                         f"unexpected {sorted(set(given) - set(lay.names))}")
    row = lay.empty()
    views = lay.views(row)
    for name, shape in zip(lay.names, lay.shapes):
        # via f32: numpy has no native bfloat16, and bf16 -> f32 is exact
        arr = np.asarray(given[name]).astype(np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, layout wants {shape}")
        views[name].copy_(torch.from_numpy(arr))
    if rank is not None and (rank.model > 1 or rank.zero > 1):
        row = shard_flat(row, lay, rank)
    return each(lambda r: r.to(device).unsqueeze(0).repeat(n_workers, 1), row)


def to_numpy(flat, cfg) -> dict:
    """``{path: f32 numpy array}`` of one flat ``(N,)`` row (for comparisons)."""
    from repro_torch.models.transformer import layout

    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in layout(cfg).views(flat).items()}


# ---------------------------------------------------------------------------
# Whole training states under the reference's pytree paths (checkpoints)
# ---------------------------------------------------------------------------

def state_fields(state) -> list:
    """``(name, value)`` of a training state: dataclass fields less its
    ``SCRATCH`` buffers, NamedTuple fields, dict items or sequence items."""
    if dataclasses.is_dataclass(state):
        skip = getattr(state, "SCRATCH", ())
        return [(f.name, getattr(state, f.name)) for f in dataclasses.fields(state)
                if f.name not in skip]
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return list(zip(state._fields, state))
    if isinstance(state, dict):
        return list(state.items())
    if isinstance(state, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(state)]
    return []


def leaf_tree(lay: FlatLayout, flat) -> dict:
    """``{"/"-joined leaf path: view}`` of an ``(N,)`` buffer, or of a
    ``(W, N)`` buffer with each leaf ``(W, *shape)`` as the reference's
    per-worker leaves (strided views, no copy); a :class:`Groups` buffer
    gives every group's leaves."""
    bufs = parts(flat)
    if bufs[0].dim() == 1:
        return {k.replace(".", "/"): v for k, v in lay.views(flat).items()}
    return {name.replace(".", "/"): bufs[g][:, off:off + n].view(bufs[g].shape[0], *shape)
            for name, shape, off, n, g in lay._spans()}


def _is_buffer(v) -> bool:
    """A state buffer in the layout: a tensor of one dimension or more, or
    the :class:`Groups` of one."""
    return isinstance(v, Groups) or (isinstance(v, torch.Tensor) and v.dim() > 0)


def state_to_tree(state, cfg) -> dict:
    """The state as nested dicts keyed like the reference's state pytree:
    ``params/<leaf>`` (W, *shape), ``x0/<leaf>``, ``m/<leaf>``,
    ``base_state/m/<leaf>``, ``t`` and ``inner`` (int32) for DSM.  Leaves
    are views of the state's buffers, each in its group's dtype; scratch
    buffers are left out."""
    from repro_torch.models.transformer import layout

    lay = layout(cfg)

    def conv(v):
        if _is_buffer(v):
            return leaf_tree(lay, v)
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, int):
            return torch.tensor(v, dtype=torch.int32)
        return {k: conv(x) for k, x in state_fields(v)}

    return conv(state)


def load_state_tree(state, tree: dict, cfg) -> None:
    """Copy a tree of :func:`state_to_tree`'s form (for example restored by
    ``checkpoint.restore``) into ``state``'s buffers in place; integer
    counters are set.  A leaf of another dtype or shape raises."""
    from repro_torch.models.transformer import layout

    lay = layout(cfg)

    def put(dst: torch.Tensor, src: torch.Tensor, what: str):
        if src.dtype != dst.dtype or tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{what}: {src.dtype} {tuple(src.shape)}, state holds "
                             f"{dst.dtype} {tuple(dst.shape)}")
        dst.copy_(src)

    def load(obj, sub, prefix):
        for name, v in state_fields(obj):
            what = f"{prefix}{name}"
            if _is_buffer(v):
                for path, view in leaf_tree(lay, v).items():
                    put(view, sub[name][path], f"{what}/{path}")
            elif isinstance(v, torch.Tensor):
                put(v, sub[name], what)
            elif isinstance(v, int):
                setattr(obj, name, int(sub[name]))
            else:
                load(v, sub[name], what + "/")

    load(state, tree, "")


def state_from_tree(tree: dict, cfg, base_opt, n_workers: int, device=None):
    """A ``DSMState`` on ``device`` from a tree of the reference's DSM state
    paths, for example the ``state`` subtree of a checkpoint that the JAX
    package's ``run_training(checkpoint_dir=...)`` wrote."""
    from repro_torch.core.dsm import dsm_init
    from repro_torch.models.transformer import layout

    x0 = each(torch.zeros_like, layout(cfg).empty(device=device))
    state = dsm_init(x0, base_opt, n_workers)
    load_state_tree(state, tree, cfg)
    return state
