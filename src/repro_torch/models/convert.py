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
replaced by its block.  :func:`shard_flat` cuts a dense row into a rank's,
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

    def whole_spans(self) -> tuple:
        """Per group, the ``(start, stop)`` of every leaf a model-parallel
        rank holds whole (no dim on the model axis): each rank of the
        group holds the same copy."""
        spans = [[] for _ in range(self.n_groups)]
        for (name, _, off, n, g), d in zip(self._spans(), self.model_dims):
            if d is None:
                spans[g].append((off, off + n))
        return tuple(tuple(s) for s in spans)

    def shard(self, dims: dict, model: int, index: int, axis=None) -> "FlatLayout":
        """Rank ``index`` of ``model``'s layout: every leaf cut to its
        block along ``dims[name]`` (None: whole), same order and groups.
        ``axis``: the model group's topology view, which
        :meth:`autograd_leaves` hands the model."""
        shapes, offsets, sizes = [], [], [0] * self.n_groups
        for name, shape, g in zip(self.names, self.shapes, self.groups):
            d = dims[name]
            if d is not None:
                if shape[d] % model:
                    raise ValueError(f"{name}: dim {d} of {shape} does not split {model} ways")
                shape = shape[:d] + (shape[d] // model,) + shape[d + 1:]
            shapes.append(shape)
            offsets.append(sizes[g])
            sizes[g] += math.prod(shape)
        return dataclasses.replace(
            self, shapes=tuple(shapes), offsets=tuple(offsets), numel=sum(sizes),
            group_numels=tuple(sizes), model_dims=tuple(dims[n] for n in self.names),
            dense_shapes=self.shapes, model=model, model_index=index, axis=axis)

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
        return out if self.axis is None else ShardedParams(self, out)

    def autograd_leaves(self, flat, grad) -> dict:
        """``{path: leaf}`` views of the row ``flat`` that require grad and
        whose ``.grad`` is the matching view of ``grad``, so that backward
        accumulates IN PLACE into the flat gradient buffer (zero it first).
        Stacked block leaves (the decoder's and the encoder's) are split
        into a list of per-layer leaves.  A model-parallel rank's layout
        gives a :class:`ShardedParams`, which carries the model axis."""
        pv, gv = self.views(flat), self.views(grad)
        out = {} if self.axis is None else ShardedParams(self)
        for name in self.names:
            if name.startswith(STACKED):
                out[name] = [_leaf(p, g) for p, g in zip(pv[name], gv[name])]
            else:
                out[name] = _leaf(pv[name], gv[name])
        return out


STACKED = ("decoder.blocks.", "encoder.blocks.")


class ShardedParams(dict):
    """A model-parallel rank's ``{path: leaf}``: each leaf its block
    (:meth:`FlatLayout.shard`), with the rank's layout, whose ``axis`` is
    the model group.  ``models.transformer`` computes on it
    Megatron-split, or gathers the leaves at use."""

    def __init__(self, layout: "FlatLayout", *args):
        super().__init__(*args)
        self.layout = layout
        self._dims = dict(zip(layout.names, layout.model_dims))
        self.resolved = False    # transformer.serving_params has run on it

    def replace(self, leaves: dict, whole: bool = False) -> "ShardedParams":
        """A copy with ``leaves`` in place of its own; ``whole``: they are
        the dense leaves, held whole from now on (model dim None)."""
        out = ShardedParams(self.layout, {**self, **leaves})
        out._dims = {**self._dims, **(dict.fromkeys(leaves) if whole else {})}
        out.resolved = self.resolved
        return out

    def dim(self, name: str, layer: bool = False):
        """The model dim of leaf ``name`` (None: held whole); ``layer``:
        of one layer of a stacked leaf."""
        d = self._dims[name]
        if d is not None and layer and name.startswith(STACKED):
            d -= 1
        return d


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


def shard_flat(flat, dense: FlatLayout, rank: FlatLayout):
    """A rank's buffers (``rank``'s layout) from dense ones of ``dense``'s:
    ``(N,)`` rows or ``(W, N)`` worker rows, a tensor or Groups, each group
    in its own dtype (the f32 momentum of a bf16 model too)."""
    lead = parts(flat)[0].shape[:-1]
    out = _like(flat, rank.group_numels)
    src, dst = parts(flat), parts(out)
    for (name, shape, off, n, g), (_, rshape, roff, rn, _) in zip(dense._spans(),
                                                                  rank._spans()):
        d = rank.model_dims[rank.names.index(name)]
        leaf = src[g][..., off:off + n].reshape(*lead, *shape)
        block = shard_leaf(leaf, None if d is None else d + len(lead), rank.model,
                           rank.model_index)
        dst[g][..., roff:roff + rn].copy_(block.reshape(*lead, rn))
    return out


def gather_flat(flats: list, dense: FlatLayout, ranks: list):
    """Dense buffers from every model rank's (``flats[m]`` in
    ``ranks[m]``'s layout), the inverse of :func:`shard_flat`."""
    lead = parts(flats[0])[0].shape[:-1]
    out = _like(flats[0], dense.group_numels)
    dst = parts(out)
    for i, (name, shape, off, n, g) in enumerate(dense._spans()):
        d = ranks[0].model_dims[i]
        blocks = [parts(f)[g][..., lay.offsets[i]:lay.offsets[i] + math.prod(lay.shapes[i])]
                  .reshape(*lead, *lay.shapes[i]) for f, lay in zip(flats, ranks)]
        leaf = gather_leaf(blocks, None if d is None else d + len(lead))
        dst[g][..., off:off + n].copy_(leaf.reshape(*lead, n))
    return out


def from_jax_numpy(tree, cfg, n_workers: int, device=None, rank: FlatLayout = None):
    """The JAX package's params (numpy arrays, nested as the pytree or keyed
    by dotted pytree path) as the port's ``(n_workers, N)`` flat buffers,
    each leaf in its group's dtype (the reference's); every worker row
    holds the same params.  ``rank``: a model-parallel rank's layout
    (:meth:`FlatLayout.shard`), whose blocks of each leaf are cut out."""
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
    if rank is not None and rank.model > 1:
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
