"""Tensor-parallel operations over the model group of a rank
(``Topology.mp``): Megatron's conjugate pair, the gather of a sharded leaf,
the vocab-parallel embedding and cross-entropy, and the rank layout.

The reference needs none of this: XLA's partitioner writes the collectives
that its placements (``distributed/sharding.py``) imply.  The port runs
one process per rank, so the model (``models/transformer.py``) calls these
``torch.autograd.Function``s where the placements cut a product:

  * :func:`copy_to` — identity forward, all-reduce backward: the input of a
    column-parallel product (each rank's gradient of it is partial), and a
    whole leaf that such a product consumes;
  * :func:`reduce_from` — all-reduce forward, identity backward: the output
    of a row-parallel product (each rank holds a partial sum);
  * :func:`gather` — all-gather forward along a dim; backward either the
    rank's block of the gradient (``"slice"``: the leaf is used where every
    rank computes the same thing, so every rank holds the whole gradient)
    or a reduce-scatter (``"sum"``: every rank holds a partial gradient);
  * :func:`vocab_embed` and :func:`vocab_cross_entropy` over a vocab-sharded
    table, and :func:`vocab_argmax`, serving's greedy (and Gumbel) pick over
    vocab-sharded logits.

Sequence parallelism (``cfg.attn_seq_shard``, :func:`seq_shard`) adds the
pair that replaces :func:`copy_to` / :func:`reduce_from` where a rank holds
its block of the sequence: :func:`gather` over the sequence (``"sum"``)
in front of a column-parallel product and :func:`reduce_scatter` after a
row-parallel one; :func:`split` (the rank's block, all-gather backward)
and :func:`own_rows` (identity, the gradient kept on the rank's block)
turn a tensor every rank computes alike into the rank's block and back.

A bf16 activation is all-reduced in f32 and rounded once: each rank's
partial sum is rounded to bf16 by its product, the sum of the M partials
is exact to f32 and rounded to bf16 again (the rounding model PERF.md
states).  A bf16 gradient is reduce-scattered the same way (``"sum"``
backward of :func:`gather`): each rank's partial gradient, rounded to bf16
by its product, is widened to f32, the partials summed in f32 and the
rank's block rounded to bf16 once.  Every collective goes through
``distributed/comm.py``, so ``CommStats`` counts it under ``<name>@model``
(``<name>@zero`` / ``<name>@data`` over the zero / data group).

FSDP uses the same functions over the rank's zero group
(``Topology.zp``) or, serving, its data group (``Topology.data``): a leaf
that the placement cuts over ``zero`` is gathered at use to the rank's
model block (:func:`gather`, ``"sum"`` where the zero ranks compute their
own rows of the microbatch, ``"slice"`` where each computes the whole
microbatch), and one it holds whole is :func:`copy_to` where the rows are
split.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.distributed import comm, sharding
from repro_torch.models import convert as C
from repro_torch.models.convert import FlatLayout

F32 = torch.float32


def _all_reduce(t: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op``) of ``t`` over the model group, a new tensor in
    t's dtype; a bf16 / f16 ``t`` is summed in f32 and rounded once."""
    wide = t.to(F32) if t.dtype in (torch.bfloat16, torch.float16) else t.clone()
    return comm.all_reduce(wide, axis, op).to(t.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mode):
        ctx.axis, ctx.dim, ctx.mode = axis, dim, mode
        return comm.all_gather_dim(x.contiguous(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.mode == "sum":
            wide = g.to(F32) if g.dtype in (torch.bfloat16, torch.float16) else g
            out = comm.reduce_scatter_dim(wide.contiguous(), ctx.axis, ctx.dim)
            return out.to(g.dtype), None, None, None
        n = g.shape[ctx.dim] // ctx.axis.world
        return g.narrow(ctx.dim, ctx.axis.rank * n, n).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        wide = x.to(F32) if x.dtype in (torch.bfloat16, torch.float16) else x
        return comm.reduce_scatter_dim(wide.contiguous(), axis, dim).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather_dim(g.contiguous(), ctx.axis, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = x.shape[dim] // axis.world
        return x.narrow(dim, axis.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather_dim(g.contiguous(), ctx.axis, ctx.dim), None, None


class _OwnRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.axis.world
        out = torch.zeros_like(g)
        out.narrow(ctx.dim, ctx.axis.rank * n, n).copy_(g.narrow(ctx.dim, ctx.axis.rank * n, n))
        return out, None, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient backward."""
    return _Copy.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """All-reduce forward (bf16 summed in f32, rounded once), identity
    backward."""
    return _Reduce.apply(x, axis)


def gather(x: torch.Tensor, axis, dim: int, mode: str = "slice") -> torch.Tensor:
    """Every rank's block of a leaf along ``dim``, concatenated: the leaf.
    Backward: the rank's block of the gradient (``"slice"``) or the
    reduce-scatter of the partial gradients (``"sum"``; bf16 summed in
    f32, rounded once)."""
    if mode not in ("slice", "sum"):
        raise ValueError(f"mode must be 'slice' or 'sum', got {mode!r}")
    return _Gather.apply(x, axis, dim, mode)


def reduce_scatter(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The sum over the group of each rank's partial ``x``, cut into
    ``world`` blocks along ``dim``: the rank's block (bf16 summed in f32,
    rounded once).  Backward: the blocks' gradients all-gathered."""
    return _Scatter.apply(x, axis, dim)


def split(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The rank's block along ``dim`` of ``x``, which every rank of the
    group computes alike.  Backward: the blocks' gradients all-gathered, so
    every rank holds the whole gradient of ``x``."""
    return _Split.apply(x, axis, dim)


def own_rows(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """``x`` itself, used alike on every rank where it came from a
    ``"sum"`` :func:`gather`: backward, only the rank's block of the (whole)
    gradient along ``dim`` is kept, so the gather's reduce-scatter sums it
    once."""
    return _OwnRows.apply(x, axis, dim)


def column_input(h: torch.Tensor, axis, sp=None) -> torch.Tensor:
    """The input of column-parallel products: :func:`copy_to` of ``h``, or
    under sequence parallelism (``sp``, :func:`seq_shard`) the rank's block
    of the sequence (dim 1) gathered, its gradient reduce-scattered."""
    return copy_to(h, axis) if sp is None else gather(h, axis, 1, "sum")


def row_output(y: torch.Tensor, axis, sp=None) -> torch.Tensor:
    """The output of a row-parallel product: :func:`reduce_from`, or under
    sequence parallelism the rank's block of the sequence (dim 1),
    reduce-scattered."""
    return reduce_from(y, axis) if sp is None else reduce_scatter(y, axis, 1)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, axis, sp=None) -> torch.Tensor:
    """Rows of a vocab-sharded table (this rank's ``(V / M, d)`` block):
    each rank looks up the tokens in its block, zeros the others, and the
    blocks are summed over the group (exact: one non-zero term per
    element).  The gradient reaches the rank's rows only.  ``sp``: the sum
    is reduce-scattered over the sequence (:func:`row_output`)."""
    n = table.shape[0]
    local = tokens - axis.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return row_output(rows, axis, sp)


class _VocabCE(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[target]`` over vocab-sharded
    f32 logits: the maximum, the sum of exponentials and the gold logit
    each all-reduced over the group."""

    @staticmethod
    def forward(ctx, logits, targets, axis):
        n = logits.shape[-1]
        top = _all_reduce(logits.max(dim=-1).values, axis, "max")
        e = torch.exp(logits - top[..., None])
        lse = torch.log(_all_reduce(e.sum(dim=-1), axis)) + top
        local = targets - axis.rank * n
        mine = (local >= 0) & (local < n)
        idx = torch.where(mine, local, torch.zeros_like(local))
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = _all_reduce(torch.where(mine, gold, torch.zeros_like(gold)), axis)
        ctx.save_for_backward(e, lse - top, idx, mine)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        e, log_sum, idx, mine = ctx.saved_tensors
        grad = e * torch.exp(-log_sum)[..., None] * g[..., None]
        hit = torch.where(mine, g, torch.zeros_like(g))
        grad.scatter_add_(-1, idx[..., None], -hit[..., None])
        return grad, None, None


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, axis) -> torch.Tensor:
    """Per-token cross-entropy over this rank's ``(..., V / M)`` block of
    f32 logits (vocab rows ``[rank * V/M, (rank + 1) * V/M)``)."""
    return _VocabCE.apply(logits, targets, axis)


def vocab_argmax(logits: torch.Tensor, axis, valid: int) -> torch.Tensor:
    """(B,) int64 global ids: the argmax over the whole vocab of this rank's
    ``(B, V / M)`` block of logits (vocab rows ``[rank * V/M, (rank + 1) *
    V/M)``), rows at or past ``valid`` (the unpadded vocab) masked out on
    the rank that holds them: the largest logit all-reduced over the group,
    then the lowest global id that attains it, also all-reduced
    (``torch.argmax``'s tie rule on the dense logits)."""
    n = logits.shape[-1]
    ids = torch.arange(n, device=logits.device) + axis.rank * n
    x = logits.masked_fill(ids >= valid, float("-inf"))
    top = _all_reduce(x.max(dim=-1).values, axis, "max")
    first = torch.where(x == top[:, None], ids, torch.iinfo(torch.int64).max).min(dim=-1).values
    return _all_reduce(first, axis, "min")


def noise_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of model rank ``index``'s sampling noise: seeded by
    ``(seed, index)``, so that the ranks draw independent noise for their
    vocab blocks."""
    import numpy as np

    state = int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def serve_rows(batch: int, topo) -> slice:
    """The rows of a ``batch``-sequence batch that a serving rank serves:
    its data row's ``batch / D`` where the reference's ``serve_batch_pspecs``
    puts the batch on ``data`` (``batch % D == 0``, ``batch >= D``), else
    every row (the sequence may then lie over data: :func:`serve_split`)."""
    data = 1 if topo is None else topo.worker
    spec = sharding.serve_batch_pspecs({"tokens": ((batch, 1), torch.int64)}, data, 1)
    if data == 1 or spec["tokens"][0] != "data":
        return slice(0, batch)
    n = batch // data
    return slice(topo.worker_index * n, (topo.worker_index + 1) * n)


class SeqSplit(NamedTuple):
    """A sequence of ``length`` positions (a prefill's decoder sequence, or
    the slots of a full-attention layer's cache) over the ``world`` ranks
    of a serving rank's data group in contiguous blocks of ``n``: data
    rank ``index`` holds ``[start, stop)``.  ``axis``: the data group
    (``Topology.data``) the model's collectives run over (None where only
    the positions are reckoned)."""

    length: int
    world: int
    index: int
    axis: Any = None

    @property
    def n(self) -> int:
        return self.length // self.world

    @property
    def start(self) -> int:
        return self.index * self.n

    @property
    def stop(self) -> int:
        return self.start + self.n


def _seq_split(batch: int, length: int, data: int, index: int, axis) -> Optional[SeqSplit]:
    """Data rank ``index``'s block of ``length`` positions, or None: where
    D = 1, where there are none, where the batch splits over data
    (:func:`serve_rows`) or where ``length`` does not divide into D
    blocks (the sequence is then whole on every data row, the reference's
    own rule)."""
    spec = sharding.serve_batch_pspecs({"tokens": ((batch, 1), torch.int64)}, data, 1)
    if data == 1 or not length or length % data or spec["tokens"][0] == "data":
        return None
    return SeqSplit(length, data, index, axis)


def seq_shard(cfg, layout: FlatLayout, length: int) -> Optional[SeqSplit]:
    """The rank's block of a ``length``-position sequence over its model
    group under sequence parallelism (``cfg.attn_seq_shard``, the
    reference's ``P(None, "model", None)`` on the residual stream and the
    attention's activations): model rank ``m`` of ``M`` holds positions
    ``[m S / M, (m + 1) S / M)``.  None (the sequence whole, as without
    the flag) where the flag is off, the layout is not model-parallel or
    ``length`` does not divide into M blocks (the rule of
    :func:`_seq_split`; the reference's partitioner pads instead).  Where
    a prefill's sequence also lies over data (:func:`serve_split`),
    ``length`` is the data rank's chunk and the block is one of that chunk:
    positions ``[start + m n / M, start + (m + 1) n / M)`` of the chunk
    ``[start, start + n)``."""
    M = layout.model
    if not cfg.attn_seq_shard or M == 1 or not length or length % M:
        return None
    return SeqSplit(length, M, layout.model_index, layout.axis)


def serve_split(batch: int, n0: int, new: int, cfg, data: int = 1, index: int = 0,
                axis=None) -> tuple:
    """(the prefill's chunk of its ``n0`` positions, each full-attention
    cache's block of its ``n0 + new`` slots) of data rank ``index`` of
    ``data``, where a serving call's sequence lies over its data group
    (``axis``, ``Topology.data``): the reference's fallback when a
    ``batch``-sequence batch does not split (``serve_batch_pspecs``: B over
    data, else S; ``cache_pspecs``: the first dim that divides).  Each is
    None where it stays whole (:func:`_seq_split`); ``n0`` 0: a decode
    alone, over a cache of ``new`` slots.

    The prefill's positions (a VLM's ``n_patches`` and the prompt) are
    what an ``ssm`` model's SSD chunks: like the dense path it refuses
    ``n0`` past ``layers.SSD_CHUNK`` and no multiple of it (ValueError),
    and a block past the chunk and no multiple of it is not split (whole,
    as D blocks it cannot scan).  A cache's slots are read block by block
    (``transformer.decode_step``), never held to that."""
    from repro_torch.models.layers import SSD_CHUNK

    seq = _seq_split(batch, n0, data, index, axis)
    if any(k.startswith("ssm") for k in cfg.pattern):
        if n0 > SSD_CHUNK and n0 % SSD_CHUNK:
            raise ValueError(f"sequence length must be divisible by ssd chunk: S={n0}, "
                             f"chunk={SSD_CHUNK}")
        if seq is not None and seq.n > SSD_CHUNK and seq.n % SSD_CHUNK:
            seq = None
    return seq, _seq_split(batch, n0 + new, data, index, axis)


def shard_leaf(t: torch.Tensor, spec: tuple, model: int, index: int) -> torch.Tensor:
    """Rank ``index``'s block of a dense leaf by its placement ``spec``
    (the dim on the ``model`` axis cut ``model`` ways; a view)."""
    return C.shard_leaf(t, sharding.model_dim(spec), model, index)


def gather_leaf(blocks: list, spec: tuple) -> torch.Tensor:
    """The dense leaf from every model rank's block in rank order: the
    inverse of :func:`shard_leaf`."""
    return C.gather_leaf(blocks, sharding.model_dim(spec))


# ---------------------------------------------------------------------------
# The rank layout
# ---------------------------------------------------------------------------

def model_dims(cfg, model: int, replicate_names: tuple = ()) -> dict:
    """``{leaf: its dim on the model axis, or None}`` of ``cfg``'s params:
    the reference's ``param_pspecs(..., model=model)`` on the dense shapes
    (the same dims as its per-worker and global placements, less the
    worker dim)."""
    return _placement_dims(cfg, model, 1, ("zero",), replicate_names, "model")


def zero_dims(cfg, model: int, zero: int, zero_axes: tuple = ("zero",),
              replicate_names: tuple = ()) -> dict:
    """``{leaf: its dim on the zero axis, or None}``: the dim the
    reference's ``param_pspecs(..., model=model, zero=zero)`` puts on
    ``zero_axes`` (``("zero",)`` for the worker params and base state,
    ``("data",)`` for the serving params): the largest dim divisible by
    ``zero`` that is neither the model dim nor a stacked layer dim."""
    return _placement_dims(cfg, model, zero, zero_axes, replicate_names, zero_axes[0])


def _placement_dims(cfg, model, zero, zero_axes, replicate_names, axis) -> dict:
    from repro_torch.models.transformer import layout

    lay = layout(cfg)
    specs = sharding.param_pspecs(dict(zip(lay.names, lay.shapes)), model=model, zero=zero,
                                  zero_axes=zero_axes, replicate_names=replicate_names)
    return {name: sharding.model_dim(spec, axis) for name, spec in specs.items()}


def rank_layout(cfg, model: int, index: int, axis=None, replicate_names: tuple = (),
                zero: int = 1, zero_index: int = 0, zero_axis=None,
                zero_axes: tuple = ("zero",)) -> FlatLayout:
    """Model rank ``index`` of ``model``'s flat layout: every leaf cut by
    its placement (:func:`model_dims`).  ``axis``: the rank's model group
    (``topo.mp``), which the model then computes over.  With ``zero`` > 1
    (FSDP) each block is cut once more by :func:`zero_dims` into zero rank
    ``zero_index``'s, gathered at use over ``zero_axis``."""
    from repro_torch.models.transformer import layout

    lay = layout(cfg).shard(model_dims(cfg, model, replicate_names), model, index, axis)
    if zero == 1:
        return lay
    return lay.cut_zero(zero_dims(cfg, model, zero, zero_axes, replicate_names), zero,
                        zero_index, zero_axis)


def topology_layout(cfg, topo, replicate_names: tuple = ()) -> FlatLayout:
    """The layout of ``topo``'s rank: the dense layout for ``model`` = 1,
    else :func:`rank_layout` over ``topo.mp``; under FSDP its blocks cut
    over the zero group (``fsdp="zero"``: ``zero`` ways, gathered over
    ``topo.zp``) or the data group (``fsdp="data"``: the D data rows,
    ``topo.data``)."""
    from repro_torch.models.transformer import layout

    if topo is None:
        return layout(cfg)
    Z, index, view, axes = {"zero": (topo.zero, topo.zero_index, "zp", ("zero",)),
                            "data": (topo.worker, topo.worker_index, "data", ("data",)),
                            "": (1, 0, None, ("zero",))}[topo.fsdp]
    if topo.model == 1 and Z == 1:
        return layout(cfg)
    return rank_layout(cfg, topo.model, topo.model_index,
                       topo.mp if topo.model > 1 else None, replicate_names, Z, index,
                       getattr(topo, view) if Z > 1 else None, axes)


def zero_split(layout: FlatLayout, b_micro: int) -> bool:
    """The zero ranks of an FSDP layout each compute their ``b_micro / Z``
    rows of a microbatch: the reference's ``train_batch_pspecs`` puts
    ``B_micro`` on ``zero`` (``b_micro % Z == 0``); else each computes the
    whole microbatch."""
    if layout.zero == 1:
        return False
    spec = sharding.train_batch_pspecs({"tokens": ((1, 1, 1, b_micro, 1), torch.int64)},
                                       zero=layout.zero)
    return spec["tokens"][3] == "zero"


def zero_rows(layout: FlatLayout, b_micro: int) -> slice:
    """The rows of a ``b_micro``-row microbatch that this zero rank
    computes (:func:`zero_split`; every row where the batch is whole over
    zero)."""
    if not zero_split(layout, b_micro):
        return slice(0, b_micro)
    n = b_micro // layout.zero
    return slice(layout.zero_index * n, (layout.zero_index + 1) * n)


class _Reckoning:
    """The collectives of a rank's layout, added up as ``CommStats`` counts
    them: ``{"<name>@model": {"calls", "bytes"}}``, and under FSDP the zero
    (or data) group's as ``<name>@zero`` (``@data``)."""

    def __init__(self, layout: FlatLayout, zero_axis: str = "zero"):
        self.layout, self.out, self.zero_axis = layout, {}, zero_axis
        self._index = {n: i for i, n in enumerate(layout.names)}

    def add(self, name: str, nbytes: int, calls: int = 1, axis: str = "model") -> None:
        if calls == 0:
            return
        rec = self.out.setdefault(f"{name}@{axis}", {"calls": 0, "bytes": 0})
        rec["calls"] += calls
        rec["bytes"] += nbytes * calls

    def stacked(self, name: str) -> bool:
        return name.startswith(C.STACKED)

    def dim(self, name: str):
        d = self.layout.model_dims[self._index[name]]
        return None if d is None else d - self.stacked(name)

    def zdim(self, name: str):
        if self.layout.zero == 1:
            return None
        return self.layout.zero_dims[self._index[name]]

    def layer_count(self, name: str) -> int:
        return self.layout.shapes[self._index[name]][0] if self.stacked(name) else 1

    def zero_numel(self, name: str) -> int:
        """Elements of one layer of the rank's zero block of the leaf (its
        model block where it is whole over zero)."""
        shape = self.layout.shapes[self._index[name]]
        return math.prod(shape[1:] if self.stacked(name) else shape)

    def block_numel(self, name: str) -> int:
        """Elements of one layer of the rank's model block of the leaf."""
        return self.zero_numel(name) * (self.layout.zero if self.zdim(name) is not None else 1)

    def itemsize(self, name: str) -> int:
        return self.layout.dtypes[self.layout.groups[self._index[name]]].itemsize

    def gather(self, name: str, calls: int = None) -> None:
        """A leaf gathered at use over the model group, layer by layer: each
        rank sends its model block."""
        if self.dim(name) is not None:
            self.add("all_gather", self.block_numel(name) * self.itemsize(name),
                     self.layer_count(name) if calls is None else calls)

    def zero_use(self, name: str, fwd: int, bwd: int = 0, mode: str = "slice") -> None:
        """A leaf's zero block gathered over the zero group at each of
        ``fwd`` forward uses (each rank sends its zero block); in ``"sum"``
        mode each of ``bwd`` backward uses reduce-scatters its gradient, or
        all-reduces it for a leaf held whole over zero (f32, the model
        block's elements)."""
        if self.layout.zero == 1:
            return
        ax = self.zero_axis
        if self.zdim(name) is not None:
            self.add("all_gather", self.zero_numel(name) * self.itemsize(name), fwd, ax)
            if mode == "sum":
                self.add("reduce_scatter", self.block_numel(name) * 4, bwd, ax)
        elif mode == "sum":
            self.add("all_reduce_sum", self.block_numel(name) * 4, bwd, ax)

    def layer_groups(self, cfg):
        """``(prefix, kind, layers)`` of each layer group: the decoder's
        stacked pattern positions and remainder layers, then an ``encdec``
        model's encoder blocks (``transformer._layers``)."""
        from repro_torch.models import transformer as T

        if cfg.n_scan_blocks:
            for j, kind in enumerate(cfg.pattern):
                yield f"decoder.blocks.p{j}.", kind, cfg.n_scan_blocks
        for i in range(cfg.n_rem_layers):
            yield f"decoder.rem.{i}.", cfg.pattern[i], 1
        if cfg.family == "encdec" and cfg.enc_layers:
            yield "encoder.blocks.p0.", T.ENC_PATTERN[0], cfg.enc_layers

    def tail(self, cfg, pre: str) -> bool:
        """``pre`` is the last layer of its stack's pattern repeat, the end
        of a checkpointed body (``transformer._run_stack``)."""
        last = 0 if pre.startswith("encoder.") else len(cfg.pattern) - 1
        return pre.endswith(f".blocks.p{last}.")

    def layer_leaves(self, pre: str) -> list:
        """The names of a decoder layer group's leaves (``pre``: its prefix)."""
        return [n for n in self.layout.names if n.startswith(pre)]

    def partial(self, name: str, fwd: int, bwd: int) -> None:
        """A leaf taken whole where each rank uses a part of it
        (``transformer._Leaves.full_partial``): gathered at each of ``fwd``
        forward uses, its f32 gradient reduce-scattered at each of ``bwd``
        backward ones; one held whole has its gradient all-reduced."""
        if self.dim(name) is None:
            self.add("all_reduce_sum", self.block_numel(name) * 4, bwd)
        else:
            self.add("all_gather", self.block_numel(name) * self.itemsize(name), fwd)
            self.add("reduce_scatter", self.block_numel(name) * self.layout.model * 4, bwd)

    def seq_in(self, cfg, tokens: int, fwd: int, bwd: int) -> None:
        """Under sequence parallelism, the ``tokens`` rows' blocks gathered
        in front of column-parallel products (``column_input``): each rank
        sends its block at each of ``fwd`` uses, and the f32 gradient is
        reduce-scattered at each of ``bwd``."""
        d, act = cfg.d_model, cfg.act_dtype.itemsize
        self.add("all_gather", tokens // self.layout.model * d * act, fwd)
        self.add("reduce_scatter", tokens * d * 4, bwd)

    def seq_out(self, cfg, tokens: int, fwd: int, bwd: int) -> None:
        """Under sequence parallelism, a row-parallel output reduce-scattered
        (f32, ``row_output``) at each of ``fwd`` uses, its gradient's blocks
        all-gathered at each of ``bwd``."""
        d, act = cfg.d_model, cfg.act_dtype.itemsize
        self.add("reduce_scatter", tokens * d * 4, fwd)
        self.add("all_gather", tokens // self.layout.model * d * act, bwd)

    def alike(self, cfg, tokens: int, fwd: int, bwd: int) -> None:
        """Under sequence parallelism, a mixer or FFN computed alike
        (``transformer._alike``): the blocks gathered at each of ``fwd``
        uses, the output's gradient gathered at each of ``bwd``."""
        self.add("all_gather", tokens // self.layout.model * cfg.d_model
                 * cfg.act_dtype.itemsize, fwd + bwd)

    def norm(self, name: str, fwd: int, bwd: int, sp: bool) -> None:
        """A norm scale taken whole at each of ``fwd`` uses: gathered, or
        under sequence parallelism :meth:`partial`."""
        if sp:
            self.partial(name, fwd, bwd)
        else:
            self.gather(name, fwd)

    def attention(self, pre: str, cfg, tokens: int, fwd: int, bwd: int, kv: bool = True,
                  last: int = 0, sp: bool = False) -> None:
        """Attention under ``pre`` over ``tokens`` query rows
        (``transformer._tp_qkv`` / ``_tp_cross_residual``): split by heads,
        the output all-reduced (f32) at each of ``fwd`` forward uses minus
        ``last`` (a checkpointed repeat's recompute that stops before it),
        the queries' input gradient at each of ``bwd``, ``wk`` / ``wv``
        taken whole where the rank's blocks are not its KV heads; else every
        leaf gathered.  ``kv``: the keys and values are computed (not a
        decode step's cached ``kx`` / ``vx``).  ``sp``: sequence parallelism:
        split by heads, :meth:`seq_in` and :meth:`seq_out` in place of the
        all-reduces; else the leaves taken with :meth:`partial` and a
        self-attention's keys and values (every KV head of the rank's block)
        gathered, their f32 gradient reduce-scattered."""
        from repro_torch.models import transformer as T

        names = ("wq", "wk", "wv", "wo") if kv else ("wq", "wo")
        if not T._heads_split(self, cfg, self.layout.model, pre):
            for w in names:
                if sp:
                    self.partial(pre + w, fwd, bwd)
                else:
                    self.gather(pre + w, fwd)
            if sp and not pre.endswith("xattn."):
                n = 2 * tokens * cfg.n_kv_heads * cfg.hd
                self.add("all_gather", n // self.layout.model * cfg.act_dtype.itemsize, fwd)
                self.add("reduce_scatter", n * 4, bwd)
            return
        if sp:
            self.seq_in(cfg, tokens, fwd, bwd)
            self.seq_out(cfg, tokens, fwd - last, bwd)
        else:
            self.add("all_reduce_sum", tokens * cfg.d_model * 4, bwd + fwd - last)
        if kv and not T._kv_direct(self, cfg, self.layout.model, pre):
            self.partial(pre + "wk", fwd, bwd)
            self.partial(pre + "wv", fwd, bwd)

    def recurrent(self, pre: str, mixer: str, cfg, tokens: int, fwd: int, bwd: int,
                  last: int = 0, sp: bool = False) -> None:
        """A recurrent mixer over ``tokens`` rows (``transformer.
        _tp_recurrent``): by heads or channels, each leaf the rank's block or
        taken whole (``transformer._part``); the input's gradient
        all-reduced; Mamba-2's (T, 1) f32 sums of squares all-reduced
        forward and their gradient backward, the RG-LRU's (T, d_rnn / M)
        conv output gathered and its f32 gradient reduce-scattered; the
        output all-reduced (f32) at each of ``fwd`` minus ``last``; where
        the heads or channels do not divide, every leaf gathered.  ``sp``:
        sequence parallelism (:meth:`seq_in` / :meth:`seq_out`, or
        :meth:`alike` where they do not divide)."""
        from repro_torch.models import transformer as T

        M, d = self.layout.model, cfg.d_model
        n = T._rank_width(mixer, cfg, M)
        if n is None:
            for name in self.layer_leaves(f"{pre}{mixer}."):
                self.gather(name, fwd)
            if sp:
                self.alike(cfg, tokens, fwd, bwd)
            return
        for leaf, (dim, ranges) in T.mixer_parts(mixer, cfg, M, 0).items():
            if len(ranges) > 1 or self.dim(f"{pre}{mixer}.{leaf}") != dim:
                self.partial(f"{pre}{mixer}.{leaf}", fwd, bwd)
        if sp:
            self.seq_in(cfg, tokens, fwd, bwd)
            self.seq_out(cfg, tokens, fwd - last, bwd)
        else:
            self.add("all_reduce_sum", tokens * d * 4, bwd + fwd - last)
        if mixer == "ssm":
            self.add("all_reduce_sum", tokens * 4, fwd + bwd)
        else:
            self.add("all_gather", tokens * n * cfg.act_dtype.itemsize, fwd)
            self.add("reduce_scatter", tokens * n * M * 4, bwd)

    def layer(self, pre: str, kind: str, cfg, tokens: int, fwd: int, bwd: int,
              last: int = 0, norms: bool = True, cross_kv: bool = True, sp: bool = False) -> None:
        """One layer group's model-group collectives (``transformer.
        _tp_block`` / ``_tp_decode_block``) over ``tokens`` rows: ``fwd``
        forward and ``bwd`` backward uses; ``last``: the uses of its last
        all-reduce that a checkpointed recompute does not run again;
        ``norms``: its norm scales are gathered (not resolved by
        ``serving_params``); ``cross_kv``: an ``xattn`` block computes its
        keys and values (prefill, training); ``sp``: the layer runs on the
        rank's block of the sequence (``transformer._tp_block``'s ``sp``)."""
        from repro_torch.models import transformer as T

        mixer, ffn = T._parse_kind(kind)
        # the block's last all-reduce: the FFN's, else the cross-attention's
        # or the mixer's
        mixer_last = last if ffn == "none" else 0
        if norms:
            self.norm(pre + "ln1.scale", fwd, bwd, sp)
            if ffn != "none":
                self.norm(pre + "ln2.scale", fwd, bwd, sp)
            if mixer == "xattn":
                self.norm(pre + "lnx.scale", fwd, bwd, sp)
        if mixer in T.RECURRENT:
            self.recurrent(pre, mixer, cfg, tokens, fwd, bwd, mixer_last, sp)
        else:
            self.attention(pre + "attn.", cfg, tokens, fwd, bwd,
                           last=0 if mixer == "xattn" else mixer_last, sp=sp)
        if mixer == "xattn":
            self.attention(pre + "xattn.", cfg, tokens, fwd, bwd, cross_kv, mixer_last, sp)
        act = tokens * cfg.d_model * 4
        if ffn == "moe":
            self.moe(pre, cfg, tokens, fwd, bwd, last, sp)
        elif ffn == "dense":
            if T._mlp_split(self, pre + "mlp.", cfg):
                if sp:
                    self.seq_in(cfg, tokens, fwd, bwd)
                    self.seq_out(cfg, tokens, fwd - last, bwd)
                else:
                    self.add("all_reduce_sum", act, bwd + fwd - last)
            else:
                for w in self.ffn_names(pre + "mlp.", cfg):
                    self.gather(w, fwd)
                if sp:
                    self.alike(cfg, tokens, fwd, bwd)

    def ffn_names(self, pre: str, cfg, names=("w1", "w2", "w3")) -> tuple:
        return tuple(pre + w for w in names[:2] + (names[2:] if cfg.mlp_gated else ()))

    def is_moe(self, pre: str) -> bool:
        return pre + "moe.router" in self._index

    def moe(self, pre: str, cfg, tokens: int, fwd: int, reps: int = 0, skip: int = 0,
            sp: bool = False) -> None:
        """A MoE FFN's model-group collectives over ``tokens`` rows
        (``layers.moe_apply`` with ``transformer._tp_moe``'s split): the
        router's (T, E / M) f32 logits gathered or its (T, E) partial logits
        all-reduced, the experts' partial outputs all-reduced ((TK, d) for
        the ``scatter`` combine, (T, d) for ``ksum`` and ``moe_impl="dense"``)
        or their leaves gathered, the shared experts' output all-reduced or
        their leaves gathered, each ``fwd`` times; backward (``reps``
        layers) the input's gradient all-reduced where anything is split,
        and the (T, K) f32 gates' where the experts' output is reduced after
        the combine.  ``skip``: of the ``fwd``, the calls of the layer's
        last all-reduce that a checkpointed repeat's recompute does not run
        again (the shared experts', else the combined experts').  ``sp``:
        sequence parallelism: the input's blocks gathered (:meth:`seq_in`,
        whatever is split), each partial output reduce-scattered
        (:meth:`seq_out`) and each output computed alike cut to the rank's
        block, its gradient gathered at each of ``reps``."""
        from repro_torch.models import transformer as T

        d, M, K, E = cfg.d_model, self.layout.model, cfg.top_k, cfg.n_experts
        act = tokens * d * 4
        router = self.dim(pre + "moe.router")
        experts = T._experts_split(self, cfg, pre + "moe.")
        shared = cfg.n_shared_experts > 0 and T._mlp_split(self, pre + "moe.shared.", cfg)
        alike = tokens // M * d * cfg.act_dtype.itemsize

        def reduced(calls):
            if sp:
                self.seq_out(cfg, tokens, calls, reps)
            else:
                self.add("all_reduce_sum", act, calls)

        if router == 1:
            self.add("all_gather", tokens * (E // M) * 4, fwd)
        elif router == 0:
            self.add("all_reduce_sum", tokens * E * 4, fwd)
        if sp:
            self.seq_in(cfg, tokens, fwd, reps)
        elif router is not None or experts or shared:
            self.add("all_reduce_sum", act, reps)
        if not experts:
            for w in self.ffn_names(pre + "moe.", cfg, ("we1", "we2", "we3")):
                self.gather(w, fwd)
            self.add("all_gather", alike, reps if sp else 0)
        elif cfg.moe_impl != "dense" and cfg.moe_combine != "ksum":
            self.add("all_reduce_sum", tokens * K * d * 4, fwd)
            self.add("all_gather", alike, reps if sp else 0)
        else:
            reduced(fwd - (0 if cfg.n_shared_experts else skip))
            self.add("all_reduce_sum", tokens * K * 4, reps)
        if shared:
            reduced(fwd - skip)
        elif cfg.n_shared_experts:
            for w in self.ffn_names(pre + "moe.shared.", cfg):
                self.gather(w, fwd)
            self.add("all_gather", alike, reps if sp else 0)

    def moe_stats(self, pre: str, cfg, fwd: int) -> None:
        """A MoE layer's aux loss over the whole microbatch, ``fwd`` times:
        its top-1 counts (int64) and router probability sums (f32)
        all-reduced over the zero group (``layers.moe_apply``'s ``rows``)."""
        if self.is_moe(pre):
            self.add("all_reduce_sum", cfg.n_experts * 8, fwd, "zero")
            self.add("all_reduce_sum", cfg.n_experts * 4, fwd, "zero")

    def prefix(self, cfg, batch: int, patches: int = None) -> None:
        """A VLM's (batch, P, d / M) patch prefix gathered over the model
        group where ``patch_proj`` is column-parallel
        (``transformer._patch_prefix``); ``patches``: P where not all
        ``n_patches`` (a rank's chunk of the sequence)."""
        n = cfg.n_patches if patches is None else patches
        if cfg.family == "vlm" and self.dim("patch_proj") == 1:
            self.add("all_gather", batch * n * (cfg.d_model // self.layout.model)
                     * cfg.act_dtype.itemsize)

    def rank_heads(self, pre: str, cfg) -> tuple:
        """(query heads, KV heads) the rank computes of the attention under
        ``pre`` (``transformer._rank_kv``)."""
        from repro_torch.models import transformer as T

        M = self.layout.model
        if M == 1 or not T._heads_split(self, cfg, M, pre):
            return cfg.n_heads, cfg.n_kv_heads
        return cfg.n_heads // M, T._kv_heads(cfg, M, self.layout.model_index)[1]

    def chunk(self, cfg, batch: int, seq) -> None:
        """The data group's collectives of a prefill over the rank's chunk
        ``seq`` (``SeqSplit``) of the decoder sequence, each ``<name>@data``:
        per attention layer its chunk's keys and values all-gathered
        (``transformer._self_attend``: one call, the rank's KV heads); per
        recurrent layer every rank's last ``min(n, width - 1)`` conv inputs
        (``layers.conv_edges``) and its f32 chunk decay and state
        (``layers._carried``: Mamba-2's (B, H, 1 + P N), the RG-LRU's (B,
        d_rnn, 2), the rank's heads or channels) all-gathered; then the
        last position's (B, 1, d) hidden state."""
        from repro_torch.models import transformer as T

        act, M, n = cfg.act_dtype.itemsize, self.layout.model, seq.n
        t = min(n, cfg.conv_width - 1)
        for pre, kind, reps in self.layer_groups(cfg):
            if pre.startswith("encoder."):
                continue
            mixer = T._parse_kind(kind)[0]
            width = T._rank_width(mixer, cfg, M) if mixer in T.RECURRENT else None
            if mixer == "ssm":
                heads = width or cfg.ssm_heads
                P, N = cfg.ssm_head_dim, cfg.ssm_state
                self.add("all_gather", batch * t * (heads * P + 2 * N) * act, reps, "data")
                self.add("all_gather", batch * heads * (1 + P * N) * 4, reps, "data")
            elif mixer == "rglru":
                ch = width or cfg.d_rnn
                self.add("all_gather", batch * t * ch * act, reps, "data")
                self.add("all_gather", batch * ch * 2 * 4, reps, "data")
            else:
                kvh = self.rank_heads(pre + "attn.", cfg)[1]
                self.add("all_gather", 2 * batch * n * kvh * cfg.hd * act, reps, "data")
        self.add("all_gather", batch * cfg.d_model * act, 1, "data")

    def slots(self, cfg, batch: int) -> None:
        """The data group's collectives of a decode step whose
        full-attention caches lie over it in blocks (``layers.
        split_decode_attention``): per such layer the (B, H_rank) f32
        maxima all-reduced (max), then the (B, H_rank, 1 + hd) f32 sums and
        weighted values (sum)."""
        from repro_torch.models import transformer as T

        for pre, kind, reps in self.layer_groups(cfg):
            if pre.startswith("encoder.") or T._parse_kind(kind)[0] not in ("attn", "xattn"):
                continue
            heads = self.rank_heads(pre + "attn.", cfg)[0]
            self.add("all_reduce_max", batch * heads * 4, reps, "data")
            self.add("all_reduce_sum", batch * heads * (1 + cfg.hd) * 4, reps, "data")

    def head_split(self, cfg) -> bool:
        head = "embed" if cfg.tie_embeddings else "lm_head"
        return self.dim(head) == (0 if cfg.tie_embeddings else 1)


def microbatch_collectives(cfg, layout: FlatLayout, batch: int, seq: int,
                           remat: bool = False) -> dict:
    """The collectives of one forward and backward of ``loss_fn`` on a
    ``(batch, seq)`` microbatch on a rank of ``layout``, reckoned from its
    placements, layer by layer (:meth:`_Reckoning.layer`): ``{"<name>@model":
    {"calls", "bytes"}}`` as ``CommStats`` counts them (the bytes this rank
    sends).  Activations are all-reduced in f32 (4 bytes per element); a
    gather sends the rank's block; a reduce-scatter the whole f32 gradient;
    a leaf held whole but used where each rank computes a part has its f32
    gradient all-reduced.  ``remat``: each pattern repeat (and each encoder
    block) is recomputed in the backward (``transformer._run_stack``), so
    its forward collectives run twice, up to its last saved tensor
    (``torch.utils.checkpoint`` stops there: the all-reduce of the repeat's
    last block's output runs once).  A MoE FFN's collectives are
    :meth:`_Reckoning.moe`'s; a VLM's ``seq`` text tokens follow its
    ``n_patches`` patches, whose projection is gathered once per microbatch
    (:meth:`_Reckoning.prefix`); an ``encdec`` model's encoder runs over
    ``enc_len`` frames per row, ``enc_norm`` gathered once and, where the
    cross-attention is split by heads, the encoder output's f32 gradient
    all-reduced once.

    Under FSDP (``layout.zero`` > 1) the rank computes its ``batch / Z``
    rows where :func:`zero_split` (else all ``batch``), and the zero group's
    collectives count as ``<name>@zero``: each zero-cut leaf gathered at
    every use (a layer's leaves inside the layer, so twice under remat;
    ``embed`` at the lookup and, tied, at the head; the head,
    ``final_norm`` and ``enc_norm`` once), and with the rows split its
    gradient reduce-scattered once per use (a leaf held whole over zero:
    all-reduced), and each MoE layer's aux-loss statistics all-reduced
    (``layers.moe_apply``).

    Under sequence parallelism (:func:`seq_shard` of the decoder's n_prefix
    + seq positions, and of an ``encdec`` encoder's ``enc_len`` frames for
    its stack) each layer runs on the rank's block (:meth:`_Reckoning.layer`'s
    ``sp``); the lookup's sum is reduce-scattered (a VLM's joined prefix and
    text, whole, cut), the final hidden states' blocks gathered in front of
    the head, the encoder output's for the cross-attention, and the norm
    scales taken with :meth:`_Reckoning.partial`."""
    from repro_torch.models import transformer as T

    r = _Reckoning(layout)
    mode = "sum" if zero_split(layout, batch) else "slice"
    rows = batch // layout.zero if mode == "sum" else batch
    M, d = layout.model, cfg.d_model
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    tokens = rows * (seq + n_prefix)
    enc_tokens = rows * cfg.enc_len if cfg.family == "encdec" else 0
    sp = seq_shard(cfg, layout, seq + n_prefix) is not None
    enc_sp = cfg.family == "encdec" and seq_shard(cfg, layout, cfg.enc_len) is not None
    act = cfg.act_dtype.itemsize
    head = "embed" if cfg.tie_embeddings else "lm_head"
    r.zero_use("embed", 1, 1, mode)
    r.zero_use("final_norm.scale", 1, 1, mode)
    r.zero_use(head, 1, 1, mode)
    if cfg.family == "vlm":
        r.zero_use("patch_proj", 1, 1, mode)
    if cfg.family == "encdec":
        r.zero_use("enc_norm.scale", 1, 1, mode)
    if M > 1:
        # the lookup, then under sequence parallelism its cut to the block
        if r.dim("embed") == 0 and sp and not n_prefix:
            r.add("reduce_scatter", rows * seq * d * 4)
        elif r.dim("embed") == 0:
            r.add("all_reduce_sum", rows * seq * d * 4)
        else:
            r.gather("embed")
        if sp:
            item = act if n_prefix else r.itemsize("embed")
            r.add("all_gather", tokens // M * d * item)
        r.prefix(cfg, rows)
        if cfg.family == "encdec":
            r.norm("enc_norm.scale", 1, 1, enc_sp)
            partial = sp or any(T._heads_split(r, cfg, M, pre + "xattn.")
                                for pre, kind, _ in r.layer_groups(cfg)
                                if kind.startswith("xattn"))
            if enc_sp:
                r.add("all_gather", enc_tokens // M * d * act)
                if partial:
                    r.add("reduce_scatter", enc_tokens * d * 4)
            elif partial:
                r.add("all_reduce_sum", enc_tokens * d * 4)
    for pre, kind, reps in r.layer_groups(cfg):
        checkpointed = remat and r.stacked(pre)
        fwd = reps * (2 if checkpointed else 1)
        for name in r.layer_leaves(pre):
            r.zero_use(name, fwd, reps, mode)
        if mode == "sum":
            r.moe_stats(pre, cfg, fwd)
        if M > 1:
            enc = pre.startswith("encoder.")
            r.layer(pre, kind, cfg, enc_tokens if enc else tokens, fwd, reps,
                    reps if checkpointed and r.tail(cfg, pre) else 0,
                    sp=enc_sp if enc else sp)
    if M == 1:
        return r.out
    r.norm("final_norm.scale", 1, 1, sp)
    if sp:
        # the final hidden states' blocks gathered, their gradient
        # reduce-scattered where the head is vocab-parallel
        r.add("all_gather", tokens // M * d * act)
    if r.head_split(cfg):
        # the head input's gradient, the text positions'
        if sp:
            r.add("reduce_scatter", tokens * d * 4)
        else:
            r.add("all_reduce_sum", rows * seq * d * 4)
        for c0 in range(0, seq, min(T.CE_CHUNK, seq)):
            n = rows * (min(c0 + T.CE_CHUNK, seq) - c0) * 4
            r.add("all_reduce_max", n)
            r.add("all_reduce_sum", n, 2)              # the sum of exponentials, the gold
    else:
        r.gather(head)
    return r.out


def local_phase_collectives(cfg, layout: FlatLayout, n_local: int, tau: int, b_micro: int,
                            seq: int, accum: int = 1, remat: bool = False) -> dict:
    """The local phase's collectives of one outer step on a rank of
    ``layout`` (its ``n_local`` workers, ``tau`` local steps of ``accum``
    microbatches of ``(b_micro, seq)``): :func:`microbatch_collectives` for
    each, and with the rows split over zero the one all-reduce of the
    (tau, n_local) f32 losses over the zero group that makes each worker's
    loss the mean over its zero ranks."""
    micro = microbatch_collectives(cfg, layout, b_micro, seq, remat)
    losses = ({"all_reduce_sum@zero": {"calls": 1, "bytes": tau * n_local * 4}}
              if zero_split(layout, b_micro) else {})
    return comm.scaled_sum((n_local * tau * accum, micro), (1, losses))


def global_phase_collectives(layout: FlatLayout, n_workers: int, worker: int, zero: int,
                             tau: int, zero_sharded: bool = True, dsm: bool = True) -> dict:
    """The global phase's collectives of one outer step (no faults) on a
    rank of ``layout`` in a ``(worker, zero, model)`` grid (``layout.model``
    model ranks; FSDP over ``zero`` where ``layout.zero`` > 1), as
    ``CommStats`` counts them.  They run over ``Topology.dp``, the ranks
    that hold the rank's blocks (its ``worker * zero`` ranks, under FSDP
    its ``worker`` peers), and a group of one rank counts nothing: the
    (tau, W_local) f32 losses gathered (``gather_workers``); per dtype group
    the scatter of each local worker's column chunk to the chunk's owner
    (``scatter_rows``) and, for a group the global step does not shard
    (``zero_sharded`` off, or too small: ``zero.whole``), the all-gather of
    the mean's chunks (``all_gather_shards``).  A DSM round (``dsm``; with
    either sign: the randomized ones draw on every rank, unsent) then sums
    the seven f32 stat sums over its ``(worker, zero)`` ranks with the
    sharded step (``all_reduce_sum``), else over its zero group under FSDP
    (``all_reduce_sum@zero``), and over the model group
    (``all_reduce_sum@model``), and with the sharded step all-gathers
    x_{t+1,0}'s shards of each sharded group.  A baseline's round
    (``dsm=False``) sends nothing more: its global update runs on every
    rank of ``dp`` alike."""
    from repro_torch.distributed import zero as Z
    from repro_torch.obs.metrics import N_STAT_SUMS

    fsdp = layout.zero > 1
    ranks = worker if fsdp else worker * zero          # Topology.dp's world
    n_local = n_workers // worker
    stat = N_STAT_SUMS * 4
    out: dict = {}

    def add(name: str, nbytes: int, group: int) -> None:
        if group > 1:
            rec = out.setdefault(name, {"calls": 0, "bytes": 0})
            rec["calls"] += 1
            rec["bytes"] += nbytes

    add("gather_workers", tau * n_local * 4, ranks)
    sharded = dsm and zero_sharded
    for n, dt in zip(layout.group_numels, layout.dtypes):
        chunk, item = Z.chunk_size(n, ranks), dt.itemsize
        add("scatter_rows", worker * n_local * chunk * item, ranks)
        if not sharded or Z.whole(n, ranks):
            add("all_gather_shards", chunk * item, ranks)
    if dsm:
        if sharded:
            add("all_reduce_sum", stat, worker * zero)
        else:
            add("all_reduce_sum@zero", stat, layout.zero)
        add("all_reduce_sum@model", stat, layout.model)
    if sharded:
        for n, dt in zip(layout.group_numels, layout.dtypes):
            if not Z.whole(n, ranks):
                add("all_gather_shards", Z.chunk_size(n, ranks) * dt.itemsize, ranks)
    return out


def round_collectives(cfg, layout: FlatLayout, n_workers: int, worker: int, zero: int,
                      tau: int, b_micro: int, seq: int, accum: int = 1, remat: bool = False,
                      zero_sharded: bool = True, dsm: bool = True) -> dict:
    """One outer step's collectives on a rank of ``layout``: its local
    phase's (:func:`local_phase_collectives`, its ``n_workers / worker``
    workers) and its global phase's (:func:`global_phase_collectives`;
    ``dsm=False``: a local-step baseline's round)."""
    return comm.scaled_sum(
        (1, local_phase_collectives(cfg, layout, n_workers // worker, tau, b_micro, seq, accum,
                                    remat)),
        (1, global_phase_collectives(layout, n_workers, worker, zero, tau, zero_sharded, dsm)))


def serve_collectives(cfg, layout: FlatLayout, batch: int, seq: int, kind: str,
                      chunk: Optional[SeqSplit] = None,
                      slots: Optional[SeqSplit] = None) -> dict:
    """The collectives of one serving call on a rank's ``batch`` rows,
    reckoned from its placements as :func:`microbatch_collectives` (forward
    only): ``kind`` ``"serving_params"`` (``transformer.serving_params``,
    once per ``generate``: each norm scale gathered over the model group, a
    stacked one in one call), ``"prefill"`` over ``seq`` positions (a VLM's
    patches included; an ``encdec`` model's encoder over its ``enc_len``
    frames) or ``"decode"`` (one ``decode_step``; ``seq`` is not read; the
    encoder does not run, the cross-attention reads its cached keys and
    values), both on resolved params (a call on params not yet resolved
    adds ``"serving_params"``'s), or ``"pick"`` (one :func:`vocab_argmax`:
    an f32 maximum and an int64 minimum per row where the logits are the
    rank's vocab block, nothing where they are whole).  A call all-reduces
    the vocab-parallel lookup and each row-parallel output (f32), gathers
    Mamba-2's norm sums and the RG-LRU's conv output as
    :meth:`_Reckoning.layer` does, and gathers each leaf the split does not
    consume.  Under FSDP over data (``layout.zero`` > 1, the serving
    placement's ``data`` entries) each data-cut leaf is gathered over the
    data group where it is used (``<name>@data``: every layer's leaves that
    the call reads, ``embed`` at the lookup and, tied, at the head, the
    head, ``final_norm`` and ``enc_norm`` where no model gather resolved
    them).

    Where the batch does not split over data (:func:`serve_split`):
    ``chunk``, a prefill's rank chunk of the ``seq`` positions (the model
    group's collectives over its tokens, the lookup over its text tokens,
    the patch projection over its patches, each where it has any; the data
    group's as :meth:`_Reckoning.chunk` counts them); ``slots``, a decode
    step's full-attention caches over data (:meth:`_Reckoning.slots`).

    Under sequence parallelism (:func:`seq_shard` of the prefill's
    positions, or of its ``chunk``) the prefill's layers run on the rank's
    block of them (without ``chunk`` the encoder's on its block of the
    frames, their output gathered), the lookup's sum is reduce-scattered
    and the last position's hidden state gathered over the model group
    (then, with ``chunk``, over the data group)."""
    from repro_torch.models import transformer as T

    if kind not in ("serving_params", "prefill", "decode", "pick"):
        raise ValueError(f"kind must be 'serving_params', 'prefill', 'decode' or 'pick', "
                         f"got {kind!r}")
    r = _Reckoning(layout, "data")
    if kind == "pick":
        if layout.model > 1 and r.head_split(cfg):
            r.add("all_reduce_max", batch * 4)
            r.add("all_reduce_min", batch * 8)
        return r.out
    resolved = {n for n in layout.names if n.endswith(T.NORM_SCALES) and r.dim(n) is not None}
    if kind == "serving_params":
        for name in layout.names:
            if name in resolved:
                r.add("all_gather",
                      r.layer_count(name) * r.block_numel(name) * r.itemsize(name))
        return r.out
    # the rank's positions, its patches and text tokens among them
    n_prefix = cfg.n_patches if kind == "prefill" and cfg.family == "vlm" else 0
    a, b = ((0, seq if kind == "prefill" else 1) if chunk is None
            else (chunk.start, chunk.stop))
    patches = min(b, n_prefix) - min(a, n_prefix)
    text = b - a - patches
    # the norm scales a model gather resolved are held whole from then on;
    # a decode step projects no patches, runs no encoder and reads the
    # cross-attention's keys and values from the cache
    unused = set(resolved)
    if kind == "decode":
        unused |= {n for n in layout.names
                   if n == "patch_proj" or n.startswith("encoder.") or n == "enc_norm.scale"
                   or n.endswith(("xattn.wk", "xattn.wv"))}
    # every data rank gathers embed and patch_proj over data, whatever its
    # chunk holds (transformer._inputs)
    for name in layout.names:
        if name not in unused:
            r.zero_use(name, r.layer_count(name) * (1 + (name == "embed" and cfg.tie_embeddings)))
    sp = kind == "prefill" and seq_shard(cfg, layout, b - a) is not None
    enc_sp = (kind == "prefill" and chunk is None and cfg.family == "encdec"
              and seq_shard(cfg, layout, cfg.enc_len) is not None)
    if layout.model > 1:
        M, act = layout.model, cfg.act_dtype.itemsize
        if r.dim("embed") == 0:
            if text:
                r.add("reduce_scatter" if sp and not n_prefix else "all_reduce_sum",
                      batch * text * cfg.d_model * 4)
        elif text:
            r.gather("embed")
        if kind == "prefill" and patches:
            r.prefix(cfg, batch, patches)
        for pre, block, reps in r.layer_groups(cfg):
            if pre.startswith("encoder."):
                if kind == "prefill":
                    r.layer(pre, block, cfg, batch * cfg.enc_len, reps, 0, norms=False,
                            sp=enc_sp)
                continue
            r.layer(pre, block, cfg, batch * (b - a), reps, 0, norms=False,
                    cross_kv=kind == "prefill", sp=sp)
        if enc_sp:
            r.add("all_gather", batch * cfg.enc_len // M * cfg.d_model * act)
        if sp:
            r.add("all_gather", batch * cfg.d_model * act)
        if not r.head_split(cfg):
            r.gather("embed" if cfg.tie_embeddings else "lm_head")
    if kind == "prefill" and chunk is not None:
        r.chunk(cfg, batch, chunk)
    if kind == "decode" and slots is not None:
        r.slots(cfg, batch)
    return r.out
