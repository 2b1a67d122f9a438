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
    table.

A bf16 activation is all-reduced in f32 and rounded once: each rank's
partial sum is rounded to bf16 by its product, the sum of the M partials
is exact to f32 and rounded to bf16 again (the rounding model PERF.md
states).  Every collective goes through ``distributed/comm.py``, so
``CommStats`` counts it under ``<name>@model``.
"""

from __future__ import annotations

import math

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
            return comm.reduce_scatter_dim(g.contiguous(), ctx.axis, ctx.dim), None, None, None
        n = g.shape[ctx.dim] // ctx.axis.world
        return g.narrow(ctx.dim, ctx.axis.rank * n, n).contiguous(), None, None, None


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
    reduce-scatter of the partial gradients (``"sum"``)."""
    if mode not in ("slice", "sum"):
        raise ValueError(f"mode must be 'slice' or 'sum', got {mode!r}")
    return _Gather.apply(x, axis, dim, mode)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, axis) -> torch.Tensor:
    """Rows of a vocab-sharded table (this rank's ``(V / M, d)`` block):
    each rank looks up the tokens in its block, zeros the others, and the
    blocks are summed over the group (exact: one non-zero term per
    element).  The gradient reaches the rank's rows only."""
    n = table.shape[0]
    local = tokens - axis.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return reduce_from(rows, axis)


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
    from repro_torch.models.transformer import layout

    lay = layout(cfg)
    specs = sharding.param_pspecs(dict(zip(lay.names, lay.shapes)), model=model,
                                  replicate_names=replicate_names)
    return {name: sharding.model_dim(spec) for name, spec in specs.items()}


def rank_layout(cfg, model: int, index: int, axis=None,
                replicate_names: tuple = ()) -> FlatLayout:
    """Model rank ``index`` of ``model``'s flat layout: every leaf cut by
    its placement (:func:`model_dims`).  ``axis``: the rank's model group
    (``topo.mp``), which the model then computes over."""
    from repro_torch.models.transformer import layout

    return layout(cfg).shard(model_dims(cfg, model, replicate_names), model, index, axis)


def topology_layout(cfg, topo, replicate_names: tuple = ()) -> FlatLayout:
    """The layout of ``topo``'s rank: the dense layout for ``model`` = 1,
    else :func:`rank_layout` over ``topo.mp``."""
    from repro_torch.models.transformer import layout

    if topo is None or topo.model == 1:
        return layout(cfg)
    return rank_layout(cfg, topo.model, topo.model_index, topo.mp, replicate_names)


def microbatch_collectives(cfg, layout: FlatLayout, batch: int, seq: int) -> dict:
    """The model group's collectives of one forward and backward of
    ``loss_fn`` (no remat) on a ``(batch, seq)`` microbatch, reckoned from
    the rank's placements, layer by layer: ``{"<name>@model": {"calls",
    "bytes"}}`` as ``CommStats`` counts them (the bytes this rank sends).
    Activations are all-reduced in f32 (4 bytes per element); a gather sends
    the rank's block; a reduce-scatter the whole gradient; a leaf held whole
    but used where each rank computes a part has its f32 gradient
    all-reduced."""
    from repro_torch.models import transformer as T

    out: dict = {}
    index = {n: i for i, n in enumerate(layout.names)}

    def add(name: str, nbytes: int, calls: int = 1) -> None:
        rec = out.setdefault(f"{name}@model", {"calls": 0, "bytes": 0})
        rec["calls"] += calls
        rec["bytes"] += nbytes * calls

    def stacked(name: str) -> bool:
        return name.startswith(C.STACKED)

    def dim(name: str):
        d = layout.model_dims[index[name]]
        return None if d is None else d - stacked(name)

    def layer_count(name: str) -> int:
        return layout.shapes[index[name]][0] if stacked(name) else 1

    def block_numel(name: str) -> int:
        shape = layout.shapes[index[name]]
        return math.prod(shape[1:] if stacked(name) else shape)

    def itemsize(name: str) -> int:
        return layout.dtypes[layout.groups[index[name]]].itemsize

    def gather(name: str) -> None:
        if dim(name) is not None:
            add("all_gather", block_numel(name) * itemsize(name), layer_count(name))

    if not T.megatron_split(cfg):
        for name in layout.names:
            gather(name)
        return out
    M, H, KVH = layout.model, cfg.n_heads, cfg.n_kv_heads
    act = batch * seq * cfg.d_model * 4
    if dim("embed") == 0:
        add("all_reduce_sum", act)
    else:
        gather("embed")
    for wq in (n for n in layout.names if n.startswith("decoder.") and n.endswith(".attn.wq")):
        pre, reps = wq[:-len("attn.wq")], layer_count(wq)
        gather(pre + "ln1.scale")
        gather(pre + "ln2.scale")
        if dim(pre + "attn.wq") == 1 and dim(pre + "attn.wo") == 0 and H % M == 0:
            add("all_reduce_sum", act, 2 * reps)       # the input's gradient, the output
            if not (KVH % M == 0 and dim(pre + "attn.wk") == 1
                    and dim(pre + "attn.wv") == 1):
                for w in (pre + "attn.wk", pre + "attn.wv"):
                    if dim(w) is None:
                        add("all_reduce_sum", block_numel(w) * 4, reps)
                    else:
                        add("all_gather", block_numel(w) * itemsize(w), reps)
                        add("reduce_scatter", block_numel(w) * M * itemsize(w), reps)
        else:
            for w in ("attn.wq", "attn.wk", "attn.wv", "attn.wo"):
                gather(pre + w)
        ffn = ("mlp.w1", "mlp.w2") + (("mlp.w3",) if cfg.mlp_gated else ())
        if (dim(pre + "mlp.w1") == 1 and dim(pre + "mlp.w2") == 0
                and (not cfg.mlp_gated or dim(pre + "mlp.w3") == 1)):
            add("all_reduce_sum", act, 2 * reps)
        else:
            for w in ffn:
                gather(pre + w)
    gather("final_norm.scale")
    head = "embed" if cfg.tie_embeddings else "lm_head"
    if dim(head) == (0 if cfg.tie_embeddings else 1):
        add("all_reduce_sum", act)                     # the head input's gradient
        for c0 in range(0, seq, min(T.CE_CHUNK, seq)):
            rows = batch * (min(c0 + T.CE_CHUNK, seq) - c0) * 4
            add("all_reduce_max", rows)
            add("all_reduce_sum", rows, 2)             # the sum of exponentials, the gold
    else:
        gather(head)
    return out
