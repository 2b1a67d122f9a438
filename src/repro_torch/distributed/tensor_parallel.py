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
    every row (the reference's sequence split of a prefill is not ported:
    each data row serves the whole batch)."""
    data = 1 if topo is None else topo.worker
    spec = sharding.serve_batch_pspecs({"tokens": ((batch, 1), torch.int64)}, data, 1)
    if data == 1 or spec["tokens"][0] != "data":
        return slice(0, batch)
    n = batch // data
    return slice(topo.worker_index * n, (topo.worker_index + 1) * n)


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


class _Reckoning:
    """The model group's collectives of a rank's layout, added up as
    ``CommStats`` counts them: ``{"<name>@model": {"calls", "bytes"}}``."""

    def __init__(self, layout: FlatLayout):
        self.layout, self.out = layout, {}
        self._index = {n: i for i, n in enumerate(layout.names)}

    def add(self, name: str, nbytes: int, calls: int = 1) -> None:
        rec = self.out.setdefault(f"{name}@model", {"calls": 0, "bytes": 0})
        rec["calls"] += calls
        rec["bytes"] += nbytes * calls

    def stacked(self, name: str) -> bool:
        return name.startswith(C.STACKED)

    def dim(self, name: str):
        d = self.layout.model_dims[self._index[name]]
        return None if d is None else d - self.stacked(name)

    def layer_count(self, name: str) -> int:
        return self.layout.shapes[self._index[name]][0] if self.stacked(name) else 1

    def block_numel(self, name: str) -> int:
        shape = self.layout.shapes[self._index[name]]
        return math.prod(shape[1:] if self.stacked(name) else shape)

    def itemsize(self, name: str) -> int:
        return self.layout.dtypes[self.layout.groups[self._index[name]]].itemsize

    def gather(self, name: str) -> None:
        """A leaf gathered at use, layer by layer: each rank sends its block."""
        if self.dim(name) is not None:
            self.add("all_gather", self.block_numel(name) * self.itemsize(name),
                     self.layer_count(name))

    def gather_all(self) -> dict:
        """Every leaf gathered once: the replicated compute of a family the
        model axis does not split (``transformer._gathered``)."""
        for name in self.layout.names:
            self.gather(name)
        return self.out

    def attention_layers(self):
        """``(prefix, layers)`` of each decoder attention leaf group."""
        for wq in (n for n in self.layout.names
                   if n.startswith("decoder.") and n.endswith(".attn.wq")):
            yield wq[:-len("attn.wq")], self.layer_count(wq)

    def heads_split(self, pre: str, cfg) -> bool:
        return (self.dim(pre + "attn.wq") == 1 and self.dim(pre + "attn.wo") == 0
                and cfg.n_heads % self.layout.model == 0)

    def kv_direct(self, pre: str, cfg) -> bool:
        return (cfg.n_kv_heads % self.layout.model == 0 and self.dim(pre + "attn.wk") == 1
                and self.dim(pre + "attn.wv") == 1)

    def ffn_split(self, pre: str, cfg) -> bool:
        return (self.dim(pre + "mlp.w1") == 1 and self.dim(pre + "mlp.w2") == 0
                and (not cfg.mlp_gated or self.dim(pre + "mlp.w3") == 1))

    def ffn_names(self, pre: str, cfg) -> tuple:
        return tuple(pre + w for w in ("mlp.w1", "mlp.w2") + (("mlp.w3",) if cfg.mlp_gated
                                                               else ()))

    def head_split(self, cfg) -> bool:
        head = "embed" if cfg.tie_embeddings else "lm_head"
        return self.dim(head) == (0 if cfg.tie_embeddings else 1)


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

    r = _Reckoning(layout)
    if not T.megatron_split(cfg):
        return r.gather_all()
    M = layout.model
    act = batch * seq * cfg.d_model * 4
    if r.dim("embed") == 0:
        r.add("all_reduce_sum", act)
    else:
        r.gather("embed")
    for pre, reps in r.attention_layers():
        r.gather(pre + "ln1.scale")
        r.gather(pre + "ln2.scale")
        if r.heads_split(pre, cfg):
            r.add("all_reduce_sum", act, 2 * reps)     # the input's gradient, the output
            if not r.kv_direct(pre, cfg):
                for w in (pre + "attn.wk", pre + "attn.wv"):
                    if r.dim(w) is None:
                        r.add("all_reduce_sum", r.block_numel(w) * 4, reps)
                    else:
                        r.add("all_gather", r.block_numel(w) * r.itemsize(w), reps)
                        r.add("reduce_scatter", r.block_numel(w) * M * r.itemsize(w), reps)
        else:
            for w in ("attn.wq", "attn.wk", "attn.wv", "attn.wo"):
                r.gather(pre + w)
        if r.ffn_split(pre, cfg):
            r.add("all_reduce_sum", act, 2 * reps)
        else:
            for w in r.ffn_names(pre, cfg):
                r.gather(w)
    r.gather("final_norm.scale")
    if r.head_split(cfg):
        r.add("all_reduce_sum", act)                   # the head input's gradient
        for c0 in range(0, seq, min(T.CE_CHUNK, seq)):
            rows = batch * (min(c0 + T.CE_CHUNK, seq) - c0) * 4
            r.add("all_reduce_max", rows)
            r.add("all_reduce_sum", rows, 2)           # the sum of exponentials, the gold
    else:
        r.gather("embed" if cfg.tie_embeddings else "lm_head")
    return r.out


def serve_collectives(cfg, layout: FlatLayout, batch: int, seq: int, kind: str) -> dict:
    """The model group's collectives of one serving call on a rank's
    ``batch`` rows, reckoned from its placements as
    :func:`microbatch_collectives` (forward only): ``kind``
    ``"serving_params"`` (``transformer.serving_params``, once per
    ``generate``: a Megatron-split config gathers each norm scale, a
    stacked one in one call; every other family gathers every leaf, layer
    by layer), ``"prefill"`` over ``seq`` positions (a VLM's patches
    included) or ``"decode"`` (one ``decode_step``; ``seq`` is not read),
    both on resolved params (a call on params not yet resolved adds
    ``"serving_params"``'s), or ``"pick"`` (one :func:`vocab_argmax`: an f32
    maximum and an int64 minimum per row where the logits are the rank's
    vocab block, nothing where they are whole).  A Megatron-split config's
    call all-reduces the vocab-parallel lookup and each attention and FFN
    output (f32), and gathers ``wk`` / ``wv`` where a rank's block cuts a
    head; every other family's call computes on the gathered leaves."""
    from repro_torch.models import transformer as T

    if kind not in ("serving_params", "prefill", "decode", "pick"):
        raise ValueError(f"kind must be 'serving_params', 'prefill', 'decode' or 'pick', "
                         f"got {kind!r}")
    r = _Reckoning(layout)
    split = T.megatron_split(cfg)
    if kind == "pick":
        if split and r.head_split(cfg):
            r.add("all_reduce_max", batch * 4)
            r.add("all_reduce_min", batch * 8)
        return r.out
    if kind == "serving_params":
        if not split:
            return r.gather_all()
        for name in layout.names:
            if name.endswith(T.NORM_SCALES) and r.dim(name) is not None:
                r.add("all_gather", r.layer_count(name) * r.block_numel(name) * r.itemsize(name))
        return r.out
    if not split:
        return r.out
    act = batch * (seq if kind == "prefill" else 1) * cfg.d_model * 4
    if r.dim("embed") == 0:
        r.add("all_reduce_sum", act)
    else:
        r.gather("embed")
    for pre, reps in r.attention_layers():
        if r.heads_split(pre, cfg):
            if not r.kv_direct(pre, cfg):
                r.gather(pre + "attn.wk")
                r.gather(pre + "attn.wv")
            r.add("all_reduce_sum", act, reps)
        else:
            for w in ("attn.wq", "attn.wk", "attn.wv", "attn.wo"):
                r.gather(pre + w)
        if r.ffn_split(pre, cfg):
            r.add("all_reduce_sum", act, reps)
        else:
            for w in r.ffn_names(pre, cfg):
                r.gather(w)
    if not r.head_split(cfg):
        r.gather("embed" if cfg.tie_embeddings else "lm_head")
    return r.out
    if not split:
        return r.gather_all()
    act = batch * (seq if kind == "prefill" else 1) * cfg.d_model * 4
    if r.dim("embed") == 0:
        r.add("all_reduce_sum", act)
    else:
        r.gather("embed")
    for pre, reps in r.attention_layers():
        r.gather(pre + "ln1.scale")
        if r.heads_split(pre, cfg):
            if not r.kv_direct(pre, cfg):
                r.gather(pre + "attn.wk")
                r.gather(pre + "attn.wv")
            r.add("all_reduce_sum", act, reps)
        else:
            for w in ("attn.wq", "attn.wk", "attn.wv", "attn.wo"):
                r.gather(pre + w)
        r.gather(pre + "ln2.scale")
        if r.ffn_split(pre, cfg):
            r.add("all_reduce_sum", act, reps)
        else:
            for w in r.ffn_names(pre, cfg):
                r.gather(w)
    r.gather("final_norm.scale")
    if not r.head_split(cfg):
        r.gather("embed" if cfg.tie_embeddings else "lm_head")
    return r.out
