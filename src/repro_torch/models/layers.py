"""Model building blocks of the ``attn`` / ``swa`` / ``encattn`` / ``xattn``
mixers, the recurrent ``ssm`` (Mamba-2 SSD) and ``rglru`` (RG-LRU) mixers
and the dense and MoE FFNs: RMSNorm, RoPE, causal GQA attention (full or
sliding-window), bidirectional attention (the encoder's and the
cross-attention's), one-token attention against a KV cache, the dense MLP,
the top-k routed mixture of experts, the causal depthwise conv, the chunked
SSD scan and the RG-LRU's linear scan with their one-token steps, as plain
PyTorch functions on tensors.

They follow the reference's precision path: activations in
``cfg.act_dtype``, attention scores and softmax in f32, probabilities cast
to ``v.dtype`` before the PV product; the recurrences' states and scans in
f32.  Quirks kept on purpose:

  * RMSNorm multiplies by ``(1 + scale)``, with ``scale`` initialised to ones;
  * RoPE uses the split-half convention, in f32;
  * GELU is the tanh approximation.
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

F32 = torch.float32


def act_fn(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu
    raise ValueError(f"unknown activation {name!r}")


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(F32))
    return out.to(x.dtype)


def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=F32, device=device) / hd
    # theta is filled in on the device: a copy from the host would
    # synchronise the stream at every attention call
    return 1.0 / torch.pow(torch.full((), theta, dtype=F32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    angles = positions[:, None].to(F32) * freqs            # (S, hd/2)
    cos = torch.cos(angles)[:, None, :]                    # (S, 1, hd/2)
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _gqa_scores(q, k):
    """q: (B,Sq,H,hd), k: (B,Sk,KVH,hd) -> (B,KVH,rep,Sq,Sk) f32."""
    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    qg = q.reshape(B, Sq, KVH, H // KVH, hd)
    # f32 operands: products of bf16 values are exact in f32, so this is the
    # reference's bf16 x bf16 -> f32 (preferred_element_type) contraction
    s = torch.einsum("bqgrh,bkgh->bgrqk", qg.to(F32), k.to(F32))
    return s / math.sqrt(hd)


def _gqa_out(probs, v, out_dtype):
    """probs: (B,KVH,rep,Sq,Sk), v: (B,Sk,KVH,hd) -> (B,Sq,H,hd)."""
    B, KVH, rep, Sq, Sk = probs.shape
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs.to(v.dtype), v)
    return out.reshape(B, Sq, KVH * rep, v.shape[-1]).to(out_dtype)


def causal_attention(q, k, v, window: Optional[int] = None,
                     q_block: int = 1024, q_start: int = 0,
                     span: Optional[tuple] = None) -> torch.Tensor:
    """Blockwise causal (optionally sliding-window) attention as explicit
    masked softmax (no fused attention op, so the precision path is the
    reference's).  Each query tile attends only to the block-aligned keys
    it can see: with a window it starts at ``(q_start - window) // qb * qb``.
    ``q_start``: the queries are positions ``q_start, q_start + 1, ...`` of
    the sequence whose keys ``k`` / ``v`` hold positions ``0, 1, ...`` (a
    serving rank's chunk of a prompt over data; the window holds across
    the chunk's edge).  ``span``: ``(start, length)`` of the query positions
    whose tiling to keep (default the queries' own): the queries are a part
    of them, and each attends over its tile's keys of that tiling, masked
    alike, so its row is the whole span's bit for bit (a model rank's block
    of a data rank's chunk; ``k`` / ``v`` then reach the tile's end)."""
    B, S, H, hd = q.shape
    origin, length = (q_start, S) if span is None else span
    qb = min(q_block, length)
    outs = []
    for t0 in range(origin, origin + length, qb):
        t1 = min(t0 + qb, origin + length)
        q0, q1 = max(t0, q_start), min(t1, q_start + S)
        if q0 >= q1:
            continue
        k_start = 0 if window is None else max(0, (t0 - window) // qb * qb)
        scores = _gqa_scores(q[:, q0 - q_start:q1 - q_start], k[:, k_start:t1])
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        k_pos = torch.arange(k_start, t1, device=q.device)[None, :]
        hidden = k_pos > q_pos
        if window is not None:
            hidden |= k_pos <= q_pos - window
        scores = scores.masked_fill(hidden, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        outs.append(_gqa_out(probs, v[:, k_start:t1], q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def full_attention(q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional (encoder / cross) attention over every key; ``mask``
    (broadcast against the (B, KVH, rep, Sq, Sk) scores) hides the keys
    where it is False."""
    scores = _gqa_scores(q, k)
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    return _gqa_out(torch.softmax(scores, dim=-1), v, q.dtype)


def decode_attention(q, k_cache, v_cache, valid_mask) -> torch.Tensor:
    """One-token query against a KV cache.

    q: (B,1,H,hd); caches: (B,S,KVH,hd); valid_mask: (S,) or (B,S) bool.
    """
    scores = _gqa_scores(q, k_cache)                      # (B,g,r,1,S)
    if valid_mask.dim() == 1:
        m = valid_mask[None, None, None, None, :]
    else:
        m = valid_mask[:, None, None, None, :]
    scores = scores.masked_fill(~m, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v_cache, q.dtype)


def split_decode_attention(q, k_cache, v_cache, valid_mask, axis) -> torch.Tensor:
    """:func:`decode_attention` over a cache whose slots lie over the data
    group ``axis`` (each rank its block; ``valid_mask`` (S_block,) its
    slots the query sees): each rank's f32 scores of its block, their
    maximum all-reduced (max), then one all-reduce (sum) of each rank's
    sum of ``exp(score - max)`` and those weights times its values, packed
    in one f32 buffer; the output is the summed values over the summed
    weights.  Every rank ends with the same bits.  The weights stay f32
    where the dense path rounds its probabilities to ``v``'s dtype."""
    from repro_torch.distributed import comm

    scores = _gqa_scores(q, k_cache).masked_fill(
        ~valid_mask[None, None, None, None, :], float("-inf"))   # (B, g, r, 1, S)
    top = comm.all_reduce(scores.amax(dim=-1), axis, "max")
    w = torch.exp(scores - top[..., None])
    B, KVH, rep, _, _ = w.shape
    hd = v_cache.shape[-1]
    vals = torch.einsum("bgrqk,bkgh->bgrqh", w, v_cache.to(F32))    # (B, g, r, 1, hd)
    packed = comm.all_reduce(torch.cat([w.sum(dim=-1, keepdim=True), vals], dim=-1), axis)
    out = packed[..., 1:] / packed[..., :1]
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, KVH * rep, hd).to(q.dtype)


def attn_qkv(wq, wk, wv, x, positions, cfg, heads=None):
    """q, k, v (B, S, heads, hd) after RoPE; ``heads``: (query heads, KV
    heads) of the given weights where they are a model-parallel rank's
    (default: the config's)."""
    B, S, _ = x.shape
    nq, nkv = heads if heads is not None else (cfg.n_heads, cfg.n_kv_heads)
    q = (x @ wq.to(x.dtype)).reshape(B, S, nq, cfg.hd)
    k = (x @ wk.to(x.dtype)).reshape(B, S, nkv, cfg.hd)
    v = (x @ wv.to(x.dtype)).reshape(B, S, nkv, cfg.hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_proj_out(wo, out: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = out.shape
    return out.reshape(B, S, H * hd) @ wo.to(out.dtype)


def mlp_apply(w1, w2, x: torch.Tensor, cfg, w3=None) -> torch.Tensor:
    h = act_fn(cfg.act)(x @ w1.to(x.dtype))
    if w3 is not None:
        h = h * (x @ w3.to(x.dtype))
    return h @ w2.to(x.dtype)


# ---------------------------------------------------------------------------
# MoE: top-k routing, a stable sort by expert, one product per expert
# ---------------------------------------------------------------------------

def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``(n,)`` int64 occurrences of 0..n-1 in ``idx``, by comparison: on the
    card ``torch.bincount`` and ``F.one_hot`` read the input's range on the
    host."""
    return (idx.reshape(-1, 1) == torch.arange(n, device=idx.device)).sum(0)


def _host_sizes(counts: torch.Tensor, rows: int) -> list:
    """The group sizes of ``rows`` sorted rows on the host: the MoE layer's
    one device sync per call, exempt from the sanitizer's ban on implicit
    host syncs (also where activation checkpointing runs the layer again in
    the backward).  A
    ``meta`` tensor holds no counts to read, so there the ``rows`` are split
    evenly over the groups, the first ``rows % n`` one longer: the dry-run
    (``repro_torch.launch.dryrun``) reckons :func:`grouped_mm`'s FLOPs and
    output bytes, which are the same for every split of the same rows.
    Card and CPU tensors are always read."""
    if counts.is_meta:
        n = counts.numel()
        return [rows // n + (e < rows % n) for e in range(n)]
    if not counts.is_cuda:
        return counts.tolist()  # noqa: RPR002 the group sizes, read on the host (a CPU tensor)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return counts.tolist()  # noqa: RPR002 MoE's one sanctioned sync: grouped_mm's sizes
    finally:
        torch.cuda.set_sync_debug_mode(prev)


_RAGGED = threading.local()


def in_ragged_dot() -> bool:
    """True while :func:`grouped_mm` runs its per-expert products on this
    thread (the ``"dots"`` remat policy leaves them unsaved)."""
    return getattr(_RAGGED, "depth", 0) > 0


def grouped_mm(x: torch.Tensor, w: torch.Tensor, sizes: list) -> torch.Tensor:
    """``jax.lax.ragged_dot``: the rows of ``x`` (sorted by group) in groups
    of ``sizes`` rows, group e times ``w[e]``, in x's dtype."""
    _RAGGED.depth = getattr(_RAGGED, "depth", 0) + 1
    try:
        return torch.cat([xe @ we for xe, we in zip(torch.split(x, sizes), w.unbind(0))])
    finally:
        _RAGGED.depth -= 1


class MoESplit(NamedTuple):
    """How a model-parallel rank holds a MoE layer's leaves
    (:func:`moe_apply`'s ``tp``): ``axis`` the model group; ``router``
    ``"E"`` (its (d, E / M) block of experts), ``"d"`` (its (d / M, E) rows)
    or None (whole); ``experts`` True where ``we1`` / ``we3`` are its (E, d,
    d_ff / M) and ``we2`` its (E, d_ff / M, d) blocks, False where they are
    whole; ``shared`` the same for the shared experts' ``w1`` / ``w3`` /
    ``w2``; ``seq``: under sequence parallelism the rank's block of the
    sequence (``tensor_parallel.SeqSplit``), else None."""

    axis: object
    router: Optional[str]
    experts: bool
    shared: bool
    seq: object = None


def route(probs: torch.Tensor, k: int) -> tuple:
    """(the top-``k`` probabilities, their experts), each (T, k): the
    routing decision of :func:`moe_apply`."""
    return torch.topk(probs, k, dim=-1)


def _router_logits(router, xt, xc, tp) -> torch.Tensor:
    """The (T, E) f32 router logits, the same on every rank of a model
    group: a (d, E / M) block's logits gathered over the group (each rank
    holds the whole logits' gradient and keeps its columns), a (d / M, E)
    block's partial logits of its rows of ``xc`` all-reduced in f32."""
    from repro_torch.distributed import tensor_parallel as TP

    if tp.router is None:
        return xt.to(F32) @ router.to(F32)
    if tp.router == "E":
        return TP.gather(xc.to(F32) @ router.to(F32), tp.axis, 1)
    n = router.shape[0]
    rows = xc[:, tp.axis.rank * n:(tp.axis.rank + 1) * n]
    return TP.reduce_from(rows.to(F32) @ router.to(F32), tp.axis)


def moe_apply(p: dict, x: torch.Tensor, cfg, rows=None, tp: MoESplit = None) -> tuple:
    """The reference's ``moe_apply``: returns (out (B, S, d), f32 aux loss).

    ``p``: ``router`` (d, E) f32, ``we1`` / ``we3`` (E, d, d_ff), ``we2``
    (E, d_ff, d) and, with shared experts, ``shared`` = ``{"w1", "w2"[,
    "w3"]}``.  Routing in f32: softmax over ``x @ router``, top-k
    (:func:`route`), gates renormalised with a 1e-9 floor; the Switch aux
    loss from the top-1 expert.  ``moe_impl="ragged"`` sorts the
    token-expert pairs by expert (stable, as ``jnp.argsort``) and runs one
    product per expert (:func:`grouped_mm`: the group sizes are read on the
    host once per call); ``"dense"`` runs every expert on every token.  The
    ``scatter`` combine adds each token's K weighted outputs in sorted
    order, one rounding per add in the activation dtype as the reference's
    scatter-add applies them; ``ksum`` contracts them with the gates.

    ``rows``: the zero group (``Topology.zp``) of an FSDP rank that holds
    its rows of the microbatch.  The aux loss is then the whole
    microbatch's: the top-1 counts and the sums of the router's
    probabilities all-reduced over it (``<name>@zero``), the same value on
    every zero rank; its gradient reaches the rank's own tokens scaled by Z,
    so that the zero ranks' gradients, summed and divided by Z
    (``core.dsm.worker_grads``), are the whole microbatch's.

    ``tp``: on a model-parallel rank, which of ``p``'s leaves are its
    blocks (:class:`MoESplit`); x is the same on every rank of the group.
    The router's logits come whole to every rank (:func:`_router_logits`),
    so the probabilities, routes, gates, aux loss and group sizes are the
    same on each.  With ``experts`` each rank runs every expert's d_ff
    slice: ``we1`` / ``we3`` column- and ``we2`` row-parallel, the partial
    outputs all-reduced (f32, rounded once): for ``scatter`` the (TK, d)
    products before the combine, so each add rounds as the reference's; for
    ``ksum`` and ``moe_impl="dense"`` the (T, d) combined output, whose
    gates then pass through ``copy_to`` (their gradient from each rank's
    partial output is partial).  The shared experts are the dense MLP split
    (one all-reduce of their output).  One ``copy_to`` of the layer's (T,
    d) input sums the partial gradients of every split product.

    With ``tp.seq`` (sequence parallelism) x is the rank's (B, S / M, d)
    block of the sequence, and so is the output.  The blocks are gathered
    (``"sum"``: the gradient reduce-scattered): every rank routes the whole
    sequence alike, the alike consumers reading it through ``own_rows``;
    each partial output is reduce-scattered over the sequence, and each
    output every rank computes alike (the ``scatter`` combine after its
    all-reduce, experts held whole) is cut to the rank's block
    (``split``)."""
    from repro_torch.distributed import tensor_parallel as TP

    split = tp if tp is not None else MoESplit(None, None, False, False)
    if split.seq is not None:
        x = TP.gather(x, split.axis, 1, "sum")
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    if split.seq is not None:
        xc, xt = xt, TP.own_rows(x, split.axis, 1).reshape(B * S, d)
    else:
        xc = (TP.copy_to(xt, split.axis) if split.router or split.experts or split.shared
              else xt)
    E, K = cfg.n_experts, cfg.top_k
    T, dt = B * S, xt.dtype
    act = act_fn(cfg.act)

    def reduce(t):
        """A (T, d) partial output, summed over the group."""
        if split.seq is None:
            return TP.reduce_from(t, split.axis)
        return TP.reduce_scatter(t.reshape(B, S, d), split.axis, 1)

    def keep(t):
        """A (T, d) output every rank computes alike."""
        if split.seq is None:
            return t
        return TP.split(t.reshape(B, S, d), split.axis, 1)

    logits = _router_logits(p["router"], xt, xc, split)     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = route(probs, K)                 # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style), from the top-1 expert
    if rows is None:
        density = _counts(expert_idx[:, 0], E).to(F32) / T
        aux = E * torch.sum(density * probs.mean(dim=0))
    else:
        from repro_torch.distributed import comm

        n = T * rows.world
        density = comm.all_reduce(_counts(expert_idx[:, 0], E), rows).to(F32) / n
        psum = probs.sum(dim=0)
        whole = comm.all_reduce(psum.detach().clone(), rows)
        # the whole microbatch's sums, the gradient of the rank's own Z times
        psum = whole + rows.world * (psum - psum.detach())
        aux = E * torch.sum(density * (psum / n))

    xe = xc if split.experts else xt
    if split.experts and (cfg.moe_impl == "dense" or cfg.moe_combine == "ksum"):
        # each rank's partial output makes the gates' gradient partial
        gate_vals = TP.copy_to(gate_vals, split.axis)
    if cfg.moe_impl == "dense":
        gates = torch.zeros(T, E, dtype=dt, device=x.device).scatter(
            1, expert_idx, gate_vals.to(dt))
        h = act(torch.einsum("td,edf->tef", xe, p["we1"].to(dt)))
        if "we3" in p:
            h = h * torch.einsum("td,edf->tef", xe, p["we3"].to(dt))
        out = torch.einsum("tef,efd,te->td", h, p["we2"].to(dt), gates)
        out = reduce(out) if split.experts else keep(out)
    else:
        flat_expert = expert_idx.reshape(T * K)
        sort_idx = torch.argsort(flat_expert, stable=True)
        token_of = sort_idx // K
        xs = xe[token_of]                                   # (TK, d)
        sizes = _host_sizes(_counts(flat_expert, E), T * K)
        h = act(grouped_mm(xs, p["we1"].to(dt), sizes))
        if "we3" in p:
            h = h * grouped_mm(xs, p["we3"].to(dt), sizes)
        y = grouped_mm(h, p["we2"].to(dt), sizes)           # (TK, d)
        inv = torch.argsort(sort_idx)
        if cfg.moe_combine == "ksum":
            out = torch.einsum("tkd,tk->td", y[inv].reshape(T, K, d), gate_vals.to(dt))
            out = reduce(out) if split.experts else keep(out)
        else:
            if split.experts:
                y = TP.reduce_from(y, split.axis)
            w = gate_vals.reshape(T * K)[sort_idx].to(dt)
            # each token's K products in sorted order: its pairs by expert id
            contrib = (y * w[:, None])[inv].reshape(T, K, d)
            by_expert = torch.argsort(expert_idx, dim=1)
            contrib = contrib.gather(1, by_expert[:, :, None].expand(T, K, d))
            out = contrib[:, 0]
            for k in range(1, K):
                out = out + contrib[:, k]
            out = keep(out)
    if "shared" in p:
        sh = p["shared"]
        shared = mlp_apply(sh["w1"], sh["w2"], xc if split.shared else xt, cfg, w3=sh.get("w3"))
        out = out + (reduce(shared) if split.shared else keep(shared))
    return out.reshape(B, -1, d), aux


def _column_input(x: torch.Tensor, tp, sp=None) -> torch.Tensor:
    """x as the input of column-parallel products: on a model-parallel rank
    (``tp`` its model group) through ``copy_to``, its gradient all-reduced;
    ``sp``: x is the rank's block of the sequence, gathered
    (``tensor_parallel.column_input``)."""
    if tp is None:
        return x
    from repro_torch.distributed import tensor_parallel as TP

    return TP.column_input(x, tp, sp)


def _row_parallel(y: torch.Tensor, w, tp, sp=None) -> torch.Tensor:
    """y @ w; on a model-parallel rank (``tp`` its model group) w is its
    rows and the partial products are all-reduced (``sp``:
    reduce-scattered over the sequence)."""
    out = y @ w.to(y.dtype)
    if tp is None:
        return out
    from repro_torch.distributed import tensor_parallel as TP

    return TP.row_output(out, tp, sp)


# ---------------------------------------------------------------------------
# Depthwise causal conv (the Mamba-2 and RG-LRU front conv)
# ---------------------------------------------------------------------------

def conv1d_apply(p: dict, x: torch.Tensor, history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv over x (B, S, C): ``p["w"]`` (width, C),
    ``p["b"]`` (C,).  The reference's sum of ``width`` shifted products in
    x's dtype, added in its order (``F.conv1d`` would accumulate otherwise
    in bf16); the causal padding is zeros, or ``history`` (B, width - 1, C),
    the inputs of the width - 1 positions before x (:func:`conv_edges`)."""
    width, S = p["w"].shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0)) if history is None else torch.cat([history, x], dim=1)
    w = p["w"].to(x.dtype)
    out = xp[:, 0:S] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + S] * w[i]
    return out + p["b"].to(x.dtype)


def conv1d_step(p: dict, conv_state: torch.Tensor, x_t: torch.Tensor) -> tuple:
    """Decode: conv_state (B, width - 1, C), x_t (B, C) -> (y_t, the new
    state: the window's last width - 1 rows).  Accumulates in f32."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)          # (B, width, C)
    y = (window.to(F32) * p["w"].to(F32)).sum(dim=1)
    y = (y + p["b"].to(F32)).to(x_t.dtype)
    return y, window[:, 1:]


def conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The conv state after a prompt x (B, S, C): its last ``width - 1``
    rows, left-padded with zeros when S is shorter (the causal padding of
    :func:`conv1d_apply`).  The reference keeps only the S rows there, and
    its decode then fails on a prompt shorter than width - 1."""
    tail = x[:, -(width - 1):]
    return F.pad(tail, (0, 0, width - 1 - tail.shape[1], 0))


def conv_edges(x: torch.Tensor, width: int, seq) -> tuple:
    """x (B, n, C): a serving rank's chunk of a sequence over its data group
    (``seq``: ``tensor_parallel.SeqSplit``).  Returns (the conv inputs of
    the width - 1 positions before the chunk, the whole sequence's conv
    tail), each (B, width - 1, C), zero-padded on the left where the
    sequence before is shorter: every rank's last ``min(n, width - 1)``
    rows are all-gathered (one call), so a chunk shorter than width - 1
    reads the ranks before it too.  Every rank holds the same tail."""
    from repro_torch.distributed import comm

    t = min(x.shape[1], width - 1)
    tails = comm.all_gather_dim(x[:, x.shape[1] - t:].contiguous(), seq.axis, 1)  # (B, D t, C)
    return conv_tail(tails[:, :seq.index * t], width), conv_tail(tails, width)


def _carried(decay: torch.Tensor, state: torch.Tensor, seq) -> tuple:
    """A linear recurrence h = decay * h + ... across the chunks of a
    sequence over a serving rank's data group (``seq``): ``decay`` (B, G)
    f32 is the product of the rank's chunk's decays, ``state`` (B, G, K)
    f32 its state after the chunk from zero.  Every rank's pair is
    all-gathered (one f32 call) and folded in rank order from zero, h =
    decay_j * h + state_j.  Returns (the state carried into the rank's
    chunk, the state after the whole sequence); every rank folds the same
    numbers in the same order, so every rank holds the same final state."""
    from repro_torch.distributed import comm

    both = comm.all_gather_dim(torch.cat([decay[..., None], state], dim=-1)[None], seq.axis, 0)
    h = torch.zeros_like(state)
    for j in range(seq.world):
        if j == seq.index:
            before = h
        h = h * both[j, ..., :1] + both[j, ..., 1:]
    return before, h


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, state-space duality, chunked)  [arXiv:2405.21060]
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) -> (..., L, L) with out[i, j] = sum_{j<k<=i} x[k] and -inf
    above the diagonal.  Each segment's sum runs up from k = j + 1 (a cumsum
    down the rows of x masked to k > j), where the reference takes the
    difference of two prefix sums: the same numbers, without the rounding
    of prefix sums that reach ~10^3 within a 128-position chunk (an f32 ulp
    of ~1e-4 there, which exp turns into a relative error of the decay).
    The -inf is a masked fill: zero gradient there, never inf - inf."""
    L_ = x.shape[-1]
    ones = torch.ones(L_, L_, dtype=torch.bool, device=x.device)
    rows = x[..., :, None].expand(*x.shape, L_).masked_fill(~torch.tril(ones, -1), 0.0)
    return torch.cumsum(rows, dim=-2).masked_fill(~torch.tril(ones), float("-inf"))


def _suffix_sums(x: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_{k>s} x[k] along ``dim`` (0 at the last position): a reversed
    cumsum shifted by one, so the sums near the end, the ones whose exp
    matters, are not the difference of two large prefix sums."""
    rev = torch.flip(torch.cumsum(torch.flip(x, [dim]), dim=dim), [dim])
    n = x.shape[dim]
    return torch.cat([rev.narrow(dim, 1, n - 1), torch.zeros_like(rev.narrow(dim, 0, 1))],
                     dim=dim)


SSD_CHUNK = 128         # the SSD's chunk (the reference's): a longer sequence is a multiple


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = SSD_CHUNK,
                initial_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Mamba-2 SSD scan, chunked (the reference's minimal version of the
    paper's Listing 1), in f32.

    x: (B, S, H, P) value heads; dt: (B, S, H) > 0; A: (H,) > 0 decay rate;
    Bm, Cm: (B, S, N) single-group projections.  Returns y (B, S, H, P).
    The reference's four-operand einsums are pairwise products in a fixed
    order (``torch.einsum`` would let ``opt_einsum``, where installed, pick
    the order); the inter-chunk recurrence is a loop over the S / chunk
    chunks, from ``initial_state`` (B, H, P, N) f32 (default zeros: the
    state the earlier chunks of a sequence over data carry in).  S must be
    a multiple of ``chunk``, as the reference asserts."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length must be divisible by ssd chunk: S={S}, "
                         f"chunk={chunk}")
    nc = S // chunk
    dA = (-A[None, None, :] * dt).to(F32)                  # (B, S, H) log-decay (< 0)
    xw = x.to(F32) * dt[..., None]                         # dt-weighted input

    def c(t):
        return t.reshape(Bsz, nc, chunk, *t.shape[2:])

    xc = c(xw)                                             # (B, nc, Q, H, P)
    Bc, Cc = c(Bm.to(F32)), c(Cm.to(F32))                  # (B, nc, Q, N)
    dAc_h = c(dA).permute(0, 1, 3, 2)                      # (B, nc, H, Q)
    A_cum = torch.cumsum(dAc_h, dim=-1)
    xc_h = xc.permute(0, 1, 3, 2, 4)                       # (B, nc, H, Q, P)

    # 1) intra-chunk (diagonal blocks): (C B^T) * L, then times x
    Lmat = torch.exp(_segsum(dAc_h))                       # (B, nc, H, Q, Q)
    CB = Cc @ Bc.transpose(-1, -2)                         # (B, nc, Q, Q)
    Y_diag = (CB[:, :, None] * Lmat) @ xc_h                # (B, nc, H, Q, P)

    # 2) chunk states: x decayed to the chunk's end, times B
    decay_states = torch.exp(_suffix_sums(dAc_h, -1))      # (B, nc, H, Q): A_cum[-1] - A_cum
    states = (xc_h * decay_states[..., None]).transpose(-1, -2) @ Bc[:, :, None]
    # (B, nc, H, P, N)

    # 3) inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(A_cum[..., -1])                # (B, nc, H)
    carry = (torch.zeros(Bsz, H, P, N, dtype=F32, device=x.device) if initial_state is None
             else initial_state)
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                 # (B, nc, H, P, N)

    # 4) state -> output within the chunk
    state_decay_out = torch.exp(A_cum)                     # (B, nc, H, Q)
    Y_off = (Cc[:, :, None] @ prev_states.transpose(-1, -2)) * state_decay_out[..., None]
    y = (Y_diag + Y_off).permute(0, 1, 3, 2, 4)            # (B, nc, Q, H, P)
    return y.reshape(Bsz, S, H, P)


def _mamba2_split(p: dict, x: torch.Tensor, cfg) -> tuple:
    """The in-projection of x (..., d), split: z, the conv's input (x, B, C
    streams) and dt before its softplus, at the widths of ``p``'s heads
    (all of them, or a model-parallel rank's)."""
    di, H = p["norm"]["scale"].shape[-1], p["A_log"].shape[-1]
    proj = x @ p["in_proj"].to(x.dtype)
    z, conv_in, dt = torch.split(proj, [di, di + 2 * cfg.ssm_state, H], dim=-1)
    return z, conv_in, dt


def _mamba2_out(p: dict, y: torch.Tensor, z: torch.Tensor, x_dtype, cfg,
                tp=None, sp=None) -> torch.Tensor:
    """The gated RMSNorm of y (f32) and the out-projection; on a
    model-parallel rank (``tp`` its model group) over its heads' channels:
    the norm's mean of squares over every head's (:func:`_split_rmsnorm`),
    ``out_proj`` row-parallel with one all-reduce."""
    g, scale = y.to(x_dtype) * F.silu(z), p["norm"]["scale"]
    g = rmsnorm(scale, g) if tp is None else _split_rmsnorm(scale, g, cfg.d_inner, tp)
    return _row_parallel(g, p["out_proj"], tp, sp)


def _split_rmsnorm(scale, x: torch.Tensor, width: int, tp, eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm` of a vector whose ``width`` elements lie across the
    model group ``tp``, x (..., width / M) this rank's: the (..., 1) f32
    sums of squares all-reduced (forward; their gradient, partial on each
    rank, all-reduced backward), then this rank's elements scaled."""
    from repro_torch.distributed import tensor_parallel as TP

    xf = x.to(F32)
    sq = TP.copy_to(TP.reduce_from(torch.sum(xf * xf, dim=-1, keepdim=True), tp), tp)
    out = xf * torch.rsqrt(sq / width + eps) * (1.0 + scale.to(F32))
    return out.to(x.dtype)


def mamba2_apply(p: dict, x: torch.Tensor, cfg, state_out: Optional[dict] = None, tp=None,
                 seq=None, sp=None):
    """The training / prefill path, x (B, S, d) -> (B, S, d).  ``p``: the
    block's ``ssm`` leaves nested as the reference's (``in_proj``, ``conv``
    {``w``, ``b``}, ``A_log``, ``D``, ``dt_bias``, ``norm`` {``scale``},
    ``out_proj``).  The SSD runs in chunks of ``min(128, S)``.  With a dict
    ``state_out`` the state after the last position lands in it, as the
    reference's ``_mamba2_final_state`` computes it: ``state`` (B, H, P, N)
    f32 and ``conv`` (B, width - 1, d_inner + 2N), the conv's input tail
    (:func:`conv_tail`).

    ``tp``: on a model-parallel rank its model group, x the same on every
    rank, and ``p`` the rank's slices for its H / M heads: ``in_proj``'s
    columns of their z, x and dt and all of B and C, ``conv``'s channels of
    their x and all of B and C, their ``A_log``, ``D``, ``dt_bias``,
    ``norm`` and ``out_proj`` rows.  The conv, the SSD and the skip run on
    those heads (the SSD is per head), the gated norm and the out-projection
    as :func:`_mamba2_out`; x passes through ``copy_to``, and the state is
    the rank's heads' (B, H / M, P, N) and channels' (B, width - 1, d_inner
    / M + 2N).  ``sp``: with ``tp``, x is the rank's block of the sequence
    over its model group: gathered in, the output reduce-scattered
    (:func:`_column_input`, :func:`_row_parallel`).

    ``seq``: x is a serving rank's chunk of a sequence over its data group
    (``tensor_parallel.SeqSplit``).  The conv reads the inputs before the
    chunk (:func:`conv_edges`); the rank's chunk state from zero
    (:func:`_ssd_final_state`) and its decay are carried across the ranks
    (:func:`_carried`), and the SSD runs from the state carried in; the
    state and conv tail after the whole sequence, the same on every rank,
    land in ``state_out``."""
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = p["A_log"].shape[-1]
    di = H * P
    width = p["conv"]["w"].shape[0]
    z, conv_in, dt = _mamba2_split(p, _column_input(x, tp, sp), cfg)
    history = tail = None
    if seq is not None:
        history, tail = conv_edges(conv_in, width, seq)
    conv_out = F.silu(conv1d_apply(p["conv"], conv_in, history))
    xs, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])             # (B, S, H)
    A = torch.exp(p["A_log"])                              # (H,) > 0
    xh = xs.reshape(*xs.shape[:2], H, P)
    before = state = None
    if seq is not None:
        B = xh.shape[0]
        decay = torch.exp(-A[None] * dt.sum(dim=1))        # (B, H): the chunk's decay
        before, state = _carried(decay, _ssd_final_state(xh, dt, A, Bm).reshape(B, H, P * N),
                                 seq)
        before, state = before.reshape(B, H, P, N), state.reshape(B, H, P, N)
    y = ssd_chunked(xh, dt, A, Bm, Cm, chunk=min(SSD_CHUNK, xs.shape[1]), initial_state=before)
    y = y + p["D"][None, None, :, None] * xh.to(F32)
    if state_out is not None:
        if seq is None:
            state, tail = _ssd_final_state(xh, dt, A, Bm), conv_tail(conv_in, width)
        state_out.update(state=state, conv=tail)
    return _mamba2_out(p, y.reshape(*xs.shape[:2], di), z, x.dtype, cfg, tp, sp)


def _ssd_final_state(xh, dt, A, Bm) -> torch.Tensor:
    """The recurrence's state after the last of S positions, (B, H, P, N)
    f32, in closed form: sum_s w_s dt_s x_s B_s^T with w_s = exp(-A sum_{k>s}
    dt_k), the decay from s to the end: ``ssd_chunked``'s chunk-state
    weight over the whole prompt (:func:`_suffix_sums`)."""
    w = torch.exp(_suffix_sums(-A[None, None, :] * dt, 1)) * dt   # (B, S, H)
    wx = xh.to(F32) * w[..., None]                                # (B, S, H, P)
    return wx.permute(0, 2, 3, 1) @ Bm.to(F32)[:, None]           # (B, H, P, N)


def mamba2_decode(p: dict, cache: dict, x_t: torch.Tensor, cfg, tp=None) -> tuple:
    """One-token recurrent step, x_t (B, d); cache ``{"state": (B, H, P, N)
    f32, "conv": (B, width - 1, C)}``.  Returns (out (B, d), the new
    cache dict); the caller writes it back.  ``tp``: as
    :func:`mamba2_apply`'s, the cache the rank's heads' and channels'."""
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = p["A_log"].shape[-1]
    di = H * P
    z, conv_in, dt = _mamba2_split(p, x_t, cfg)
    conv_y, new_conv = conv1d_step(p["conv"], cache["conv"], conv_in)
    xs, Bm, Cm = torch.split(F.silu(conv_y), [di, N, N], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])             # (B, H)
    A = torch.exp(p["A_log"])
    dA = torch.exp(-A[None] * dt)                          # (B, H)
    xh = xs.reshape(-1, H, P).to(F32)
    dBx = (dt[:, :, None] * xh)[..., None] * Bm.to(F32)[:, None, None, :]
    new_state = cache["state"] * dA[..., None, None] + dBx
    y = (new_state @ Cm.to(F32)[:, None, :, None])[..., 0]  # (B, H, P)
    y = y + p["D"][None, :, None] * xh
    out = _mamba2_out(p, y.reshape(-1, di), z, x_t.dtype, cfg, tp)
    return out, {"state": new_state, "conv": new_conv}


def mamba2_init_cache(cfg, batch: int, dtype, lead: tuple = (), device=None,
                      heads: int = None) -> dict:
    """Zero ``{"state": (*lead, B, H, P, N) f32, "conv": (*lead, B, width -
    1, d_inner + 2N) dtype}``; ``heads``: a model-parallel rank's H / M
    in place of H (and its H / M * P of d_inner)."""
    H, P, N = heads or cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {"state": torch.zeros(lead + (batch, H, P, N), dtype=F32, device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, H * P + 2 * N),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)  [arXiv:2402.19427]
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def _rglru_coeffs(p: dict, xc: torch.Tensor, tp=None) -> tuple:
    """xc (..., d_rnn), the conv's output -> (a, b) of h = a * h_prev + b,
    f32.  ``tp``: on a model-parallel rank its model group, xc its channels'
    (..., d_rnn / M) and ``w_a`` / ``w_x`` its (d_rnn, d_rnn / M) output
    columns: the gates read every channel, so xc is gathered over the group
    (its gradient reduce-scattered)."""
    xw = xc
    if tp is not None:
        from repro_torch.distributed import tensor_parallel as TP

        xw = TP.gather(xc, tp, xc.dim() - 1, "sum")
    r = torch.sigmoid((xw @ p["w_a"].to(xc.dtype)).to(F32))
    i = torch.sigmoid((xw @ p["w_x"].to(xc.dtype)).to(F32))
    log_a = -_RGLRU_C * r * F.softplus(p["lam"])           # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * (i * xc.to(F32))
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h_{-1} = 0, i.e. the ``h``
    of ``jax.lax.associative_scan(combine, (a, b), axis=1)`` with combine
    ((al, bl), (ar, br)) = (al * ar, br + ar * bl), in the same recursion
    and so the same association order (:func:`_scan`).  About 2 log2(S)
    levels of a few elementwise ops each; O(S) work."""
    return _scan(a, b)[1]


def _scan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``jax.lax.associative_scan``'s recursion over axis 1: combine adjacent
    pairs, scan the half-length result (the odd outputs), then combine those
    with the even inputs (the even outputs), and interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine(l, r) of each adjacent pair, r the later element
    ra = a[:, 0:n - 1:2] * a[:, 1::2]
    rb = b[:, 1::2] + a[:, 1::2] * b[:, 0:n - 1:2]
    odd_a, odd_b = _scan(ra, rb)
    k = odd_a.shape[1] - (n % 2 == 0)
    ev_a = torch.cat([a[:, :1], odd_a[:, :k] * a[:, 2::2]], dim=1)
    ev_b = torch.cat([b[:, :1], b[:, 2::2] + a[:, 2::2] * odd_b[:, :k]], dim=1)
    return _interleave(ev_a, odd_a), _interleave(ev_b, odd_b)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """out[:, 2k] = even[:, k], out[:, 2k + 1] = odd[:, k] (even as long as
    odd or one longer)."""
    n_odd = odd.shape[1]
    pairs = torch.stack([even[:, :n_odd], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n_odd:]], dim=1) if even.shape[1] > n_odd else pairs


def rglru_apply(p: dict, x: torch.Tensor, cfg, state_out: Optional[dict] = None, tp=None,
                seq=None, sp=None):
    """The training / prefill path, x (B, S, d) -> (B, S, d): the tanh-GELU
    gate, the conv, the RG-LRU recurrence over S (:func:`linear_scan`).
    ``p``: the block's ``rglru`` leaves nested as the reference's
    (``in_x``, ``in_gate``, ``conv`` {``w``, ``b``}, ``w_a``, ``w_x``,
    ``lam``, ``out``).  With a dict ``state_out`` the state after the last
    position lands in it, as the reference's ``_rglru_final_state``
    computes it: ``h`` (B, d_rnn) f32 and ``conv`` (B, width - 1, d_rnn),
    the conv's input tail (:func:`conv_tail`).

    ``tp``: on a model-parallel rank its model group, x the same on every
    rank, and ``p`` the rank's slices for its d_rnn / M channels: ``in_x``
    / ``in_gate`` / ``w_a`` / ``w_x`` columns, ``conv`` and ``lam``
    channels, ``out`` rows.  The gate, the conv, the scan (per channel) run
    on those channels, ``w_a`` / ``w_x`` over the gathered conv output
    (:func:`_rglru_coeffs`), ``out`` row-parallel with one all-reduce; x
    passes through ``copy_to``, and the state is the rank's channels'.
    ``sp``: as :func:`mamba2_apply`'s.

    ``seq``: x is a serving rank's chunk of a sequence over its data group,
    as :func:`mamba2_apply`'s: the conv reads the inputs before the chunk,
    the rank scans its chunk from zero, and its (product of a, h at its
    end) is carried across the ranks (:func:`_carried`): h plus the
    carried state times the running product of a."""
    x_in = _column_input(x, tp, sp)
    width = p["conv"]["w"].shape[0]
    gate = F.gelu((x_in @ p["in_gate"].to(x.dtype)).to(F32), approximate="tanh")
    xr = x_in @ p["in_x"].to(x.dtype)
    history = tail = None
    if seq is not None:
        history, tail = conv_edges(xr, width, seq)
    a, b = _rglru_coeffs(p, conv1d_apply(p["conv"], xr, history), tp)   # (B, S, d_rnn)
    if seq is None:
        h = linear_scan(a, b)
        if state_out is not None:
            state_out.update(h=h[:, -1], conv=conv_tail(xr, width))
    else:
        prod, h = _scan(a, b)
        before, last = _carried(prod[:, -1], h[:, -1, :, None], seq)
        h = h + prod * before[:, None, :, 0]
        if state_out is not None:
            state_out.update(h=last[..., 0], conv=tail)
    y = (h * gate).to(x.dtype)
    return _row_parallel(y, p["out"], tp, sp)


def rglru_decode(p: dict, cache: dict, x_t: torch.Tensor, cfg, tp=None) -> tuple:
    """x_t (B, d); cache ``{"h": (B, d_rnn) f32, "conv": (B, width - 1,
    d_rnn)}``.  Returns (out (B, d), the new cache dict); the caller
    writes it back.  ``tp``: as :func:`rglru_apply`'s, the cache the
    rank's channels'."""
    gate = F.gelu((x_t @ p["in_gate"].to(x_t.dtype)).to(F32), approximate="tanh")
    xr = x_t @ p["in_x"].to(x_t.dtype)
    xc, new_conv = conv1d_step(p["conv"], cache["conv"], xr)
    a, b = _rglru_coeffs(p, xc, tp)                        # (B, d_rnn)
    new_h = a * cache["h"] + b
    y = (new_h * gate).to(x_t.dtype)
    return _row_parallel(y, p["out"], tp), {"h": new_h, "conv": new_conv}


def rglru_init_cache(cfg, batch: int, dtype, lead: tuple = (), device=None,
                     channels: int = None) -> dict:
    """Zero ``{"h": (*lead, B, d_rnn) f32, "conv": (*lead, B, width - 1,
    d_rnn) dtype}``; ``channels``: a model-parallel rank's d_rnn / M in
    place of d_rnn."""
    n = channels or cfg.d_rnn
    return {"h": torch.zeros(lead + (batch, n), dtype=F32, device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, n), dtype=dtype,
                                device=device)}
