"""Model building blocks of the ``attn`` / ``swa`` / ``encattn`` / ``xattn``
mixers and the dense and MoE FFNs: RMSNorm, RoPE, causal GQA attention
(full or sliding-window), bidirectional attention (the encoder's and the
cross-attention's), one-token attention against a KV cache, the dense MLP
and the top-k routed mixture of experts, as plain PyTorch functions on
tensors.

They follow the reference's precision path: activations in
``cfg.act_dtype``, attention scores and softmax in f32, probabilities cast
to ``v.dtype`` before the PV product.  Quirks kept on purpose:

  * RMSNorm multiplies by ``(1 + scale)``, with ``scale`` initialised to ones;
  * RoPE uses the split-half convention, in f32;
  * GELU is the tanh approximation.
"""

from __future__ import annotations

import math
from typing import Optional

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
                     q_block: int = 1024) -> torch.Tensor:
    """Blockwise causal (optionally sliding-window) attention as explicit
    masked softmax (no fused attention op, so the precision path is the
    reference's).  Each query tile attends only to the block-aligned keys
    it can see: with a window it starts at ``(q_start - window) // qb * qb``."""
    B, S, H, hd = q.shape
    qb = min(q_block, S)
    outs = []
    for q_start in range(0, S, qb):
        q_end = min(q_start + qb, S)
        k_start = 0 if window is None else max(0, (q_start - window) // qb * qb)
        scores = _gqa_scores(q[:, q_start:q_end], k[:, k_start:q_end])
        q_pos = torch.arange(q_start, q_end, device=q.device)[:, None]
        k_pos = torch.arange(k_start, q_end, device=q.device)[None, :]
        hidden = k_pos > q_pos
        if window is not None:
            hidden |= k_pos <= q_pos - window
        scores = scores.masked_fill(hidden, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        outs.append(_gqa_out(probs, v[:, k_start:q_end], q.dtype))
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


def attn_qkv(wq, wk, wv, x, positions, cfg):
    B, S, _ = x.shape
    q = (x @ wq.to(x.dtype)).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (x @ wk.to(x.dtype)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (x @ wv.to(x.dtype)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
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


def _host_sizes(counts: torch.Tensor) -> list:
    """The group sizes on the host: the MoE layer's one device sync per
    call, exempt from the sanitizer's ban on implicit host syncs."""
    if not counts.is_cuda:
        return counts.tolist()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return counts.tolist()
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, sizes: list) -> torch.Tensor:
    """``jax.lax.ragged_dot``: the rows of ``x`` (sorted by group) in groups
    of ``sizes`` rows, group e times ``w[e]``, in x's dtype."""
    return torch.cat([xe @ we for xe, we in zip(torch.split(x, sizes), w.unbind(0))])


def moe_apply(p: dict, x: torch.Tensor, cfg) -> tuple:
    """The reference's ``moe_apply``: returns (out (B, S, d), f32 aux loss).

    ``p``: ``router`` (d, E) f32, ``we1`` / ``we3`` (E, d, d_ff), ``we2``
    (E, d_ff, d) and, with shared experts, ``shared`` = ``{"w1", "w2"[,
    "w3"]}``.  Routing in f32: softmax over ``x @ router``, top-k, gates
    renormalised with a 1e-9 floor; the Switch aux loss from the top-1
    expert.  ``moe_impl="ragged"`` sorts the token-expert pairs by expert
    (stable, as ``jnp.argsort``) and runs one product per expert
    (:func:`grouped_mm`: the group sizes are read on the host once per
    call); ``"dense"`` runs every expert on every token.  The ``scatter``
    combine adds each token's K weighted outputs in sorted order, one
    rounding per add in the activation dtype as the reference's scatter-add
    applies them; ``ksum`` contracts them with the gates.
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(B * S, d)
    T, dt = B * S, xt.dtype
    act = act_fn(cfg.act)

    logits = xt.to(F32) @ p["router"].to(F32)               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)    # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style), from the top-1 expert
    density = _counts(expert_idx[:, 0], E).to(F32) / T
    aux = E * torch.sum(density * probs.mean(dim=0))

    if cfg.moe_impl == "dense":
        gates = torch.zeros(T, E, dtype=dt, device=x.device).scatter(
            1, expert_idx, gate_vals.to(dt))
        h = act(torch.einsum("td,edf->tef", xt, p["we1"].to(dt)))
        if "we3" in p:
            h = h * torch.einsum("td,edf->tef", xt, p["we3"].to(dt))
        out = torch.einsum("tef,efd,te->td", h, p["we2"].to(dt), gates)
    else:
        flat_expert = expert_idx.reshape(T * K)
        sort_idx = torch.argsort(flat_expert, stable=True)
        token_of = sort_idx // K
        xs = xt[token_of]                                   # (TK, d)
        sizes = _host_sizes(_counts(flat_expert, E))
        h = act(grouped_mm(xs, p["we1"].to(dt), sizes))
        if "we3" in p:
            h = h * grouped_mm(xs, p["we3"].to(dt), sizes)
        y = grouped_mm(h, p["we2"].to(dt), sizes)           # (TK, d)
        inv = torch.argsort(sort_idx)
        if cfg.moe_combine == "ksum":
            out = torch.einsum("tkd,tk->td", y[inv].reshape(T, K, d), gate_vals.to(dt))
        else:
            w = gate_vals.reshape(T * K)[sort_idx].to(dt)
            # each token's K products in sorted order: its pairs by expert id
            contrib = (y * w[:, None])[inv].reshape(T, K, d)
            by_expert = torch.argsort(expert_idx, dim=1)
            contrib = contrib.gather(1, by_expert[:, :, None].expand(T, K, d))
            out = contrib[:, 0]
            for k in range(1, K):
                out = out + contrib[:, k]
    if "shared" in p:
        sh = p["shared"]
        out = out + mlp_apply(sh["w1"], sh["w2"], xt, cfg, w3=sh.get("w3"))
    return out.reshape(B, S, d), aux
