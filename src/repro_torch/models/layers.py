"""Model building blocks of the ``attn:dense`` subset: RMSNorm, RoPE, causal
GQA attention, one-token attention against a KV cache and the dense MLP,
as plain PyTorch functions on tensors.

They follow the reference's precision path: activations in
``cfg.act_dtype``, attention scores and softmax in f32, probabilities cast
to ``v.dtype`` before the PV product.  Quirks kept on purpose:

  * RMSNorm multiplies by ``(1 + scale)``, with ``scale`` initialised to ones;
  * RoPE uses the split-half convention, in f32;
  * GELU is the tanh approximation.
"""

from __future__ import annotations

import math

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


def causal_attention(q, k, v, q_block: int = 1024) -> torch.Tensor:
    """Blockwise causal attention as explicit masked softmax (no fused
    attention op, so the precision path is the reference's)."""
    B, S, H, hd = q.shape
    qb = min(q_block, S)
    outs = []
    for q_start in range(0, S, qb):
        q_end = min(q_start + qb, S)
        scores = _gqa_scores(q[:, q_start:q_end], k[:, :q_end])
        q_pos = torch.arange(q_start, q_end, device=q.device)[:, None]
        k_pos = torch.arange(0, q_end, device=q.device)[None, :]
        scores = scores.masked_fill(k_pos > q_pos, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        outs.append(_gqa_out(probs, v[:, :q_end], q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


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
