"""Decoder-only LM of the ``attn:dense`` pattern family (nano, GPT-2 and the
dense GQA/MQA archs): parameter shapes, init, forward over stacked blocks,
the chunked next-token cross-entropy, and serving: the KV cache, prefill
and one-token decode.

Parameters are a flat dict ``{path: tensor}`` keyed by the reference's
pytree paths (``"decoder.blocks.p0.attn.wq"``); stacked blocks keep their
leading layer axis and may also be given as a list of per-layer tensors.
``repro_torch.models.convert`` lays them out in one flat buffer.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.convert import FlatLayout

F32 = torch.float32
CE_CHUNK = 2048


def _parse_kind(kind: str) -> tuple[str, str]:
    mixer, _, ffn = kind.partition(":")
    return mixer, ffn or "dense"


def check_supported(cfg) -> None:
    bad = [k for k in cfg.pattern if _parse_kind(k) != ("attn", "dense")]
    if cfg.family != "lm" or bad:
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoder-only 'attn:dense' models; family "
            f"{cfg.family!r} / block kinds {bad} are not ported yet (ROADMAP.md)")


# ---------------------------------------------------------------------------
# Parameter tree: shapes + init distributions, nested as the reference's
# ---------------------------------------------------------------------------

def _block_spec(cfg, lead: tuple) -> dict:
    """One block's leaves as (shape, init) with init "ones" or a normal std."""
    d, h, kvh, hd, dff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    s = {
        "ln1": {"scale": (lead + (d,), "ones")},
        "attn": {
            "wq": (lead + (d, h * hd), 1.0 / math.sqrt(d)),
            "wk": (lead + (d, kvh * hd), 1.0 / math.sqrt(d)),
            "wv": (lead + (d, kvh * hd), 1.0 / math.sqrt(d)),
            "wo": (lead + (h * hd, d), 1.0 / math.sqrt(h * hd)),
        },
        "ln2": {"scale": (lead + (d,), "ones")},
        "mlp": {
            "w1": (lead + (d, dff), 1.0 / math.sqrt(d)),
            "w2": (lead + (dff, d), 1.0 / math.sqrt(dff)),
        },
    }
    if cfg.mlp_gated:
        s["mlp"]["w3"] = (lead + (d, dff), 1.0 / math.sqrt(d))
    return s


def param_spec(cfg) -> dict:
    """Nested ``{key: (shape, init)}`` tree with the reference's structure
    (``transformer.init_params``)."""
    check_supported(cfg)
    blocks = {}
    if cfg.n_scan_blocks > 0:
        for j, _ in enumerate(cfg.pattern):
            blocks[f"p{j}"] = _block_spec(cfg, (cfg.n_scan_blocks,))
    spec = {
        "embed": ((cfg.padded_vocab, cfg.d_model), 0.02),
        "final_norm": {"scale": ((cfg.d_model,), "ones")},
        "decoder": {"blocks": blocks,
                    "rem": tuple(_block_spec(cfg, ()) for _ in range(cfg.n_rem_layers))},
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((cfg.d_model, cfg.padded_vocab), 0.02)
    return spec


def layout(cfg) -> FlatLayout:
    return FlatLayout.from_tree(param_spec(cfg), is_leaf=_is_spec_leaf)


def _is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def init_params(gen: torch.Generator, cfg, device=None) -> torch.Tensor:
    """A flat ``(N,)`` buffer in ``cfg.p_dtype`` on ``device``: normal draws
    (std 1/sqrt(fan_in), 0.02 for the embedding) from ``gen``, ones for the
    norm scales — the reference's distributions, not its random numbers."""
    lay = layout(cfg)
    flat = torch.empty(lay.numel, dtype=cfg.p_dtype, device=device)
    views = lay.views(flat)
    for name, (shape, init) in zip(lay.names, lay.leaves):
        if init == "ones":
            views[name].fill_(1.0)
        else:
            w = torch.randn(shape, generator=gen, dtype=F32, device=gen.device) * init
            views[name].copy_(w)
    return flat


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(p, x, positions, cfg, kv_out=None):
    """One attn:dense block; ``p(name)`` returns the block's leaf.  With a
    dict ``kv_out`` the block's keys (after RoPE) and values land in it as
    ``k`` / ``v`` (B, S, KVH, hd), the prefill's cache entry."""
    h = L.rmsnorm(p("ln1.scale"), x, cfg.norm_eps)
    q, k, v = L.attn_qkv(p("attn.wq"), p("attn.wk"), p("attn.wv"), h, positions, cfg)
    if kv_out is not None:
        kv_out.update(k=k, v=v)
    out = L.causal_attention(q, k, v, q_block=cfg.q_block)
    x = x + L.attn_proj_out(p("attn.wo"), out)
    return _mlp_residual(p, x, cfg)


def _mlp_residual(p, x, cfg):
    h = L.rmsnorm(p("ln2.scale"), x, cfg.norm_eps)
    w3 = p("mlp.w3") if cfg.mlp_gated else None
    return x + L.mlp_apply(p("mlp.w1"), p("mlp.w2"), h, cfg, w3=w3)


def _layers(params: dict, cfg):
    """``(where, p)`` of every layer in order: ``where`` is ``("blocks", "p<j>",
    i)`` for layer i of the stacked pattern position j or ``("rem", i, None)``
    for a remainder layer; ``p(name)`` returns that layer's leaf."""
    for i in range(cfg.n_scan_blocks):
        for j, _ in enumerate(cfg.pattern):
            pre = f"decoder.blocks.p{j}."
            yield ("blocks", f"p{j}", i), (lambda n, pre=pre, i=i: params[pre + n][i])
    for i in range(cfg.n_rem_layers):
        pre = f"decoder.rem.{i}."
        yield ("rem", i, None), (lambda n, pre=pre: params[pre + n])


def _embed(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Embedding rows cast to the activation dtype, scaled by sqrt(d_model)."""
    return params["embed"][tokens].to(cfg.act_dtype) * math.sqrt(cfg.d_model)


def hidden_states(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Embedding, the blocks in layer order, the final norm."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for _, p in _layers(params, cfg):
        x = _apply_block(p, x, positions, cfg)
    return L.rmsnorm(params["final_norm.scale"], x, cfg.norm_eps)


def _logits(params, h, cfg):
    """f32 logits over the PADDED vocab (the padded rows are live weights)."""
    if cfg.tie_embeddings:
        return h.to(F32) @ params["embed"].to(F32).T
    return h.to(F32) @ params["lm_head"].to(F32)


def loss_fn(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Next-token CE over ``tokens`` (B, S), chunked over the sequence: the
    targets are shifted, the last position is masked, and the loss is the
    masked sum over ``mask.sum()``.  (The MoE aux term is 0 for dense FFNs.)"""
    h = hidden_states(params, tokens, cfg)
    B, S = tokens.shape
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = torch.cat([torch.ones(B, S - 1, dtype=F32, device=tokens.device),
                      torch.zeros(B, 1, dtype=F32, device=tokens.device)], dim=1)
    total = torch.zeros((), dtype=F32, device=tokens.device)
    for c0 in range(0, S, min(CE_CHUNK, S)):
        c1 = min(c0 + CE_CHUNK, S)
        logits = _logits(params, h[:, c0:c1], cfg)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[:, c0:c1, None])[..., 0]
        total = total + ((lse - gold) * mask[:, c0:c1]).sum()
    return total / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Serving: KV cache, prefill, one-token decode (the reference's
# transformer.init_cache / prefill / decode_step for the attn mixer)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """Zero KV cache with the reference's structure: ``{"blocks": {"p<j>":
    {"k", "v"}}, "rem": ({"k", "v"}, ...)}``, stacked leaves (n_scan_blocks,
    batch, max_len, KVH, hd), remainder leaves (batch, max_len, KVH, hd), in
    ``dtype`` (default the activation dtype)."""
    check_supported(cfg)
    dtype = dtype or cfg.act_dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)

    def entry(lead=()):
        return {name: torch.zeros(lead + shape, dtype=dtype, device=device)
                for name in ("k", "v")}

    blocks = ({f"p{j}": entry((cfg.n_scan_blocks,)) for j, _ in enumerate(cfg.pattern)}
              if cfg.n_scan_blocks > 0 else {})
    return {"blocks": blocks, "rem": tuple(entry() for _ in range(cfg.n_rem_layers))}


def _cache_entry(cache: dict, where) -> dict:
    """One layer's ``{"k", "v"}`` views into the cache."""
    kind, key, i = where
    if kind == "blocks":
        return {name: leaf[i] for name, leaf in cache["blocks"][key].items()}
    return cache["rem"][key]


def prefill(params: dict, batch: dict, cfg):
    """Forward over the prompt ``batch["tokens"]`` (B, S); returns (last
    position's f32 logits (B, padded vocab), a cache of length S holding
    every layer's keys and values)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    stacked: dict = {}
    rem = []
    for (kind, key, _), p in _layers(params, cfg):
        entry: dict = {}
        x = _apply_block(p, x, positions, cfg, kv_out=entry)
        if kind == "blocks":
            stacked.setdefault(key, []).append(entry)
        else:
            rem.append(entry)
    cache = {"blocks": {key: {name: torch.stack([e[name] for e in entries])
                              for name in ("k", "v")}
                        for key, entries in stacked.items()},
             "rem": tuple(rem)}
    h = L.rmsnorm(params["final_norm.scale"], x[:, -1:], cfg.norm_eps)
    return _logits(params, h, cfg)[:, 0], cache


def _decode_block(p, entry: dict, x, pos: int, cfg):
    """One token through one block at absolute position ``pos``: RoPE there,
    its key and value written into the cache at ``pos``, attention over
    positions ``<= pos``."""
    h = L.rmsnorm(p("ln1.scale"), x, cfg.norm_eps)
    positions = torch.arange(pos, pos + 1, device=x.device)
    q, k, v = L.attn_qkv(p("attn.wq"), p("attn.wk"), p("attn.wv"), h, positions, cfg)
    entry["k"][:, pos:pos + 1].copy_(k)
    entry["v"][:, pos:pos + 1].copy_(v)
    valid = torch.arange(entry["k"].shape[1], device=x.device) <= pos
    out = L.decode_attention(q, entry["k"], entry["v"], valid)
    x = x + L.attn_proj_out(p("attn.wo"), out)
    return _mlp_residual(p, x, cfg)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int, cfg):
    """tokens: (B,) ids; pos: the Python int position they take.  Returns
    (f32 logits (B, padded vocab), cache).  Unlike the reference, which
    returns a new cache, the keys and values are written into ``cache`` in
    place and the same dict is returned; nothing is read back to the host."""
    check_supported(cfg)
    x = _embed(params, tokens[:, None], cfg)
    for where, p in _layers(params, cfg):
        x = _decode_block(p, _cache_entry(cache, where), x, pos, cfg)
    h = L.rmsnorm(params["final_norm.scale"], x, cfg.norm_eps)
    return _logits(params, h, cfg)[:, 0], cache
