"""The reference's sequence model for the ``attn`` / ``swa`` / ``encattn`` /
``xattn`` mixers with dense or MoE FFNs: the decoder-only LM (nano, GPT-2,
the dense GQA/MQA archs, Gemma-3's sliding-window pattern, the Granite and
Llama-4 MoE archs), the encoder-decoder (Whisper's backbone: an
``encattn:dense`` encoder over frame embeddings, decoder blocks with
cross-attention) and the VLM (LLaVA's backbone: projected patches before
the text).  Parameter shapes and dtypes, init, forward over stacked blocks,
the chunked next-token cross-entropy over the text positions plus the MoE
aux loss, and serving: the KV cache (a ring of ``window`` slots for a
``swa`` layer, the encoder's keys and values for an ``xattn`` layer),
prefill and one-token decode.

Every entry point takes the reference's batch dict: ``tokens`` (B, S),
plus ``frames`` (B, enc_len, d_model) for ``encdec`` or ``patches`` (B,
n_patches, d_model) for ``vlm`` (the stubbed front ends' embeddings).

Parameters are a flat dict ``{path: tensor}`` keyed by the reference's
pytree paths (``"decoder.blocks.p0.attn.wq"``); stacked blocks keep their
leading layer axis and may also be given as a list of per-layer tensors.
``repro_torch.models.convert`` lays them out in flat buffers, one per
dtype group: the MoE router is f32 whatever the param dtype, as in the
reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.convert import FlatLayout

F32 = torch.float32
MOE_AUX_COEF = 0.01
CE_CHUNK = 2048
FAMILIES, FFNS = ("lm", "vlm", "encdec"), ("dense", "moe")
MIXERS = ("attn", "swa", "xattn")    # a decoder block's; xattn in encdec only
ENC_PATTERN = ("encattn:dense",)     # the encoder's blocks (reference transformer.py:95)


def _parse_kind(kind: str) -> tuple[str, str]:
    mixer, _, ffn = kind.partition(":")
    return mixer, ffn or "dense"


def check_supported(cfg) -> None:
    mixers = MIXERS if cfg.family == "encdec" else MIXERS[:2]
    bad = [k for k in cfg.pattern
           if _parse_kind(k)[0] not in mixers or _parse_kind(k)[1] not in FFNS]
    if cfg.family not in FAMILIES or bad:
        raise NotImplementedError(
            f"{cfg.name}: the port runs families {FAMILIES} with decoder mixers {MIXERS} "
            f"(xattn in encdec only; the encoder's encattn) and FFNs {FFNS}; family "
            f"{cfg.family!r} / block kinds {bad} are not ported yet (ROADMAP.md)")


# ---------------------------------------------------------------------------
# Parameter tree: shapes, init distributions and dtypes, nested as the
# reference's
# ---------------------------------------------------------------------------

def _dense(shape: tuple, dtype, std=None) -> tuple:
    """A leaf ``(shape, std, dtype)``: std 1/sqrt(fan_in), fan_in = shape[-2]
    (the reference's ``_init_dense``) unless given."""
    return (shape, std if std is not None else 1.0 / math.sqrt(shape[-2]), dtype)


def _mlp_spec(cfg, lead: tuple, d_ff: int) -> dict:
    d, pd = cfg.d_model, cfg.p_dtype
    s = {"w1": _dense(lead + (d, d_ff), pd), "w2": _dense(lead + (d_ff, d), pd)}
    if cfg.mlp_gated:
        s["w3"] = _dense(lead + (d, d_ff), pd)
    return s


def _moe_spec(cfg, lead: tuple) -> dict:
    d, dff, E, pd = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.p_dtype
    s = {"router": _dense(lead + (d, E), F32, std=0.02),
         "we1": _dense(lead + (E, d, dff), pd), "we2": _dense(lead + (E, dff, d), pd)}
    if cfg.mlp_gated:
        s["we3"] = _dense(lead + (E, d, dff), pd)
    if cfg.n_shared_experts:
        s["shared"] = _mlp_spec(cfg, lead, cfg.d_ff * cfg.n_shared_experts)
    return s


def _attn_spec(cfg, lead: tuple) -> dict:
    d, h, kvh, hd, pd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.p_dtype
    return {"wq": _dense(lead + (d, h * hd), pd), "wk": _dense(lead + (d, kvh * hd), pd),
            "wv": _dense(lead + (d, kvh * hd), pd), "wo": _dense(lead + (h * hd, d), pd)}


def _norm_spec(cfg, lead: tuple) -> dict:
    return {"scale": (lead + (cfg.d_model,), "ones", cfg.p_dtype)}


def _block_spec(cfg, kind: str, lead: tuple) -> dict:
    """One block's leaves as (shape, init, dtype) with init "ones" or a normal
    std; an ``xattn`` block adds its cross-attention ``xattn`` and norm
    ``lnx``."""
    mixer, ffn = _parse_kind(kind)
    s = {"ln1": _norm_spec(cfg, lead), "attn": _attn_spec(cfg, lead),
         "ln2": _norm_spec(cfg, lead)}
    if mixer == "xattn":
        s["xattn"] = _attn_spec(cfg, lead)
        s["lnx"] = _norm_spec(cfg, lead)
    if ffn == "moe":
        s["moe"] = _moe_spec(cfg, lead)
    else:
        s["mlp"] = _mlp_spec(cfg, lead, cfg.d_ff)
    return s


def _stack_spec(cfg, pattern: tuple, n_blocks: int, n_rem: int) -> dict:
    """Stacked blocks of the pattern's full repeats, then the remainder."""
    blocks = ({f"p{j}": _block_spec(cfg, kind, (n_blocks,)) for j, kind in enumerate(pattern)}
              if n_blocks > 0 else {})
    return {"blocks": blocks, "rem": tuple(_block_spec(cfg, pattern[i], ())
                                           for i in range(n_rem))}


def param_spec(cfg) -> dict:
    """Nested ``{key: (shape, init, dtype)}`` tree with the reference's
    structure (``transformer.init_params``): an ``encdec`` model adds the
    ``encoder`` stack and ``enc_norm``, a ``vlm`` one ``patch_proj``."""
    check_supported(cfg)
    spec = {
        "embed": ((cfg.padded_vocab, cfg.d_model), 0.02, cfg.p_dtype),
        "final_norm": _norm_spec(cfg, ()),
        "decoder": _stack_spec(cfg, cfg.pattern, cfg.n_scan_blocks, cfg.n_rem_layers),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((cfg.d_model, cfg.padded_vocab), 0.02, cfg.p_dtype)
    if cfg.family == "encdec":
        spec["encoder"] = _stack_spec(cfg, ENC_PATTERN, cfg.enc_layers, 0)
        spec["enc_norm"] = _norm_spec(cfg, ())
    if cfg.family == "vlm":
        spec["patch_proj"] = _dense((cfg.d_model, cfg.d_model), cfg.p_dtype)
    return spec


def layout(cfg) -> FlatLayout:
    """The flat layout: the ``cfg.p_dtype`` group first, then f32 (the MoE
    routers of a bf16 model); one group when every leaf shares a dtype."""
    return FlatLayout.from_tree(param_spec(cfg), is_leaf=_is_spec_leaf,
                                dtype_of=lambda leaf: leaf[2], first=cfg.p_dtype)


def _is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple)


def init_params(gen: torch.Generator, cfg, device=None):
    """Flat ``(N,)`` buffers on ``device``, each leaf in its reference dtype
    (one tensor, or the :class:`~repro_torch.groups.Groups` of a
    mixed-dtype model): normal draws (std 1/sqrt(fan_in), 0.02 for the
    embedding and the router) from ``gen``, ones for the norm scales — the
    reference's distributions, not its random numbers."""
    lay = layout(cfg)
    flat = lay.empty(device=device)
    views = lay.views(flat)
    for name, (shape, init, _) in zip(lay.names, lay.leaves):
        if init == "ones":
            views[name].fill_(1.0)
        else:
            w = torch.randn(shape, generator=gen, dtype=F32, device=gen.device) * init
            views[name].copy_(w)
    return flat


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(p, kind: str, x, positions, cfg, enc_out=None, kv_out=None):
    """One block of ``kind``; ``p(name)`` returns the block's leaf.  Returns
    (x, the MoE aux loss or None).  ``encattn`` attends bidirectionally;
    ``xattn`` attends causally, then its queries attend over ``enc_out``
    (B, enc_len, d), the encoder's output.  With a dict ``kv_out`` the
    block's keys (after RoPE) and values land in it as ``k`` / ``v`` (B,
    S', KVH, hd), the prefill's cache entry: every position, or a ``swa``
    layer's last ``min(window, S)``; an ``xattn`` block adds the
    cross-attention's ``kx`` / ``vx`` (B, enc_len, KVH, hd)."""
    mixer, ffn = _parse_kind(kind)
    window = cfg.window if mixer == "swa" else None
    h = L.rmsnorm(p("ln1.scale"), x, cfg.norm_eps)
    q, k, v = L.attn_qkv(p("attn.wq"), p("attn.wk"), p("attn.wv"), h, positions, cfg)
    if kv_out is not None:
        w = k.shape[1] if window is None else min(window, k.shape[1])
        kv_out.update(k=k[:, -w:], v=v[:, -w:])
    if mixer == "encattn":
        out = L.full_attention(q, k, v)
    else:
        out = L.causal_attention(q, k, v, window=window, q_block=cfg.q_block)
    x = x + L.attn_proj_out(p("attn.wo"), out)
    if mixer == "xattn":
        kx, vx = _cross_kv(p, enc_out, cfg)
        if kv_out is not None:
            kv_out.update(kx=kx, vx=vx)
        x = _cross_residual(p, x, kx, vx, cfg)
    return _ffn_residual(p, ffn, x, cfg)


def _cross_kv(p, enc_out, cfg) -> tuple:
    """The cross-attention's keys and values of the encoder output, without
    RoPE: (B, enc_len, KVH, hd) each."""
    B, Se, _ = enc_out.shape
    kx = (enc_out @ p("xattn.wk").to(enc_out.dtype)).reshape(B, Se, cfg.n_kv_heads, cfg.hd)
    vx = (enc_out @ p("xattn.wv").to(enc_out.dtype)).reshape(B, Se, cfg.n_kv_heads, cfg.hd)
    return kx, vx


def _cross_residual(p, x, kx, vx, cfg):
    """x + the cross-attention of ``lnx(x)``'s queries over every encoder
    position's ``kx`` / ``vx``.  Decode calls it on one query row: the
    reference masks that call with an all-true mask, which hides nothing,
    so no mask is built."""
    hx = L.rmsnorm(p("lnx.scale"), x, cfg.norm_eps)
    B, S, _ = hx.shape
    qx = (hx @ p("xattn.wq").to(hx.dtype)).reshape(B, S, cfg.n_heads, cfg.hd)
    return x + L.attn_proj_out(p("xattn.wo"), L.full_attention(qx, kx, vx))


def _moe_params(p, cfg) -> dict:
    """A block's MoE leaves in ``layers.moe_apply``'s form."""
    names = ("router", "we1", "we2") + (("we3",) if cfg.mlp_gated else ())
    out = {n: p(f"moe.{n}") for n in names}
    if cfg.n_shared_experts:
        out["shared"] = {n: p(f"moe.shared.{n}")
                         for n in ("w1", "w2") + (("w3",) if cfg.mlp_gated else ())}
    return out


def _ffn_residual(p, ffn: str, x, cfg):
    """x + the block's FFN of its second norm; returns (x, aux or None)."""
    h = L.rmsnorm(p("ln2.scale"), x, cfg.norm_eps)
    if ffn == "moe":
        out, aux = L.moe_apply(_moe_params(p, cfg), h, cfg)
        return x + out, aux
    w3 = p("mlp.w3") if cfg.mlp_gated else None
    return x + L.mlp_apply(p("mlp.w1"), p("mlp.w2"), h, cfg, w3=w3), None


def _layers(params: dict, cfg, stack: str = "decoder"):
    """``(where, kind, p)`` of every layer of the ``decoder`` (or
    ``encoder``) stack in order: ``where`` is ``("blocks", "p<j>", i)`` for
    layer i of the stacked pattern position j (kind ``pattern[j]``) or
    ``("rem", i, None)`` for a remainder layer (kind ``pattern[i]``);
    ``p(name)`` returns that layer's leaf."""
    pattern, n_blocks, n_rem = ((ENC_PATTERN, cfg.enc_layers, 0) if stack == "encoder" else
                                (cfg.pattern, cfg.n_scan_blocks, cfg.n_rem_layers))
    for i in range(n_blocks):
        for j, kind in enumerate(pattern):
            pre = f"{stack}.blocks.p{j}."
            yield ("blocks", f"p{j}", i), kind, (lambda n, pre=pre, i=i: params[pre + n][i])
    for i in range(n_rem):
        pre = f"{stack}.rem.{i}."
        yield ("rem", i, None), pattern[i], (lambda n, pre=pre: params[pre + n])


def _embed(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Embedding rows cast to the activation dtype, scaled by sqrt(d_model)."""
    return params["embed"][tokens].to(cfg.act_dtype) * math.sqrt(cfg.d_model)


def _add_aux(total, aux):
    if aux is None:
        return total
    return aux if total is None else total + aux


def _encode(params: dict, frames: torch.Tensor, cfg) -> torch.Tensor:
    """The encoder over the (stub) frame embeddings (B, enc_len, d): cast to
    the activation dtype, the ``encattn`` blocks with RoPE at
    ``arange(enc_len)``, ``enc_norm``."""
    x = frames.to(cfg.act_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for _, kind, p in _layers(params, cfg, "encoder"):
        x, _ = _apply_block(p, kind, x, positions, cfg)
    return L.rmsnorm(params["enc_norm.scale"], x, cfg.norm_eps)


def _inputs(params: dict, batch: dict, cfg) -> tuple:
    """(the decoder's input (B, n_prefix + S, d), the encoder output or
    None, n_prefix): the text embedding, after the projected patches of a
    ``vlm`` batch (``n_prefix`` of them); an ``encdec`` batch's frames
    through the encoder."""
    x = _embed(params, batch["tokens"], cfg)
    enc_out, n_prefix = None, 0
    if cfg.family == "encdec":
        enc_out = _encode(params, batch["frames"], cfg)
    elif cfg.family == "vlm":
        patches = batch["patches"].to(cfg.act_dtype) @ params["patch_proj"].to(cfg.act_dtype)
        x = torch.cat([patches, x], dim=1)
        n_prefix = patches.shape[1]
    return x, enc_out, n_prefix


def _forward(params: dict, batch: dict, cfg):
    """(final hidden states, the MoE aux loss summed over layers or None,
    n_prefix)."""
    x, enc_out, n_prefix = _inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = None
    for _, kind, p in _layers(params, cfg):
        x, a = _apply_block(p, kind, x, positions, cfg, enc_out)
        aux = _add_aux(aux, a)
    return L.rmsnorm(params["final_norm.scale"], x, cfg.norm_eps), aux, n_prefix


def hidden_states(params: dict, batch: dict, cfg) -> tuple:
    """The full forward to the final hidden states; returns (h (B,
    n_prefix + S, d), the f32 MoE aux loss (0 without a MoE layer),
    n_prefix: the non-text positions, a ``vlm`` batch's patches, that the
    loss leaves out)."""
    h, aux, n_prefix = _forward(params, batch, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=F32, device=h.device)
    return h, aux, n_prefix


def _logits(params, h, cfg):
    """f32 logits over the PADDED vocab (the padded rows are live weights)."""
    if cfg.tie_embeddings:
        return h.to(F32) @ params["embed"].to(F32).T
    return h.to(F32) @ params["lm_head"].to(F32)


def loss_fn(params: dict, batch: dict, cfg) -> torch.Tensor:
    """Next-token CE over ``batch["tokens"]`` (B, S) at the text positions
    (``h[:, n_prefix:]``), chunked over the sequence: the targets are
    shifted, the last position is masked, and the loss is the masked sum
    over ``mask.sum()``, plus ``MOE_AUX_COEF`` times the aux loss summed
    over the MoE layers (a model without one adds nothing)."""
    h, aux, n_prefix = _forward(params, batch, cfg)
    h = h[:, n_prefix:]
    tokens = batch["tokens"]
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
    loss = total / torch.clamp(mask.sum(), min=1.0)
    return loss if aux is None else loss + MOE_AUX_COEF * aux


# ---------------------------------------------------------------------------
# Serving: KV cache, prefill, one-token decode (the reference's
# transformer.init_cache / prefill / decode_step for the attn, swa and xattn
# mixers)
# ---------------------------------------------------------------------------

def _cache_len(kind: str, cfg, max_len: int) -> int:
    """A layer's cache slots: ``max_len``, or a ring of ``min(window,
    max_len)`` for ``swa``."""
    return min(cfg.window, max_len) if _parse_kind(kind)[0] == "swa" else max_len


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """Zero KV cache with the reference's structure: ``{"blocks": {"p<j>":
    {"k", "v"}}, "rem": ({"k", "v"}, ...)}``, stacked leaves (n_scan_blocks,
    batch, L, KVH, hd), remainder leaves (batch, L, KVH, hd), with L =
    ``max_len`` or a ``swa`` layer's ``min(window, max_len)``, in ``dtype``
    (default the activation dtype).  An ``xattn`` layer's entry adds the
    encoder's keys and values ``kx`` / ``vx`` (..., batch, enc_len, KVH,
    hd)."""
    check_supported(cfg)
    dtype = dtype or cfg.act_dtype

    def entry(kind, lead=()):
        n = _cache_len(kind, cfg, max_len)
        lens = {"k": n, "v": n}
        if _parse_kind(kind)[0] == "xattn":
            lens.update(kx=cfg.enc_len, vx=cfg.enc_len)
        return {name: torch.zeros(lead + (batch, n, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                                  device=device)
                for name, n in lens.items()}

    blocks = ({f"p{j}": entry(kind, (cfg.n_scan_blocks,)) for j, kind in enumerate(cfg.pattern)}
              if cfg.n_scan_blocks > 0 else {})
    return {"blocks": blocks,
            "rem": tuple(entry(cfg.pattern[i]) for i in range(cfg.n_rem_layers))}


def _cache_entry(cache: dict, where) -> dict:
    """One layer's ``{"k", "v"[, "kx", "vx"]}`` views into the cache."""
    kind, key, i = where
    if kind == "blocks":
        return {name: leaf[i] for name, leaf in cache["blocks"][key].items()}
    return cache["rem"][key]


def prefill(params: dict, batch: dict, cfg):
    """Forward over the prompt: ``batch["tokens"]`` (B, S) after a ``vlm``
    batch's ``patches``, beside an ``encdec`` batch's ``frames``.  Returns
    (last position's f32 logits (B, padded vocab), a cache holding every
    layer's keys and values: all n_prefix + S positions, a ``swa`` layer's
    last ``min(window, n_prefix + S)`` in position order, an ``xattn``
    layer's ``kx`` / ``vx`` of the encoder output, collected once)."""
    check_supported(cfg)
    x, enc_out, _ = _inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    stacked: dict = {}
    rem = []
    for (where, key, _), kind, p in _layers(params, cfg):
        entry: dict = {}
        x, _ = _apply_block(p, kind, x, positions, cfg, enc_out, kv_out=entry)
        if where == "blocks":
            stacked.setdefault(key, []).append(entry)
        else:
            rem.append(entry)
    cache = {"blocks": {key: {name: torch.stack([e[name] for e in entries])
                              for name in entries[0]}
                        for key, entries in stacked.items()},
             "rem": tuple(rem)}
    h = L.rmsnorm(params["final_norm.scale"], x[:, -1:], cfg.norm_eps)
    return _logits(params, h, cfg)[:, 0], cache


def _decode_block(p, kind: str, entry: dict, x, pos: int, cfg):
    """One token through one block at absolute position ``pos``: RoPE there,
    its key and value written into the cache, attention over the positions
    it sees.  A full-attention layer writes slot ``pos`` and sees slots
    ``<= pos``; a ``swa`` layer's ring of w slots holds position p at slot
    ``p % w``, and slot i holds the latest position ``i + w * floor((pos -
    i) / w)``, valid when that is ``>= 0`` (the reference's mask).  An
    ``xattn`` layer then attends over its cached ``kx`` / ``vx``."""
    mixer, ffn = _parse_kind(kind)
    h = L.rmsnorm(p("ln1.scale"), x, cfg.norm_eps)
    positions = torch.arange(pos, pos + 1, device=x.device)
    q, k, v = L.attn_qkv(p("attn.wq"), p("attn.wk"), p("attn.wv"), h, positions, cfg)
    n_slots = entry["k"].shape[1]
    idx = torch.arange(n_slots, device=x.device)
    if mixer == "swa":
        slot = pos % n_slots
        valid = idx + n_slots * torch.div(pos - idx, n_slots, rounding_mode="floor") >= 0
    else:
        slot = pos
        valid = idx <= pos
    entry["k"][:, slot:slot + 1].copy_(k)
    entry["v"][:, slot:slot + 1].copy_(v)
    out = L.decode_attention(q, entry["k"], entry["v"], valid)
    x = x + L.attn_proj_out(p("attn.wo"), out)
    if mixer == "xattn":
        x = _cross_residual(p, x, entry["kx"], entry["vx"], cfg)
    return _ffn_residual(p, ffn, x, cfg)[0]


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int, cfg):
    """tokens: (B,) ids; pos: the Python int position they take.  Returns
    (f32 logits (B, padded vocab), cache).  Unlike the reference, which
    returns a new cache, the keys and values are written into ``cache`` in
    place and the same dict is returned; nothing is read back to the host
    but a MoE layer's group sizes (``layers.moe_apply``)."""
    check_supported(cfg)
    x = _embed(params, tokens[:, None], cfg)
    for where, kind, p in _layers(params, cfg):
        x = _decode_block(p, kind, _cache_entry(cache, where), x, pos, cfg)
    h = L.rmsnorm(params["final_norm.scale"], x, cfg.norm_eps)
    return _logits(params, h, cfg)[:, 0], cache
