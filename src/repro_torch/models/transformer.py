"""The reference's sequence model for every mixer it builds, ``attn`` /
``swa`` / ``encattn`` / ``xattn`` and the recurrent ``ssm`` (Mamba-2 SSD)
and ``rglru`` (RG-LRU), with dense, MoE or no FFNs: the decoder-only LM
(nano, GPT-2, the dense GQA/MQA archs, Gemma-3's sliding-window pattern,
the Granite and Llama-4 MoE archs, Mamba-2, RecurrentGemma's two RG-LRU
layers per local-attention layer), the encoder-decoder (Whisper's
backbone: an ``encattn:dense`` encoder over frame embeddings, decoder
blocks with cross-attention) and the VLM (LLaVA's backbone: projected
patches before the text).  Parameter shapes and dtypes, init, forward over
stacked blocks, the chunked next-token cross-entropy over the text
positions plus the MoE aux loss, and serving: the cache (keys and values; a
ring of ``window`` slots for a ``swa`` layer; the encoder's keys and values
for an ``xattn`` layer; the recurrent state and the conv's last inputs for
an ``ssm`` or ``rglru`` layer), prefill and one-token decode.

Every entry point takes the reference's batch dict: ``tokens`` (B, S),
plus ``frames`` (B, enc_len, d_model) for ``encdec`` or ``patches`` (B,
n_patches, d_model) for ``vlm`` (the stubbed front ends' embeddings).

Parameters are a flat dict ``{path: tensor}`` keyed by the reference's
pytree paths (``"decoder.blocks.p0.attn.wq"``); stacked blocks keep their
leading layer axis and may also be given as a list of per-layer tensors.
``repro_torch.models.convert`` lays them out in flat buffers, one per
dtype group: the MoE router and the recurrences' ``lam``, ``A_log``,
``D`` and ``dt_bias`` are f32 whatever the param dtype, as in the
reference.

On a rank of a model-parallel group (``repro_torch.distributed.mesh``,
``model`` > 1) the params are its :class:`~repro_torch.models.convert.
ShardedParams`: each leaf its block by the reference's placement on the
``model`` axis.  ``hidden_states`` and ``loss_fn`` then compute every
family Megatron-split (:func:`_tp_block`): ``wq`` / ``wo`` over whole heads
(the encoder's ``encattn`` bidirectional, an ``xattn`` block's
cross-attention over the encoder output too), ``w1`` / ``w3`` column- and
``w2`` row-parallel with one all-reduce after each row-parallel product, a
MoE FFN's router by experts or by rows and its experts' and shared experts'
d_ff slices (:func:`_tp_moe`), Mamba-2's SSD by heads and the RG-LRU by
channels (:func:`_tp_recurrent`), a VLM's ``patch_proj`` column-parallel
(:func:`_patch_prefix`), ``embed`` / ``lm_head`` vocab-parallel into the
vocab-parallel cross-entropy (``repro_torch.distributed.tensor_parallel``).
A leaf whose block the split does not consume (the norm scales; ``wk`` /
``wv`` where a rank's block cuts a head; Mamba-2's ``in_proj`` and
``conv``, whose blocks cut its z / x / B / C / dt segments; the experts
where their blocks do not cut d_ff; a mixer's leaves where its heads or
channels do not divide over the group) is gathered over the model group at
use, layer by layer, and its gradient cut back.  An ``encdec`` batch's
``frames`` are whole on every rank (the reference's ``train_batch_pspecs``
cuts their feature dim over ``model``); the encoder's output is the same
on every rank.

Serving on a rank of the ``(data, model)`` grid takes the same
``ShardedParams`` and the rank's batch rows.  ``prefill`` and
``decode_step`` run :func:`_tp_block` / :func:`_tp_decode_block`: the
rank's cache holds the KV heads its query heads read (:func:`_kv_heads`;
an ``xattn`` layer's ``kx`` / ``vx`` too), an ``ssm`` layer's state of its
heads and conv tail of its channels, an ``rglru`` layer's of its channels,
and the logits are its vocab block, the reference's ``P("data", "model")``
(:func:`logits_split`).  :func:`serving_params` resolves a rank's params
once (``generate`` calls it once per call).  ``init_cache(...,
layout=)`` gives a rank's cache.

Under FSDP (the layout's ``zero_axis``: a training rank's zero group, a
serving rank's data group) each leaf that the placement cuts over
``zero`` / ``data`` is the rank's zero block of its model block, and
:func:`_zblock` gathers it to the model block where it is used: a layer's
leaves inside the layer (``_Leaves``, so inside the checkpointed body, and
again in its recompute under remat), ``embed`` at the lookup and at a tied
head, the head once per ``loss_fn`` call, ``final_norm`` and ``enc_norm``
once; the code downstream then computes on the model block as above.  Its
backward (``ShardedParams.zero_mode``) reduce-scatters the gradient where
the zero ranks compute their own rows of the microbatch (``"sum"``; a leaf
held whole over zero has its gradient all-reduced) and keeps the rank's
slice where each computes the whole microbatch (``"slice"``).  Without
remat a gathered weight is saved for its product's backward, so the
gathered model blocks of every layer live until the backward passes them.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.distributed import comm
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models.convert import FlatLayout, ShardedParams

F32 = torch.float32
MOE_AUX_COEF = 0.01
CE_CHUNK = 2048
FAMILIES, FFNS = ("lm", "vlm", "encdec"), ("dense", "moe", "none")
MIXERS = ("attn", "swa", "xattn", "ssm", "rglru")   # a decoder block's; xattn in encdec only
RECURRENT = ("ssm", "rglru")
ENC_PATTERN = ("encattn:dense",)     # the encoder's blocks (reference transformer.py:95)


def _parse_kind(kind: str) -> tuple[str, str]:
    mixer, _, ffn = kind.partition(":")
    return mixer, ffn or "dense"


def check_supported(cfg) -> None:
    """An unknown family, mixer or FFN raises ``ValueError``, as the
    reference's ``_init_block`` does for a mixer or FFN.  An ``xattn`` block
    outside an ``encdec`` model has no encoder to attend to: the reference
    fails there in its forward; the port refuses it."""
    unknown = [k for k in cfg.pattern
               if _parse_kind(k)[0] not in MIXERS or _parse_kind(k)[1] not in FFNS]
    if cfg.family not in FAMILIES or unknown:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} or block kinds "
                         f"{unknown}; the reference builds families {FAMILIES} with "
                         f"mixers {MIXERS} and FFNs {FFNS}")
    if cfg.family != "encdec" and any(_parse_kind(k)[0] == "xattn" for k in cfg.pattern):
        raise NotImplementedError(
            f"{cfg.name}: an xattn block needs the encdec family's encoder; a "
            f"{cfg.family!r} model with one is not built (ROADMAP.md)")


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


def _mamba2_spec(cfg, lead: tuple) -> dict:
    """The reference's ``layers.init_mamba2`` leaves: the in-projection to
    [z, x, B, C, dt], the conv over the (x, B, C) streams, the f32 decay
    ``A_log`` = log(linspace(1, 16, H)), skip ``D`` = 1 and ``dt_bias`` =
    0, the gated norm and the out-projection."""
    d, di, N, H, pd = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.p_dtype
    return {"in_proj": _dense(lead + (d, 2 * di + 2 * N + H), pd),
            "conv": _conv_spec(cfg, lead, di + 2 * N),
            "A_log": (lead + (H,), "a_log", F32), "D": (lead + (H,), "ones", F32),
            "dt_bias": (lead + (H,), "zeros", F32),
            "norm": {"scale": (lead + (di,), "ones", pd)},
            "out_proj": _dense(lead + (di, d), pd)}


def _rglru_spec(cfg, lead: tuple) -> dict:
    """The reference's ``layers.init_rglru`` leaves: the input and gate
    projections, the conv, the recurrence and input gates ``w_a`` /
    ``w_x``, the f32 ``lam`` = 2.2 and the out-projection."""
    d, dr, pd = cfg.d_model, cfg.d_rnn, cfg.p_dtype
    return {"in_x": _dense(lead + (d, dr), pd), "in_gate": _dense(lead + (d, dr), pd),
            "conv": _conv_spec(cfg, lead, dr), "w_a": _dense(lead + (dr, dr), pd),
            "w_x": _dense(lead + (dr, dr), pd), "lam": (lead + (dr,), "lam", F32),
            "out": _dense(lead + (dr, d), pd)}


def _conv_spec(cfg, lead: tuple, channels: int) -> dict:
    """``layers.init_conv1d``: ``w`` (width, channels) with std
    1/sqrt(width) (the reference's explicit scale), ``b`` zeros."""
    w = cfg.conv_width
    return {"w": _dense(lead + (w, channels), cfg.p_dtype, std=1.0 / math.sqrt(w)),
            "b": (lead + (channels,), "zeros", cfg.p_dtype)}


def _block_spec(cfg, kind: str, lead: tuple) -> dict:
    """One block's leaves as (shape, init, dtype) with init a normal std or
    one of the deterministic fills of ``FILLS``: the first norm ``ln1``, the
    mixer's leaves under ``attn`` (an ``xattn`` block adds its
    cross-attention ``xattn`` and norm ``lnx``), ``ssm`` or ``rglru``, then
    the FFN's ``ln2`` and ``mlp`` or ``moe`` (nothing for ``none``)."""
    mixer, ffn = _parse_kind(kind)
    s = {"ln1": _norm_spec(cfg, lead)}
    if mixer == "ssm":
        s["ssm"] = _mamba2_spec(cfg, lead)
    elif mixer == "rglru":
        s["rglru"] = _rglru_spec(cfg, lead)
    else:
        s["attn"] = _attn_spec(cfg, lead)
    if mixer == "xattn":
        s["xattn"] = _attn_spec(cfg, lead)
        s["lnx"] = _norm_spec(cfg, lead)
    if ffn != "none":
        s["ln2"] = _norm_spec(cfg, lead)
    if ffn == "moe":
        s["moe"] = _moe_spec(cfg, lead)
    elif ffn == "dense":
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
    """The flat layout: the ``cfg.p_dtype`` group first, then f32 (a bf16
    model's MoE routers, ``lam``, ``A_log``, ``D`` and ``dt_bias``); one
    group when every leaf shares a dtype."""
    return FlatLayout.from_tree(param_spec(cfg), is_leaf=_is_spec_leaf,
                                dtype_of=lambda leaf: leaf[2], first=cfg.p_dtype)


def _is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple)


# the deterministic inits (f32 values of a leaf's shape): the last axis of
# a stacked leaf is the layer's
FILLS = {
    "ones": torch.ones,
    "zeros": torch.zeros,
    "lam": lambda shape: torch.full(shape, 2.2),
    "a_log": lambda shape: torch.log(torch.linspace(1.0, 16.0, shape[-1])).expand(shape),
}


def init_params(gen: torch.Generator, cfg, device=None):
    """Flat ``(N,)`` buffers on ``device``, each leaf in its reference dtype
    (one tensor, or the :class:`~repro_torch.groups.Groups` of a
    mixed-dtype model): normal draws (std 1/sqrt(fan_in), 0.02 for the
    embedding and the router, 1/sqrt(width) for a conv) from ``gen``, and
    the reference's fixed values (``FILLS``) for the norm scales, the conv
    biases and the recurrences' ``A_log``, ``D``, ``dt_bias`` and ``lam`` —
    the reference's distributions, not its random numbers."""
    lay = layout(cfg)
    flat = lay.empty(device=device)
    views = lay.views(flat)
    for name, (shape, init, _) in zip(lay.names, lay.leaves):
        if isinstance(init, str):
            views[name].copy_(FILLS[init](shape))
        else:
            w = torch.randn(shape, generator=gen, dtype=F32, device=gen.device) * init
            views[name].copy_(w)
    return flat


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(p, kind: str, x, positions, cfg, enc_out=None, kv_out=None, seq=None,
                 sp=None):
    """One block of ``kind``; ``p(name)`` returns the block's leaf.  Returns
    (x, the MoE aux loss or None).  ``encattn`` attends bidirectionally;
    ``xattn`` attends causally, then its queries attend over ``enc_out``
    (B, enc_len, d), the encoder's output; ``ssm`` and ``rglru`` run their
    recurrences over the sequence.  With a dict ``kv_out`` the block's cache
    entry from the prefill lands in it: the keys (after RoPE) and values as
    ``k`` / ``v`` (B, S', KVH, hd), every position or a ``swa`` layer's last
    ``min(window, S)``; an ``xattn`` block adds the cross-attention's ``kx``
    / ``vx`` (B, enc_len, KVH, hd); a recurrent block its state after the
    last position (``layers.mamba2_apply`` / ``rglru_apply``).  ``seq``: x
    is a serving rank's chunk of the decoder sequence over its data group
    (``tensor_parallel.SeqSplit``; ``positions`` its positions):
    :func:`_self_attend`, and the recurrences carried across the chunks.
    ``sp``: x is a model-parallel rank's block of the sequence
    (:func:`_tp_block`)."""
    if _model_split(p.params):
        return _tp_block(p, kind, x, positions, cfg, enc_out, kv_out, seq, sp)
    mixer, ffn = _parse_kind(kind)
    h = L.rmsnorm(p("ln1.scale"), x, cfg.norm_eps)
    if mixer in RECURRENT:
        apply = L.mamba2_apply if mixer == "ssm" else L.rglru_apply
        x = x + apply(_mixer_params(p, mixer, cfg), h, cfg, state_out=kv_out, seq=seq)
        return _ffn_residual(p, ffn, x, cfg)
    q, k, v = L.attn_qkv(p("attn.wq"), p("attn.wk"), p("attn.wv"), h, positions, cfg)
    x = x + L.attn_proj_out(p("attn.wo"), _self_attend(q, k, v, mixer, cfg, kv_out, seq))
    if mixer == "xattn":
        kx, vx = _cross_kv(p, enc_out, cfg)
        if kv_out is not None:
            kv_out.update(kx=kx, vx=vx)
        x = _cross_residual(p, x, kx, vx, cfg)
    return _ffn_residual(p, ffn, x, cfg)


def _self_attend(q, k, v, mixer: str, cfg, kv_out=None, seq=None, sp=None):
    """A block's self-attention of q over k / v (B, S, heads, hd): causal
    (``swa``: over its window) or, for ``encattn``, over every position.
    With a dict ``kv_out`` the keys and values of every position (a
    ``swa`` layer's last ``min(window, S)``) land in it, the block's cache
    entry.  ``seq``: q, k and v are a serving rank's chunk of a sequence
    over its data group (``tensor_parallel.SeqSplit``): every rank's keys
    and values are all-gathered over it (one call of both, the rank's KV
    heads), and the queries attend from their offset over the positions
    up to the chunk's end (the window holds across the chunk's edge).
    ``sp``: the same over a model-parallel rank's block of the sequence
    (whole heads), with autograd: the keys and values gathered over the
    model group, their gradient reduce-scattered.  With both, q is the
    rank's block of its data rank's chunk: the keys and values are gathered
    over the model group (the chunk's), then over the data group, and the
    queries attend from the block's offset in the sequence, tiled as the
    chunk's queries are (``layers.causal_attention``'s ``span``), so each
    row is the one the grid computes without ``sp``, bit for bit."""
    window = cfg.window if mixer == "swa" else None
    start = 0
    if sp is not None:
        k, v = TP.gather(torch.stack([k, v]), sp.axis, 2, "sum").unbind(0)
        start = sp.start
    if seq is not None:
        k, v = comm.all_gather_dim(torch.stack([k, v]), seq.axis, 2).unbind(0)
        start += seq.start
    if kv_out is not None:
        w = k.shape[1] if window is None else min(window, k.shape[1])
        kv_out.update(k=k[:, -w:], v=v[:, -w:])
    if mixer == "encattn":
        return L.full_attention(q, k, v)
    if seq is None and sp is None:
        return L.causal_attention(q, k, v, window=window, q_block=cfg.q_block)
    span = (seq.start, seq.n) if seq is not None and sp is not None else None
    stop = seq.stop if span else start + q.shape[1]
    return L.causal_attention(q, k[:, :stop], v[:, :stop], window, cfg.q_block,
                              q_start=start, span=span)


def _mixer_params(p, mixer: str, cfg) -> dict:
    """A recurrent block's ``ssm`` / ``rglru`` leaves nested as the
    reference's tree (``{"conv": {"w", "b"}, ...}``: the mixer's spec, one
    level deep), the form of ``layers.mamba2_apply`` / ``rglru_apply``;
    ``p(name)`` takes each leaf (a layer's :class:`_Leaves`, or its
    ``full``: gathered)."""
    spec = (_mamba2_spec if mixer == "ssm" else _rglru_spec)(cfg, ())
    return {k: {n: p(f"{mixer}.{k}.{n}") for n in v} if isinstance(v, dict)
            else p(f"{mixer}.{k}") for k, v in spec.items()}


def _cross_kv(p, enc_out, cfg, kv=None) -> tuple:
    """The cross-attention's keys and values of the encoder output, without
    RoPE: (B, enc_len, KVH, hd) each; ``kv``: a model-parallel rank's
    (``wk``, ``wv``, KV heads) (:func:`_kv_weights`)."""
    wk, wv, nkv = kv or (p("xattn.wk"), p("xattn.wv"), cfg.n_kv_heads)
    B, Se, _ = enc_out.shape
    kx = (enc_out @ wk.to(enc_out.dtype)).reshape(B, Se, nkv, cfg.hd)
    vx = (enc_out @ wv.to(enc_out.dtype)).reshape(B, Se, nkv, cfg.hd)
    return kx, vx


def _cross_residual(p, x, kx, vx, cfg):
    """x + the cross-attention of ``lnx(x)``'s queries over every encoder
    position's ``kx`` / ``vx``.  Decode calls it on one query row: the
    reference masks that call with an all-true mask, which hides nothing,
    so no mask is built.  ``p(name)`` takes each leaf (a layer's
    :class:`_Leaves`, or its ``full``: gathered)."""
    hx = L.rmsnorm(p("lnx.scale"), x, cfg.norm_eps)
    B, S, _ = hx.shape
    qx = (hx @ p("xattn.wq").to(hx.dtype)).reshape(B, S, cfg.n_heads, cfg.hd)
    return x + L.attn_proj_out(p("xattn.wo"), L.full_attention(qx, kx, vx))


def _moe_params(p, cfg, experts=None, shared=None) -> dict:
    """A block's MoE leaves in ``layers.moe_apply``'s form; ``experts`` /
    ``shared``: how the experts' and the shared experts' leaves are taken
    (default ``p``, the block's leaf; ``_Leaves.full`` gathers it)."""
    experts, shared = experts or p, shared or p
    gated = ("we3",) if cfg.mlp_gated else ()
    out = {"router": p("moe.router"), **{n: experts(f"moe.{n}") for n in ("we1", "we2") + gated}}
    if cfg.n_shared_experts:
        out["shared"] = {n: shared(f"moe.shared.{n}")
                         for n in ("w1", "w2") + (("w3",) if cfg.mlp_gated else ())}
    return out


def _ffn_residual(p, ffn: str, x, cfg):
    """x + the block's FFN of its second norm (x itself for ``none``);
    returns (x, aux or None)."""
    if ffn == "none":
        return x, None
    h = L.rmsnorm(p("ln2.scale"), x, cfg.norm_eps)
    if ffn == "moe":
        out, aux = L.moe_apply(_moe_params(p, cfg), h, cfg, rows=_rows(p.params))
        return x + out, aux
    w3 = p("mlp.w3") if cfg.mlp_gated else None
    return x + L.mlp_apply(p("mlp.w1"), p("mlp.w2"), h, cfg, w3=w3), None


class _Leaves:
    """One layer's leaves: ``p(name)`` is the leaf (layer ``i`` of a
    stacked one); on a model-parallel rank also its model dim, whole (over
    the group) and so on, for :func:`_tp_block`."""

    def __init__(self, params: dict, pre: str, i=None):
        self.params, self.pre, self.i = params, pre, i

    def __call__(self, name: str):
        leaf = self.params[self.pre + name]
        if self.i is not None:
            leaf = leaf[self.i]
        return _zblock(self.params, self.pre + name, leaf, self.i is not None)

    def dim(self, name: str):
        """The leaf's dim on the model axis (None: held whole)."""
        return self.params.dim(self.pre + name, layer=True)

    def full(self, name: str):
        """The whole leaf where every rank computes alike: gathered over the
        model group, its gradient cut back to the rank's block."""
        d = self.dim(name)
        return self(name) if d is None else TP.gather(self(name), self.params.layout.axis, d)

    def full_partial(self, name: str):
        """The whole leaf where each rank computes a part of its use (so
        holds a partial gradient): gathered, the gradient reduce-scattered;
        a leaf held whole has its gradient all-reduced."""
        d, axis = self.dim(name), self.params.layout.axis
        if d is None:
            return TP.copy_to(self(name), axis)
        return TP.gather(self(name), axis, d, "sum")


def _layers(params: dict, cfg, stack: str = "decoder"):
    """``(where, kind, p)`` of every layer of the ``decoder`` (or
    ``encoder``) stack in order: ``where`` is ``("blocks", "p<j>", i)`` for
    layer i of the stacked pattern position j (kind ``pattern[j]``) or
    ``("rem", i, None)`` for a remainder layer (kind ``pattern[i]``);
    ``p(name)`` returns that layer's leaf (:class:`_Leaves`)."""
    pattern, n_blocks, n_rem = ((ENC_PATTERN, cfg.enc_layers, 0) if stack == "encoder" else
                                (cfg.pattern, cfg.n_scan_blocks, cfg.n_rem_layers))
    for i in range(n_blocks):
        for j, kind in enumerate(pattern):
            yield ("blocks", f"p{j}", i), kind, _Leaves(params, f"{stack}.blocks.p{j}.", i)
    for i in range(n_rem):
        yield ("rem", i, None), pattern[i], _Leaves(params, f"{stack}.rem.{i}.")


# ---------------------------------------------------------------------------
# The model axis (a model-parallel rank's ShardedParams)
# ---------------------------------------------------------------------------

def _model_split(params) -> bool:
    """A model-parallel rank's params (``model`` > 1), which the split code
    paths compute on; an FSDP rank with ``model`` = 1 computes the dense
    way on its gathered blocks."""
    return isinstance(params, ShardedParams) and params.layout.model > 1


def _zblock(params, name: str, leaf, layer: bool = False):
    """The rank's model block of ``leaf`` (leaf ``name`` of ``params``, or
    one layer of it with ``layer``): on an FSDP rank its zero block gathered
    over the zero group (``"sum"``: the gradient reduce-scattered;
    ``"slice"``: the rank's slice of it kept), a leaf held whole over zero
    as it is (``"sum"``: its gradient all-reduced); ``leaf`` itself
    elsewhere."""
    if not isinstance(params, ShardedParams) or params.layout.zero_axis is None:
        return leaf
    axis, d = params.layout.zero_axis, params.zdim(name, layer)
    if d is None:
        return TP.copy_to(leaf, axis) if params.zero_mode == "sum" else leaf
    return TP.gather(leaf, axis, d, params.zero_mode)


def _rows(params):
    """The zero group whose ranks compute their own rows of the microbatch
    (``layers.moe_apply`` then reduces its aux loss's statistics over it),
    else None."""
    if isinstance(params, ShardedParams) and params.zero_mode == "sum":
        return params.layout.zero_axis
    return None


NORM_SCALES = ("ln1.scale", "ln2.scale", "lnx.scale", "final_norm.scale", "enc_norm.scale")


def serving_params(params: dict, cfg) -> dict:
    """The params ``prefill`` / ``decode_step`` compute on, resolved once
    (``train.serve.generate`` does it once per call; each of the two does
    it on params not yet resolved): dense ones as they are; a rank's
    ``ShardedParams`` once every attention layer's KV heads (and
    cross-attention's) are known to be servable (:func:`_rank_kv`), its
    norm scales gathered (a stacked one in one call) and held whole from
    then on."""
    if not isinstance(params, ShardedParams) or params.resolved:
        return params
    for _, kind, p in _layers(params, cfg):
        mixer = _parse_kind(kind)[0]
        if mixer not in RECURRENT:
            _rank_kv(p, cfg)
        if mixer == "xattn":
            _rank_kv(p, cfg, "xattn.")
    axis = params.layout.axis
    out = params.replace({name: TP.gather(leaf, axis, params.dim(name))
                          for name, leaf in params.items()
                          if name.endswith(NORM_SCALES) and params.dim(name) is not None},
                         whole=True)
    out.resolved = True
    return out


def logits_split(params: dict, cfg) -> bool:
    """``prefill`` / ``decode_step`` on ``params`` return the rank's vocab
    block of the logits (a rank whose output table is vocab-sharded), not
    the whole padded vocab."""
    return _vocab_split(params, cfg)


def _full(params: dict, name: str):
    """A whole top-level leaf (gathered on a model-parallel or FSDP rank)."""
    leaf = _zblock(params, name, params[name])
    if not isinstance(params, ShardedParams) or params.dim(name) is None:
        return leaf
    return TP.gather(leaf, params.layout.axis, params.dim(name))


def _tp_block(p: _Leaves, kind: str, x, positions, cfg, enc_out=None, kv_out=None, seq=None,
              sp=None):
    """One block on a model-parallel rank; returns (x, the MoE aux loss or
    None) with x the same on every rank of the group: the mixer split
    (attention by heads, :func:`_tp_attention`; ``encattn`` bidirectional;
    a recurrence by heads or channels, :func:`_tp_recurrent`; an ``xattn``
    block's cross-attention by heads, :func:`_tp_cross_kv` /
    :func:`_tp_cross_residual`), then the FFN (:func:`_tp_ffn`).  With a
    dict ``kv_out`` the rank's cache entry lands in it, as
    :func:`_apply_block`'s: its KV heads (:func:`_rank_kv`), its heads' or
    channels' recurrent state.  ``seq``: x is the rank's chunk of the
    decoder sequence over its data group, as :func:`_apply_block`'s.

    ``sp``: sequence parallelism (``tensor_parallel.seq_shard``): x is the
    rank's ``(B, S / M, d)`` block of the sequence (``positions`` every
    position's), and so is the block's output.  The norms run on the block,
    their scales taken with :meth:`_Leaves.full_partial` (each rank's
    gradient is its rows' part); each column-parallel product reads the
    gathered sequence and each row-parallel one is reduce-scattered over it
    (``tensor_parallel.column_input`` / ``row_output``); attention over
    whole heads (``wq`` / ``wo`` not whole heads, or held whole: the
    reference's ``attn_tp=False``) runs on the block's queries over every
    rank's keys and values (:func:`_tp_qkv`); a mixer or FFN computed alike
    over gathered leaves runs over the gathered sequence and keeps its
    block (:func:`_alike`)."""
    mixer, ffn = _parse_kind(kind)
    axis = p.params.layout.axis
    norm = p.full if sp is None else p.full_partial
    h = L.rmsnorm(norm("ln1.scale"), x, cfg.norm_eps)
    if mixer in RECURRENT:
        x = x + _tp_recurrent(p, mixer, h, cfg, axis, state_out=kv_out, seq=seq, sp=sp)
    else:
        x = x + _tp_attention(p, h, positions, cfg, mixer, axis, kv_out, seq, sp)
    if mixer == "xattn":
        kx, vx = _tp_cross_kv(p, enc_out, cfg, axis, sp)
        if kv_out is not None:
            kv_out.update(kx=kx, vx=vx)
        x = _tp_cross_residual(p, x, kx, vx, cfg, axis, sp)
    if ffn == "none":
        return x, None
    h = L.rmsnorm(norm("ln2.scale"), x, cfg.norm_eps)
    out, aux = _tp_ffn(p, ffn, h, cfg, axis, sp)
    return x + out, aux


def _alike(fn, h, axis, sp):
    """``fn(h)``, computed alike on every rank of the model group over
    gathered leaves; under sequence parallelism (``sp``) over the gathered
    sequence, the rank's block of the output kept (``tensor_parallel.
    split``: the output's gradient all-gathered, so every rank's backward
    of ``fn`` is the whole one)."""
    if sp is None:
        return fn(h)
    return TP.split(fn(TP.gather(h, axis, 1)), axis, 1)


def _tp_decode_block(p: _Leaves, kind: str, entry: dict, x, pos: int, cfg, slots=None):
    """:func:`_decode_block` on a model-parallel rank: attention over the
    rank's query heads, its KV heads written into its cache ``entry`` and
    attended over (the ``swa`` ring as the dense block's), ``wo``
    row-parallel with one all-reduce; a recurrence's step on the rank's
    heads or channels and their state (:func:`_tp_recurrent`); the
    cross-attention over the entry's ``kx`` / ``vx``; the FFN as
    :func:`_tp_ffn`."""
    mixer, ffn = _parse_kind(kind)
    axis = p.params.layout.axis
    h = L.rmsnorm(p.full("ln1.scale"), x, cfg.norm_eps)
    if mixer in RECURRENT:
        out, new = _tp_recurrent(p, mixer, h[:, 0], cfg, axis, cache=entry)
        for name, value in new.items():
            entry[name].copy_(value)
        x = x + out[:, None]
    else:
        positions = torch.arange(pos, pos + 1, device=x.device)
        q, k, v, split = _tp_qkv(p, h, positions, cfg, axis)
        x = x + _tp_out(p, _cache_attend(entry, mixer, q, k, v, pos, slots), axis, split)
    if mixer == "xattn":
        x = _tp_cross_residual(p, x, entry["kx"], entry["vx"], cfg, axis)
    if ffn == "none":
        return x
    h = L.rmsnorm(p.full("ln2.scale"), x, cfg.norm_eps)
    return x + _tp_ffn(p, ffn, h, cfg, axis)[0]


def _kv_heads(cfg, model: int, index: int) -> tuple:
    """(first KV head, KV heads) that model rank ``index``'s query heads
    attend with: its ``H / M`` query heads are whole groups of ``H / KVH``,
    or lie in one group."""
    hl, rep = cfg.n_heads // model, cfg.n_heads // cfg.n_kv_heads
    h0 = index * hl
    if hl % rep == 0:
        return h0 // rep, hl // rep
    if rep % hl == 0:
        return h0 // rep, 1
    raise NotImplementedError(
        f"{cfg.name}: {hl} query heads per rank cut the KV groups of {rep} heads across "
        f"ranks; such a split is neither trained nor served over the model axis "
        f"(ROADMAP.md queue 1, 'Refused')")


def _heads_split(p: _Leaves, cfg, model: int, pre: str = "attn.") -> bool:
    """The rank holds whole query heads of ``wq`` (column-parallel) and
    their rows of ``wo`` (row-parallel) under ``pre`` (``"attn."``, the
    cross-attention's ``"xattn."``): attention is split by heads."""
    return p.dim(pre + "wq") == 1 and p.dim(pre + "wo") == 0 and cfg.n_heads % model == 0


def _rank_kv(p: _Leaves, cfg, pre: str = "attn.") -> tuple:
    """(first KV head, KV heads) a model-parallel rank computes and caches
    for this layer's attention under ``pre``: those of :func:`_kv_heads`
    where it is split by heads, else all of them (the replicated compute
    over gathered leaves)."""
    lay = p.params.layout
    if not _heads_split(p, cfg, lay.model, pre):
        return 0, cfg.n_kv_heads
    return _kv_heads(cfg, lay.model, lay.model_index)


def _kv_direct(p: _Leaves, cfg, model: int, pre: str = "attn.") -> bool:
    """The rank's blocks of ``wk`` / ``wv`` under ``pre`` are the KV heads
    its query heads read: whole KV heads cut on the column dim."""
    return cfg.n_kv_heads % model == 0 and p.dim(pre + "wk") == 1 and p.dim(pre + "wv") == 1


def _kv_weights(p: _Leaves, cfg, axis, pre: str = "attn.") -> tuple:
    """(wk, wv, KV heads) of the KV heads the rank's query heads read under
    ``pre``: its blocks of ``wk`` / ``wv`` where they are those heads, else
    those heads' columns of the whole leaves (gathered, the gradient
    reduce-scattered: the rank's block cuts a head, or is not on the model
    axis)."""
    M, hd = axis.world, cfg.hd
    if _kv_direct(p, cfg, M, pre):
        return p(pre + "wk"), p(pre + "wv"), cfg.n_kv_heads // M
    kv0, nkv = _kv_heads(cfg, M, axis.rank)
    cols = slice(kv0 * hd, (kv0 + nkv) * hd)
    return p.full_partial(pre + "wk")[:, cols], p.full_partial(pre + "wv")[:, cols], nkv


def _tp_qkv(p: _Leaves, h, positions, cfg, axis, sp=None) -> tuple:
    """(q, k, v, split): the rank's query heads (``wq`` column-parallel) and
    the KV heads they read (:func:`_kv_weights`), or every head over
    gathered leaves where ``wq`` / ``wo``'s blocks are not whole heads
    (``split`` False).  ``sp``: h is the rank's block of the sequence: the
    split heads read the gathered sequence; every head's are the block's
    rows (RoPE at its positions), the leaves taken with
    :meth:`_Leaves.full_partial`."""
    M = axis.world
    if not _heads_split(p, cfg, M):
        w = p.full if sp is None else p.full_partial
        if sp is not None:
            positions = positions[sp.start:sp.stop]
        q, k, v = L.attn_qkv(w("attn.wq"), w("attn.wk"), w("attn.wv"), h, positions, cfg)
        return q, k, v, False
    hc = TP.column_input(h, axis, sp)
    wk, wv, nkv = _kv_weights(p, cfg, axis)
    q, k, v = L.attn_qkv(p("attn.wq"), wk, wv, hc, positions, cfg,
                         heads=(cfg.n_heads // M, nkv))
    return q, k, v, True


def _tp_out(p: _Leaves, out, axis, split: bool, sp=None):
    """The attention output's projection: ``wo`` row-parallel with one
    all-reduce (``sp``: reduce-scatter), or over the gathered ``wo``
    (``sp``: the block's rows, ``full_partial``)."""
    if not split:
        return L.attn_proj_out((p.full if sp is None else p.full_partial)("attn.wo"), out)
    return TP.row_output(L.attn_proj_out(p("attn.wo"), out), axis, sp)


def _tp_attention(p: _Leaves, h, positions, cfg, mixer: str, axis, kv_out=None, seq=None,
                  sp=None):
    """Attention over the rank's whole query heads (``wq`` column- and
    ``wo`` row-parallel, one all-reduce of the output); replicated over
    gathered leaves where ``wq`` / ``wo``'s blocks are not whole heads.
    Causal (``swa``: sliding), or over every position (the encoder's
    ``encattn``): :func:`_self_attend`.  ``sp``: h is the rank's block of
    the sequence (:func:`_tp_qkv`); where every head is computed, the
    block's queries attend over every rank's keys and values."""
    q, k, v, split = _tp_qkv(p, h, positions, cfg, axis, sp)
    out = _self_attend(q, k, v, mixer, cfg, kv_out, seq, None if split else sp)
    return _tp_out(p, out, axis, split, sp)


def _cross_split(params: dict, cfg) -> bool:
    """An ``encdec`` model's cross-attention is split by heads on this
    model-parallel rank (every ``xattn`` layer's placement is the same):
    each rank's gradient of the encoder output is then partial."""
    if not _model_split(params) or cfg.family != "encdec":
        return False
    return any(_parse_kind(kind)[0] == "xattn"
               and _heads_split(p, cfg, params.layout.model, "xattn.")
               for _, kind, p in _layers(params, cfg))


def _tp_cross_kv(p: _Leaves, enc_out, cfg, axis, sp=None) -> tuple:
    """(kx, vx) of the cross-attention on a model-parallel rank: its KV
    heads' (``xattn.wk`` / ``wv`` column-parallel over the encoder output,
    which every rank holds alike and whose gradient :func:`_inputs`
    all-reduces once), or every head's over the gathered leaves where
    ``xattn``'s blocks are not whole heads (``sp``: ``full_partial``, as
    the queries are the rank's block's)."""
    if not _heads_split(p, cfg, axis.world, "xattn."):
        return _cross_kv(p.full if sp is None else p.full_partial, enc_out, cfg)
    return _cross_kv(p, enc_out, cfg, _kv_weights(p, cfg, axis, "xattn."))


def _tp_cross_residual(p: _Leaves, x, kx, vx, cfg, axis, sp=None):
    """:func:`_cross_residual` on a model-parallel rank: ``lnx`` gathered,
    the rank's query heads (``xattn.wq`` column-parallel) over its ``kx`` /
    ``vx``, ``xattn.wo`` row-parallel with one all-reduce; replicated over
    the gathered leaves where the blocks are not whole heads.  ``sp``: x
    is the rank's block of the sequence: the split heads' queries read the
    gathered sequence and ``xattn.wo`` is reduce-scattered over it; every
    head's queries are the block's rows (``full_partial``)."""
    norm = p.full if sp is None else p.full_partial
    if not _heads_split(p, cfg, axis.world, "xattn."):
        return _cross_residual(norm, x, kx, vx, cfg)
    hx = TP.column_input(L.rmsnorm(norm("lnx.scale"), x, cfg.norm_eps), axis, sp)
    B, S, _ = hx.shape
    qx = (hx @ p("xattn.wq").to(hx.dtype)).reshape(B, S, cfg.n_heads // axis.world, cfg.hd)
    out = L.attn_proj_out(p("xattn.wo"), L.full_attention(qx, kx, vx))
    return x + TP.row_output(out, axis, sp)


def _rank_width(mixer: str, cfg, model: int):
    """The heads (``ssm``) or channels (``rglru``) a model-parallel rank
    computes of a recurrent mixer: its ``1 / model`` share, or None where
    they do not divide (mamba2 SMOKE's 8 heads over the pod's 16 model
    ranks): the placement then holds the mixer's leaves whole or in blocks
    no rank can compute from, and every rank computes every head or channel
    over its leaves gathered one at a time (:func:`_tp_recurrent`)."""
    width = cfg.ssm_heads if mixer == "ssm" else cfg.d_rnn
    return width // model if width % model == 0 else None


def mixer_parts(mixer: str, cfg, model: int, index: int) -> dict:
    """``{leaf: (dim, ranges)}`` of a recurrent mixer on model rank
    ``index``: the (start, stop) ranges along ``dim`` of each whole leaf
    (one layer's) that its heads (``ssm``: ``in_proj``'s columns of their z,
    x and dt and all of B and C, ``conv``'s channels of their x and all of
    B and C, their ``A_log``, ``D``, ``dt_bias``, ``norm`` channels and
    ``out_proj`` rows) or channels (``rglru``: ``in_x`` / ``in_gate`` /
    ``w_a`` / ``w_x`` columns, ``conv`` and ``lam`` channels, ``out`` rows)
    read.  The reference's placements cut ``in_proj`` and ``conv`` into
    contiguous blocks that are not these (:func:`_part`)."""
    n = _rank_width(mixer, cfg, model)
    if mixer == "rglru":
        ch = [(index * n, (index + 1) * n)]
        return {leaf: (d, ch) for leaf, d in (
            ("in_x", 1), ("in_gate", 1), ("conv.w", 1), ("conv.b", 0), ("w_a", 1),
            ("w_x", 1), ("lam", 0), ("out", 0))}
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    heads, ch = (index * n, (index + 1) * n), (index * n * P, (index + 1) * n * P)
    bc = (2 * di, 2 * di + 2 * N)
    dt = tuple(2 * di + 2 * N + h for h in heads)
    conv = [ch, (di, di + 2 * N)]
    return {"in_proj": (1, [ch, (di + ch[0], di + ch[1]), bc, dt]),
            "conv.w": (1, conv), "conv.b": (0, conv), "A_log": (0, [heads]),
            "D": (0, [heads]), "dt_bias": (0, [heads]), "norm.scale": (0, [ch]),
            "out_proj": (0, [ch])}


def _part(p: _Leaves, name: str, dim: int, ranges: list):
    """The rank's part of one layer's leaf ``name``: the whole leaf's
    ``ranges`` along ``dim``, concatenated.  Its block as it is where that
    is the one range and the placement cuts ``dim`` (so the block is that
    range); else cut from the whole leaf (:meth:`_Leaves.full_partial`:
    gathered, its gradient reduce-scattered, or all-reduced for a leaf held
    whole)."""
    if len(ranges) == 1 and p.dim(name) == dim:
        return p(name)
    whole = p.full_partial(name)
    return torch.cat([whole.narrow(dim, a, b - a) for a, b in ranges], dim=dim)


def _rank_mixer(p: _Leaves, mixer: str, cfg) -> dict:
    """A recurrent mixer's leaves for the rank's heads or channels
    (:func:`mixer_parts`), nested as :func:`_mixer_params`."""
    lay, out = p.params.layout, {}
    for leaf, (dim, ranges) in mixer_parts(mixer, cfg, lay.model, lay.model_index).items():
        head, _, key = leaf.rpartition(".")
        (out.setdefault(head, {}) if head else out)[key] = _part(p, f"{mixer}.{leaf}", dim,
                                                                 ranges)
    return out


def _tp_recurrent(p: _Leaves, mixer: str, h, cfg, axis, state_out=None, cache=None, seq=None,
                  sp=None):
    """A recurrent mixer on a model-parallel rank (``layers.mamba2_apply``
    / ``rglru_apply`` with ``tp``): Mamba-2 by heads, the RG-LRU by
    channels (:func:`_rank_mixer`); replicated over its leaves, each
    gathered at use, where they do not divide over the group
    (:func:`_rank_width`).  With a ``cache`` entry, one decode step
    (``mamba2_decode`` / ``rglru_decode``): (out, the new state).
    ``seq``: h is the rank's chunk of a sequence over its data group.
    ``sp``: h is the rank's block of the sequence over its model group: the
    split mixer reads the gathered sequence and its output is
    reduce-scattered; the whole one runs :func:`_alike`.  With both, h is
    the block of the rank's chunk, gathered over the model group into the
    chunk, whose recurrence is then carried across the data group."""
    split = _rank_width(mixer, cfg, axis.world) is not None
    params = _rank_mixer(p, mixer, cfg) if split else _mixer_params(p.full, mixer, cfg)
    tp = axis if split else None
    if cache is not None:
        step = L.mamba2_decode if mixer == "ssm" else L.rglru_decode
        return step(params, cache, h, cfg, tp=tp)
    apply = L.mamba2_apply if mixer == "ssm" else L.rglru_apply
    if split or sp is None:
        return apply(params, h, cfg, state_out=state_out, tp=tp, seq=seq, sp=sp)
    return _alike(lambda h: apply(params, h, cfg, state_out=state_out, seq=seq), h, axis, sp)


def _mlp_split(p: _Leaves, pre: str, cfg) -> bool:
    """The rank's blocks of the MLP under ``pre`` (``"mlp."``,
    ``"moe.shared."``) split d_ff: ``w1`` / ``w3`` column-, ``w2``
    row-parallel."""
    return (p.dim(pre + "w1") == 1 and p.dim(pre + "w2") == 0
            and (not cfg.mlp_gated or p.dim(pre + "w3") == 1))


def _experts_split(p: _Leaves, cfg, pre: str = "moe.") -> bool:
    """The rank's blocks of the experts under ``pre`` split d_ff: ``we1`` /
    ``we3`` (E, d, d_ff / M), ``we2`` (E, d_ff / M, d)."""
    return (p.dim(pre + "we1") == 2 and p.dim(pre + "we2") == 1
            and (not cfg.mlp_gated or p.dim(pre + "we3") == 2))


def _tp_ffn(p: _Leaves, ffn: str, h, cfg, axis, sp=None) -> tuple:
    """(the block's FFN of h, the MoE aux loss or None) on a model-parallel
    rank: :func:`_tp_mlp` or :func:`_tp_moe`; ``sp``: h and the output are
    the rank's block of the sequence."""
    if ffn == "moe":
        return _tp_moe(p, h, cfg, axis, sp)
    return _tp_mlp(p, h, cfg, axis, sp), None


def _tp_mlp(p: _Leaves, h, cfg, axis, sp=None):
    """The dense FFN, ``w1`` / ``w3`` column- and ``w2`` row-parallel with
    one all-reduce (``sp``: the sequence gathered in, reduce-scattered
    out); replicated over gathered leaves where the blocks do not split
    d_ff (:func:`_alike`)."""
    gated = cfg.mlp_gated
    if not _mlp_split(p, "mlp.", cfg):
        w3 = p.full("mlp.w3") if gated else None
        return _alike(lambda h: L.mlp_apply(p.full("mlp.w1"), p.full("mlp.w2"), h, cfg, w3=w3),
                      h, axis, sp)
    hc = TP.column_input(h, axis, sp)
    w3 = p("mlp.w3") if gated else None
    return TP.row_output(L.mlp_apply(p("mlp.w1"), p("mlp.w2"), hc, cfg, w3=w3), axis, sp)


ROUTER_SPLIT = {1: "E", 0: "d"}       # the router's (d, E) dim on the model axis


def _tp_moe(p: _Leaves, h, cfg, axis, sp=None) -> tuple:
    """The MoE FFN on a model-parallel rank (``layers.moe_apply`` with its
    :class:`~repro_torch.models.layers.MoESplit`): the router's block of
    experts or rows, the experts' and the shared experts' d_ff blocks where
    the placement cuts d_ff (:func:`_experts_split`, :func:`_mlp_split`),
    else those leaves gathered and computed replicated; ``sp``: h is the
    rank's block of the sequence (``MoESplit.seq``)."""
    experts = _experts_split(p, cfg)
    shared = cfg.n_shared_experts > 0 and _mlp_split(p, "moe.shared.", cfg)
    params = _moe_params(p, cfg, p if experts else p.full, p if shared else p.full)
    split = L.MoESplit(axis, ROUTER_SPLIT.get(p.dim("moe.router")), experts, shared, sp)
    return L.moe_apply(params, h, cfg, rows=_rows(p.params), tp=split)


def _vocab_split(params: dict, cfg) -> bool:
    """The output table is vocab-sharded on this model-parallel rank."""
    if not _model_split(params):
        return False
    return (params.dim("embed") == 0 if cfg.tie_embeddings
            else params.dim("lm_head") == 1)


def _embed(params: dict, tokens: torch.Tensor, cfg, sp=None) -> torch.Tensor:
    """Embedding rows cast to the activation dtype, scaled by sqrt(d_model)
    (vocab-parallel on a model-parallel rank whose ``embed`` block is a
    range of rows).  ``sp``: the rank's block of the sequence's rows (the
    vocab-parallel sum reduce-scattered over it)."""
    if _model_split(params) and params.dim("embed") == 0:
        rows = TP.vocab_embed(_zblock(params, "embed", params["embed"]), tokens,
                              params.layout.axis, sp)
    else:
        rows = _full(params, "embed")[tokens]
        if sp is not None:
            rows = TP.split(rows, params.layout.axis, 1)
    return rows.to(cfg.act_dtype) * math.sqrt(cfg.d_model)


def _patch_prefix(params: dict, patches: torch.Tensor, cfg) -> torch.Tensor:
    """A ``vlm`` batch's patches (B, P, d) projected by ``patch_proj``: on
    a model-parallel rank whose block is a range of output columns,
    column-parallel, the rank's (B, P, d / M) columns gathered over the
    group (each rank keeps its columns of the gradient); else over the
    whole leaf."""
    x = patches.to(cfg.act_dtype)
    if _model_split(params) and params.dim("patch_proj") == 1:
        w = _zblock(params, "patch_proj", params["patch_proj"])
        return TP.gather(x @ w.to(x.dtype), params.layout.axis, x.dim() - 1)
    return x @ _full(params, "patch_proj").to(x.dtype)


def _add_aux(total, aux):
    if aux is None:
        return total
    return aux if total is None else total + aux


def _encode(params: dict, frames: torch.Tensor, cfg, remat: bool = True,
            unroll: bool = False, sp=None) -> torch.Tensor:
    """The encoder over the (stub) frame embeddings (B, enc_len, d): cast to
    the activation dtype, the ``encattn`` blocks with RoPE at
    ``arange(enc_len)``, ``enc_norm``.  ``remat`` checkpoints each block
    (:func:`_run_stack`, the ``"full"`` policy, as the reference's
    ``_encode``); ``unroll`` is a no-op.  ``sp``: sequence parallelism over
    the frames (:func:`_sp`): the rank's block of them, and of the
    output."""
    x = frames.to(cfg.act_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    if sp is not None:
        x = x[:, sp.start:sp.stop]
    x, _ = _run_stack(params, cfg, "encoder", x, positions, remat=remat, sp=sp)
    scale = _full(params, "enc_norm.scale") if sp is None else _full_partial(params,
                                                                             "enc_norm.scale")
    return L.rmsnorm(scale, x, cfg.norm_eps)


def _inputs(params: dict, batch: dict, cfg, remat: bool = False, seq=None, sp=None) -> tuple:
    """(the decoder's input (B, n_prefix + S, d), the encoder output or
    None, n_prefix): the text embedding, after the projected patches of a
    ``vlm`` batch (``n_prefix`` of them); an ``encdec`` batch's frames
    through the encoder (whole on every model-parallel rank), its output
    through ``copy_to`` where the cross-attention is split
    (:func:`_cross_split`).  ``seq``: the rank's chunk ``[start, stop)`` of
    the n_prefix + S positions over its data group, its patches and tokens
    alone projected and embedded (the encoder runs whole); a rank whose
    chunk holds no tokens (no patches) still takes its part in the data
    group's gather of ``embed`` (``patch_proj``) on an FSDP rank, in the
    same order as the ranks that use it.

    ``sp``: sequence parallelism over the model group (:func:`_sp`): the
    decoder's input is the rank's block of the n_prefix + S positions, or
    with ``seq`` of its chunk (a VLM's patches and text joined first, then
    cut, ``tensor_parallel.split``).  The encoder runs over its own block
    of the frames where they divide, its output gathered for the
    cross-attention; where a
    rank's use of the encoder output is partial (the cross-attention split
    by heads, or the decoder's block of queries) its gradient is summed
    over the group."""
    tokens = batch["tokens"]
    n_prefix = batch["patches"].shape[1] if cfg.family == "vlm" else 0
    a, b = (0, n_prefix + tokens.shape[1]) if seq is None else (seq.start, seq.stop)
    x = None
    if b > n_prefix:
        x = _embed(params, tokens[:, max(a - n_prefix, 0):b - n_prefix], cfg,
                   None if n_prefix else sp)
    else:
        _zblock(params, "embed", params["embed"])
    enc_out = None
    if cfg.family == "encdec":
        frames = batch["frames"]
        enc_sp = _sp(params, cfg, frames.shape[1]) if seq is None else None
        enc_out = _encode(params, frames, cfg, remat=remat, sp=enc_sp)
        partial = _cross_split(params, cfg) or sp is not None
        if enc_sp is not None:
            enc_out = TP.gather(enc_out, params.layout.axis, 1, "sum" if partial else "slice")
        elif partial:
            enc_out = TP.copy_to(enc_out, params.layout.axis)
    elif cfg.family == "vlm" and a < n_prefix:
        patches = _patch_prefix(params, batch["patches"][:, a:min(b, n_prefix)], cfg)
        x = patches if x is None else torch.cat([patches, x], dim=1)
    elif cfg.family == "vlm":
        _zblock(params, "patch_proj", params["patch_proj"])
    if sp is not None and n_prefix:
        x = TP.split(x, params.layout.axis, 1)
    return x, enc_out, n_prefix


def _sp(params: dict, cfg, length: int):
    """The rank's block of a ``length``-position sequence under sequence
    parallelism on a model-parallel rank (``tensor_parallel.seq_shard``),
    else None."""
    return TP.seq_shard(cfg, params.layout, length) if _model_split(params) else None


def _full_partial(params: dict, name: str):
    """A whole top-level leaf used on the rank's block of the sequence
    (:meth:`_Leaves.full_partial`)."""
    return _Leaves(params, "").full_partial(name)


def _repeats(params: dict, cfg, stack: str):
    """The layers of a stack as the reference's ``_run_stack`` runs them:
    ``(True, layers)`` for each repeat i of the pattern (``p0..p{k-1}`` of
    block i, the scan body that remat checkpoints), then ``(False,
    [layer])`` for each remainder layer, which it runs unchecked; a layer is
    :func:`_layers`' ``(where, kind, p)``."""
    layers = list(_layers(params, cfg, stack))
    k = len(ENC_PATTERN if stack == "encoder" else cfg.pattern)
    n = cfg.enc_layers if stack == "encoder" else cfg.n_scan_blocks
    for i in range(n):
        yield True, layers[i * k:(i + 1) * k]
    for layer in layers[n * k:]:
        yield False, [layer]


_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy, ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``: save the 2-D products (an
    activation times a weight, ``aten.mm`` after matmul's reshape) and
    recompute the rest, the batched ones (attention's scores and values, the
    SSD's products: ``aten.bmm``) among them.  A MoE layer's per-expert
    products are ``aten.mm`` too, but they stand for ``ragged_dot``, which
    the JAX policy does not save (it is no ``dot_general``):
    ``layers.in_ragged_dot`` tells them apart."""
    if op in _DOT_OPS and not L.in_ragged_dot():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(body, policy: str, *args):
    """``body(*args)`` under activation checkpointing: ``"dots"`` keeps
    :func:`_save_dots`' products, any other policy string recomputes the
    whole body in the backward (``"full"``), as the reference's
    ``_run_stack``.  Nothing in a block draws random numbers, so no RNG
    state is kept."""
    context = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
               if policy == "dots" else noop_context_fn)
    return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context)


def _run_stack(params: dict, cfg, stack: str, x, positions, enc_out=None,
               remat: bool = False, remat_policy: str = "full", sp=None):
    """The ``decoder`` (or ``encoder``) stack over x; returns (x, the MoE
    aux loss summed over the layers in order, or None).  With ``remat`` each
    repeat of the pattern runs under :func:`_checkpointed`: the same
    operations on the same inputs, so the loss and the gradients are bit
    for bit those without it.  ``sp``: x is the rank's block of the
    sequence (:func:`_tp_block`)."""
    aux = None
    for repeat, layers in _repeats(params, cfg, stack):
        def body(x, aux, layers=layers):
            for _, kind, p in layers:
                x, a = _apply_block(p, kind, x, positions, cfg, enc_out, sp=sp)
                aux = _add_aux(aux, a)
            return x, aux

        if repeat and remat:
            x, aux = _checkpointed(body, remat_policy, x, aux)
        else:
            x, aux = body(x, aux)
    return x, aux


def _forward(params: dict, batch: dict, cfg, remat: bool = False,
             remat_policy: str = "full"):
    """(final hidden states, the MoE aux loss summed over layers or None,
    n_prefix, the sequence's split over the model group or None): under
    sequence parallelism (:func:`_sp`) the hidden states are the rank's
    block of the positions, ``final_norm`` run on it."""
    n = batch["tokens"].shape[1] + (batch["patches"].shape[1] if cfg.family == "vlm" else 0)
    sp = _sp(params, cfg, n)
    x, enc_out, n_prefix = _inputs(params, batch, cfg, remat, sp=sp)
    positions = torch.arange(n, device=x.device)
    x, aux = _run_stack(params, cfg, "decoder", x, positions, enc_out, remat, remat_policy, sp)
    scale = (_full(params, "final_norm.scale") if sp is None
             else _full_partial(params, "final_norm.scale"))
    return L.rmsnorm(scale, x, cfg.norm_eps), aux, n_prefix, sp


def hidden_states(params: dict, batch: dict, cfg, remat: bool = True, unroll: bool = False,
                  remat_policy: str = "full") -> tuple:
    """The full forward to the final hidden states; returns (h (B,
    n_prefix + S, d), the f32 MoE aux loss (0 without a MoE layer),
    n_prefix: the non-text positions, a ``vlm`` batch's patches, that the
    loss leaves out).  ``remat`` / ``remat_policy``: activation
    checkpointing per pattern repeat (:func:`_run_stack`), the reference's
    keywords and defaults.  ``unroll`` is accepted and does nothing: the
    eager loop over the layers is unrolled already, where the reference
    chooses between a scan and a Python loop.  Under sequence parallelism
    every rank returns the whole h, its blocks gathered."""
    h, aux, n_prefix, sp = _forward(params, batch, cfg, remat, remat_policy)
    if sp is not None:
        h = TP.gather(h, sp.axis, 1)
    if aux is None:
        aux = torch.zeros((), dtype=F32, device=h.device)
    return h, aux, n_prefix


def _head(params, cfg):
    """The output table: on a model-parallel rank with a vocab-sharded
    table its vocab block (:func:`_vocab_split`), else the gathered table."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    if _vocab_split(params, cfg):
        return _zblock(params, name, params[name])
    return _full(params, name)


def _logits(params, h, cfg, w=None):
    """f32 logits over the PADDED vocab (the padded rows are live weights);
    on a model-parallel rank with a vocab-sharded table, its block of the
    vocab (:func:`_vocab_split`), else over the gathered table.  ``w``: the
    table :func:`_head` gave (a caller that takes several chunks' logits
    gathers it once)."""
    w = _head(params, cfg) if w is None else w
    if cfg.tie_embeddings:
        return h.to(F32) @ w.to(F32).T
    return h.to(F32) @ w.to(F32)


def loss_fn(params: dict, batch: dict, cfg, remat: bool = True, unroll: bool = False,
            remat_policy: str = "full") -> torch.Tensor:
    """Next-token CE over ``batch["tokens"]`` (B, S) at the text positions
    (``h[:, n_prefix:]``), chunked over the sequence: the targets are
    shifted, the last position is masked, and the loss is the masked sum
    over ``mask.sum()``, plus ``MOE_AUX_COEF`` times the aux loss summed
    over the MoE layers (a model without one adds nothing).  ``remat``,
    ``unroll``, ``remat_policy``: as :func:`hidden_states`.  Under sequence
    parallelism the final hidden states' blocks are gathered before the
    head (their gradient reduce-scattered where the head is vocab-parallel),
    so the loss and its token mean are the whole sequence's."""
    h, aux, n_prefix, sp = _forward(params, batch, cfg, remat, remat_policy)
    split = _vocab_split(params, cfg)
    if sp is not None:
        h = TP.gather(h, sp.axis, 1, "sum" if split else "slice")
    h = h[:, n_prefix:]
    tokens = batch["tokens"]
    B, S = tokens.shape
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = torch.cat([torch.ones(B, S - 1, dtype=F32, device=tokens.device),
                      torch.zeros(B, 1, dtype=F32, device=tokens.device)], dim=1)
    total = torch.zeros((), dtype=F32, device=tokens.device)
    if split:
        # the vocab-parallel head: each rank's logits are its block of rows
        axis = params.layout.axis
        if sp is None:
            h = TP.copy_to(h, axis)
    head = _head(params, cfg)
    for c0 in range(0, S, min(CE_CHUNK, S)):
        c1 = min(c0 + CE_CHUNK, S)
        logits = _logits(params, h[:, c0:c1], cfg, head)
        if split:
            per_token = TP.vocab_cross_entropy(logits, targets[:, c0:c1], axis)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            per_token = lse - torch.gather(logits, -1, targets[:, c0:c1, None])[..., 0]
        total = total + (per_token * mask[:, c0:c1]).sum()
    loss = total / torch.clamp(mask.sum(), min=1.0)
    return loss if aux is None else loss + MOE_AUX_COEF * aux


# ---------------------------------------------------------------------------
# Serving: the cache, prefill, one-token decode (the reference's
# transformer.init_cache / prefill / decode_step)
# ---------------------------------------------------------------------------

def _cache_len(kind: str, cfg, max_len: int) -> int:
    """A layer's cache slots: ``max_len``, or a ring of ``min(window,
    max_len)`` for ``swa``."""
    return min(cfg.window, max_len) if _parse_kind(kind)[0] == "swa" else max_len


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None,
               layout: FlatLayout = None, slots=None) -> dict:
    """Zero cache with the reference's structure: ``{"blocks": {"p<j>":
    entry}, "rem": (entry, ...)}``, stacked leaves with a leading
    (n_scan_blocks,) axis, in ``dtype`` (default the activation dtype)
    unless named.  An attention layer's entry is ``{"k", "v"}`` (batch, L,
    KVH, hd), with L = ``max_len`` or a ``swa`` layer's ``min(window,
    max_len)``; an ``xattn`` layer's adds the encoder's keys and values
    ``kx`` / ``vx`` (batch, enc_len, KVH, hd); an ``ssm`` layer's is
    ``{"state": (batch, H, P, N) f32, "conv": (batch, width - 1, d_inner +
    2N)}``, an ``rglru`` layer's ``{"h": (batch, d_rnn) f32, "conv":
    (batch, width - 1, d_rnn)}``.

    A serving rank passes its batch rows as ``batch`` and its ``layout``
    (``tensor_parallel.rank_layout``): its attention layers then cache the
    KV heads the rank computes (:func:`_rank_kv`) in place of KVH (and its
    cross-attention's, ``kx`` / ``vx``), its ``ssm`` layers its H / M heads'
    state and d_inner / M + 2N conv channels, its ``rglru`` layers its d_rnn
    / M channels (:func:`_rank_width`; all of them where they do not
    divide).  ``slots``: the ``max_len`` slots of a full-attention layer
    (``attn``, an ``xattn`` layer's ``k`` / ``v``) over the rank's data
    group (``tensor_parallel.serve_split``): it holds its block of
    ``max_len / D`` (``swa`` rings, recurrent states and ``kx`` / ``vx``
    stay whole)."""
    check_supported(cfg)
    if slots is not None and slots.length != max_len:
        raise ValueError(f"slots over {slots.length} positions for a cache of {max_len}")
    dtype = dtype or cfg.act_dtype
    rank = ShardedParams(layout) if layout is not None and layout.model > 1 else None

    def entry(kind, pre, lead=()):
        mixer = _parse_kind(kind)[0]
        width = None if rank is None else _rank_width(mixer, cfg, layout.model)
        if mixer == "ssm":
            return L.mamba2_init_cache(cfg, batch, dtype, lead, device, heads=width)
        if mixer == "rglru":
            return L.rglru_init_cache(cfg, batch, dtype, lead, device, channels=width)
        n = _cache_len(kind, cfg, max_len) if slots is None or mixer == "swa" else slots.n
        p = None if rank is None else _Leaves(rank, pre)
        kvh = cfg.n_kv_heads if p is None else _rank_kv(p, cfg)[1]
        shapes = {"k": (n, kvh), "v": (n, kvh)}
        if mixer == "xattn":
            xkv = cfg.n_kv_heads if p is None else _rank_kv(p, cfg, "xattn.")[1]
            shapes.update(kx=(cfg.enc_len, xkv), vx=(cfg.enc_len, xkv))
        return {name: torch.zeros(lead + (batch,) + shape + (cfg.hd,), dtype=dtype,
                                  device=device)
                for name, shape in shapes.items()}

    blocks = ({f"p{j}": entry(kind, f"decoder.blocks.p{j}.", (cfg.n_scan_blocks,))
               for j, kind in enumerate(cfg.pattern)} if cfg.n_scan_blocks > 0 else {})
    return {"blocks": blocks,
            "rem": tuple(entry(cfg.pattern[i], f"decoder.rem.{i}.")
                         for i in range(cfg.n_rem_layers))}


def _cache_entry(cache: dict, where) -> dict:
    """One layer's entry of views into the cache (``{"k", "v"[, "kx",
    "vx"]}``, ``{"state", "conv"}`` or ``{"h", "conv"}``): a new dict, so a
    layer updates its entry by writing into these views."""
    kind, key, i = where
    if kind == "blocks":
        return {name: leaf[i] for name, leaf in cache["blocks"][key].items()}
    return cache["rem"][key]


def prefill(params: dict, batch: dict, cfg, remat: bool = True, unroll: bool = False,
            seq=None, slots=None):
    """Forward over the prompt: ``batch["tokens"]`` (B, S) after a ``vlm``
    batch's ``patches``, beside an ``encdec`` batch's ``frames``.  Returns
    (last position's f32 logits (B, padded vocab), a cache holding every
    layer's keys and values: all n_prefix + S positions, a ``swa`` layer's
    last ``min(window, n_prefix + S)`` in position order, an ``xattn``
    layer's ``kx`` / ``vx`` of the encoder output, collected once; a
    recurrent layer's state after the prompt, computed from the block's
    own forward: :func:`_mamba2_final_state`, :func:`_rglru_final_state`).
    ``remat`` runs each pattern repeat (and the encoder's blocks) under
    activation checkpointing, as the reference's prefill; under
    ``torch.no_grad`` nothing is saved and each body runs once.  ``unroll``
    is a no-op (:func:`hidden_states`).  On a serving rank (``params`` its
    ``ShardedParams``, ``batch`` its rows): the rank's cache
    (:func:`init_cache`'s ``layout``) and, where :func:`logits_split`, its
    vocab block of the logits (B, padded vocab / model).

    Where the batch does not split over data (``tensor_parallel.
    serve_split``): ``seq``, the rank's chunk of the n_prefix + S positions
    (``batch`` the whole batch): the rank runs its chunk (positions offset,
    :func:`_self_attend`, the recurrences carried), and the last
    position's hidden state is all-gathered from the last data rank, so
    every rank returns the same logits; ``slots``, the rank's block of a
    full-attention layer's cache of ``slots.length`` slots
    (:func:`init_cache`'s ``slots``): its entry holds positions ``[start,
    stop)``, zeros past the prompt.  Without ``slots`` that entry holds
    every position (gathered where ``seq``); a ``swa`` ring, the recurrent
    states and ``kx`` / ``vx`` are whole on every rank.

    Under sequence parallelism (``cfg.attn_seq_shard`` on a model-parallel
    rank, :func:`_sp`) the rank runs its block of the positions
    (:func:`_tp_block`) and the last position's hidden state is
    all-gathered from the last model rank; its cache is what it is without
    the flag.  With ``seq`` as well the block is one of the rank's chunk
    (``tensor_parallel.seq_shard`` of the chunk's length; the chunk whole
    over the model group where it does not divide): the keys and values
    are gathered over the model group, then over the data group, each
    recurrence carried over the model group's blocks by the gather and then
    across the data group's chunks, and the last position's hidden state
    comes from the last model rank of the last data rank; the cache is what
    the same grid holds without the flag."""
    check_supported(cfg)
    params = serving_params(params, cfg)
    n = batch["tokens"].shape[1] + (batch["patches"].shape[1] if cfg.family == "vlm" else 0)
    sp = _sp(params, cfg, n if seq is None else seq.n)
    x, enc_out, _ = _inputs(params, batch, cfg, remat, seq, sp)
    start = 0 if seq is None else seq.start
    positions = torch.arange(start, start + (x.shape[1] if sp is None else sp.length),
                             device=x.device)
    stacked: dict = {}
    rem = []
    for repeat, layers in _repeats(params, cfg, "decoder"):
        entries = [{} for _ in layers]

        def body(x, layers=layers, entries=entries):
            for (_, kind, p), entry in zip(layers, entries):
                x, _ = _apply_block(p, kind, x, positions, cfg, enc_out, kv_out=entry, seq=seq,
                                    sp=sp)
            return x

        x = _checkpointed(body, "full", x) if repeat and remat else body(x)
        for ((where, key, _), kind, _), entry in zip(layers, entries):
            if seq is not None or slots is not None:
                _cache_block(entry, kind, slots)
            if where == "blocks":
                stacked.setdefault(key, []).append(entry)
            else:
                rem.append(entry)
    cache = {"blocks": {key: {name: torch.stack([e[name] for e in entries])
                              for name in entries[0]}
                        for key, entries in stacked.items()},
             "rem": tuple(rem)}
    last = x[:, -1:]
    for across in (sp, seq):
        if across is not None:
            last = comm.all_gather_dim(last.contiguous(), across.axis, 1)[:, -1:]
    h = L.rmsnorm(_full(params, "final_norm.scale"), last, cfg.norm_eps)
    return _logits(params, h, cfg)[:, 0], cache


def _cache_block(entry: dict, kind: str, slots) -> None:
    """A prefill's cache entry, in place, on a rank of a split serving call:
    a full-attention layer's ``k`` / ``v`` (B, S', heads, hd) cut to the
    rank's block of ``slots`` (positions ``[start, stop)``, zeros past S'),
    every position where ``slots`` is None; each a copy, not a view of the
    gathered keys and values."""
    for name in ("k", "v"):
        if name not in entry:
            continue
        t = entry[name]
        if slots is None or _parse_kind(kind)[0] == "swa":
            entry[name] = t.clone()
            continue
        out = t.new_zeros((t.shape[0], slots.n) + tuple(t.shape[2:]))
        part = t[:, slots.start:slots.stop]
        out[:, :part.shape[1]] = part
        entry[name] = out


def _decode_block(p, kind: str, entry: dict, x, pos: int, cfg, slots=None):
    """One token through one block at absolute position ``pos``: RoPE there,
    its key and value written into the cache, attention over the positions
    it sees.  A full-attention layer writes slot ``pos`` and sees slots
    ``<= pos``; a ``swa`` layer's ring of w slots holds position p at slot
    ``p % w``, and slot i holds the latest position ``i + w * floor((pos -
    i) / w)``, valid when that is ``>= 0`` (the reference's mask).  An
    ``xattn`` layer then attends over its cached ``kx`` / ``vx``.  A
    recurrent layer steps its state (``layers.mamba2_decode`` /
    ``rglru_decode``) and copies the new one into its entry's views."""
    mixer, ffn = _parse_kind(kind)
    h = L.rmsnorm(p("ln1.scale"), x, cfg.norm_eps)
    if mixer in RECURRENT:
        step = L.mamba2_decode if mixer == "ssm" else L.rglru_decode
        out, new = step(_mixer_params(p, mixer, cfg), entry, h[:, 0], cfg)
        for name, value in new.items():
            entry[name].copy_(value)
        return _ffn_residual(p, ffn, x + out[:, None], cfg)[0]
    positions = torch.arange(pos, pos + 1, device=x.device)
    q, k, v = L.attn_qkv(p("attn.wq"), p("attn.wk"), p("attn.wv"), h, positions, cfg)
    x = x + L.attn_proj_out(p("attn.wo"), _cache_attend(entry, mixer, q, k, v, pos, slots))
    if mixer == "xattn":
        x = _cross_residual(p, x, entry["kx"], entry["vx"], cfg)
    return _ffn_residual(p, ffn, x, cfg)[0]


def _cache_attend(entry: dict, mixer: str, q, k, v, pos: int, slots=None):
    """One token's key and value written into its slot of the entry's
    ``k`` / ``v`` and its query attended over the valid slots
    (:func:`_decode_block`'s full-attention slots or ``swa`` ring).
    ``slots``: a full-attention layer's slots over the rank's data group,
    the entry its block: slot ``pos`` written on the rank that holds it,
    the query attended over every rank's valid slots through the combine
    of ``layers.split_decode_attention``."""
    n_slots = entry["k"].shape[1]
    idx = torch.arange(n_slots, device=q.device)
    if slots is not None and mixer != "swa":
        if slots.start <= pos < slots.stop:
            entry["k"][:, pos - slots.start:pos - slots.start + 1].copy_(k)
            entry["v"][:, pos - slots.start:pos - slots.start + 1].copy_(v)
        return L.split_decode_attention(q, entry["k"], entry["v"], idx + slots.start <= pos,
                                        slots.axis)
    if mixer == "swa":
        slot = pos % n_slots
        valid = idx + n_slots * torch.div(pos - idx, n_slots, rounding_mode="floor") >= 0
    else:
        slot = pos
        valid = idx <= pos
    entry["k"][:, slot:slot + 1].copy_(k)
    entry["v"][:, slot:slot + 1].copy_(v)
    return L.decode_attention(q, entry["k"], entry["v"], valid)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int, cfg,
                unroll: bool = False, slots=None):
    """tokens: (B,) ids; pos: the Python int position they take.  Returns
    (f32 logits (B, padded vocab), cache).  Unlike the reference, which
    returns a new cache, the keys, values and recurrent states are written
    into ``cache`` in place and the same dict is returned; nothing is read
    back to the host but a MoE layer's group sizes (``layers.moe_apply``).
    ``unroll`` is a no-op (:func:`hidden_states`).  On a serving rank: its
    rows, its cache (:func:`init_cache`'s ``layout``) and, where
    :func:`logits_split`, its vocab block of the logits, as :func:`prefill`;
    ``slots``: its cache's full-attention blocks over data, as
    :func:`init_cache`'s (:func:`_cache_attend`)."""
    check_supported(cfg)
    params = serving_params(params, cfg)
    block = _tp_decode_block if _model_split(params) else _decode_block
    x = _embed(params, tokens[:, None], cfg)
    for where, kind, p in _layers(params, cfg):
        x = block(p, kind, _cache_entry(cache, where), x, pos, cfg, slots)
    h = L.rmsnorm(_full(params, "final_norm.scale"), x, cfg.norm_eps)
    return _logits(params, h, cfg)[:, 0], cache


def _mamba2_final_state(p: dict, h: torch.Tensor, cfg) -> dict:
    """The reference's ``_mamba2_final_state``: the cache entry of an
    ``ssm`` block after a prompt, from its ``ssm`` leaves ``p`` (nested as
    the reference's) and its normed input h (B, S, d): ``{"state": (B, H,
    P, N) f32, "conv": (B, width - 1, d_inner + 2N)}``.  The state comes
    in closed form (``layers._ssd_final_state``) where the reference scans
    every position; the conv tail is zero-padded on the left for a prompt
    shorter than width - 1."""
    out: dict = {}
    L.mamba2_apply(p, h, cfg, state_out=out)
    return out


def _rglru_final_state(p: dict, h: torch.Tensor, cfg) -> dict:
    """The reference's ``_rglru_final_state``: ``{"h": (B, d_rnn) f32,
    "conv": (B, width - 1, d_rnn)}`` of an ``rglru`` block after a prompt,
    from its ``rglru`` leaves and normed input h (B, S, d); the conv tail
    zero-padded as in :func:`_mamba2_final_state`."""
    out: dict = {}
    L.rglru_apply(p, h, cfg, state_out=out)
    return out
