"""Input specs of the port: ``meta`` tensors standing in for every model
input, the reference's ``ShapeDtypeStruct`` specs (``configs/specs.py``).

A ``meta`` tensor has a shape, a dtype and strides and allocates nothing;
the dry-run (``repro_torch.launch.dryrun``) runs the model on them.  The
audio and VLM front ends are stubs, as in the reference: the specs give
precomputed frame or patch embeddings at ``d_model``.  Token ids are int32,
the reference's spec; the port's trainer feeds them as int64
(``run_training``), and so does the dry-run.  The reference's asserts are
``ValueError``s with the same conditions.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig, TopologyConfig
from repro_torch.models import transformer as T

META = "meta"


def _spec(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, lead: tuple, seq_len: int) -> dict:
    """The batch dict of ``cfg``'s family with leading dims ``lead``: int32
    tokens, with a ``vlm``'s patches before ``seq_len - n_patches`` tokens
    or an ``encdec``'s frames beside ``seq_len`` tokens."""
    act = cfg.act_dtype
    if cfg.family == "vlm":
        return {"tokens": _spec(lead + (seq_len - cfg.n_patches,), torch.int32),
                "patches": _spec(lead + (cfg.n_patches, cfg.d_model), act)}
    if cfg.family == "encdec":
        return {"tokens": _spec(lead + (seq_len,), torch.int32),
                "frames": _spec(lead + (cfg.enc_len, cfg.d_model), act)}
    return {"tokens": _spec(lead + (seq_len,), torch.int32)}


def train_batch_specs(cfg: ModelConfig, topo: TopologyConfig, shape: InputShape,
                      n_workers: int) -> dict:
    """Batch dict of one DSM outer step: leaves (W, tau, accum, B_micro, ...)."""
    if shape.kind != "train":
        raise ValueError(f"{shape.name} is a {shape.kind} shape, not a train shape")
    W, tau, acc = n_workers, topo.tau, topo.grad_accum
    if shape.global_batch % (W * acc):
        raise ValueError((cfg.name, shape.name, W, acc))
    bm = shape.global_batch // (W * acc)
    return batch_specs(cfg, (W, tau, acc, bm), shape.seq_len)


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    if shape.kind != "prefill":
        raise ValueError(f"{shape.name} is a {shape.kind} shape, not a prefill shape")
    return batch_specs(cfg, (shape.global_batch,), shape.seq_len)


def decode_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """tokens + pos + the cache sized to seq_len (the spec'd cache length)."""
    if shape.kind != "decode":
        raise ValueError(f"{shape.name} is a {shape.kind} shape, not a decode shape")
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _spec((B,), torch.int32), "pos": _spec((), torch.int32),
            "cache": T.init_cache(cfg, B, S, cfg.act_dtype, device=META)}


def abstract_params(cfg: ModelConfig) -> dict:
    """``{path: meta view}`` of the layout, each leaf in its dtype and shape
    (stacked blocks with their leading layer axis); allocates nothing."""
    lay = T.layout(cfg)
    return lay.views(lay.empty(device=META))


def param_count(cfg: ModelConfig) -> int:
    """The leaves of the reference's ``init_params`` tree, over every dtype
    group; ``ValueError`` for a family or block kind that the reference
    does not build either."""
    return T.layout(cfg).numel


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k + shared experts only)."""
    total = param_count(cfg)
    if cfg.n_experts == 0:
        return total
    n_moe_layers = sum(1 for k in cfg.layer_kinds() if k.endswith(":moe"))
    per_expert = (2 + int(cfg.mlp_gated)) * cfg.d_model * cfg.d_ff
    return total - n_moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
