"""Model architecture and training topology configs.

A copy of the reference's ``ModelConfig`` / ``TopologyConfig`` fields (the
port keeps its own copy: the reference module imports ``jax.numpy`` for its
dtype properties).  ``act_dtype`` and ``p_dtype`` return torch dtypes.

``pattern`` is a repeating tuple of ``"<mixer>:<ffn>"`` strings; layers are
the pattern tiled to ``n_layers``.  Full repeats are stored stacked on a
leading layer axis, the remainder unrolled.  The port builds every mixer
and FFN of the reference; an unknown one raises ``ValueError``.

Every arch id of the reference has a module ``repro_torch.configs.<id>``
with ``FULL`` and ``SMOKE`` ModelConfigs and a ``TOPO`` TopologyConfig (the
paper's GPT-2 sizes also a ``PEAK_LR``), copied field for field.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # "lm" | "encdec" | "vlm"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    pattern: Tuple[str, ...] = ("attn:dense",)
    window: int = 1024               # sliding-window size for "swa"
    mlp_gated: bool = True           # SwiGLU vs plain 2-matrix MLP
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_combine: str = "scatter"
    moe_impl: str = "ragged"
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # RG-LRU
    rnn_width: Optional[int] = None
    # enc-dec (audio)
    enc_layers: int = 0
    enc_len: int = 1500
    # VLM
    n_patches: int = 0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"          # activations
    param_dtype: str = "bfloat16"
    vocab_pad_to: int = 512          # pad vocab so the table shards evenly
    q_block: int = 1024              # blockwise-attention query tile
    attn_seq_shard: bool = False     # constrain attention activations to
                                     # sequence-sharding over the model axis:
                                     # a model rank holds its block of the
                                     # sequence (tensor_parallel.seq_shard)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def act_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def d_inner(self) -> int:        # Mamba-2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def d_rnn(self) -> int:
        return self.rnn_width if self.rnn_width is not None else self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    @property
    def n_scan_blocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_rem_layers(self) -> int:
        return self.n_layers % len(self.pattern)


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """How this arch maps onto the production mesh for training."""

    n_workers_single: int = 16
    n_workers_multi: int = 32
    grad_accum: int = 1
    base_opt: str = "adamw"
    momentum_dtype: str = "float32"
    tau: int = 12
    remat: bool = True
    remat_policy: str = "full"
    attn_tp: bool = True         # False: replicate attention weights over the
                                 # model axis (dryrun.ATTN_NAMES held whole)
    supports_long_context: bool = False


# ---------------------------------------------------------------------------
# Input shapes and arch ids (the reference's registry)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


ARCH_IDS = (
    "minitron_4b",
    "granite_moe_3b_a800m",
    "gemma3_1b",
    "granite_34b",
    "whisper_large_v3",
    "llava_next_34b",
    "deepseek_67b",
    "mamba2_780m",
    "llama4_maverick_400b_a17b",
    "recurrentgemma_2b",
)

PAPER_ARCH_IDS = ("gpt2_small", "gpt2_medium", "gpt2_large")


def load_arch(arch_id: str):
    """Returns the config module for an arch id (exposes FULL, SMOKE, TOPO)."""
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def arch_supports_shape(cfg: ModelConfig, topo: TopologyConfig, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return topo.supports_long_context
    return True
