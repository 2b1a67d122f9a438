"""Architecture config: Llama-4 Maverick 400B-a17B — interleaved MoE
(128e top-1 + shared experts), early fusion
Source: hf:meta-llama/Llama-4-Scout-17B-16E (Maverick per assignment)
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

FULL = ModelConfig(
    name="llama4_maverick_400b_a17b", family="lm", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab_size=202048, head_dim=128,
    pattern=("attn:dense", "attn:moe"), n_experts=128, top_k=1,
    n_shared_experts=1, mlp_gated=True, act="silu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama4_smoke", family="lm", n_layers=2, d_model=256, n_heads=8,
    n_kv_heads=2, d_ff=256, vocab_size=1000, head_dim=32,
    pattern=("attn:dense", "attn:moe"), n_experts=4, top_k=1,
    n_shared_experts=1, mlp_gated=True, act="silu", tie_embeddings=False,
    dtype="float32", param_dtype="float32",
)

# 400B params: even fully sharded over one pod, AdamW moments do not fit
# (see DESIGN.md) -> SGD base optimizer, bf16 global momentum, W=1 single-pod
# (signed-Lookahead instance of Algorithm 1) / W=2 multi-pod.
TOPO = TopologyConfig(
    n_workers_single=1, n_workers_multi=2, grad_accum=16, base_opt="sgd", momentum_dtype="bfloat16",
)
