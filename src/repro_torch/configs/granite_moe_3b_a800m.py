"""Architecture config: Granite-3.0 MoE 3B-a800M — 40 experts top-8, d_ff=512/expert
Source: hf:ibm-granite/granite-3.0-1b-a400m-base (scaled per assignment)
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

FULL = ModelConfig(
    name="granite_moe_3b_a800m", family="lm", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49155, head_dim=64,
    pattern=("attn:moe",), n_experts=40, top_k=8,
    mlp_gated=True, act="silu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite_moe_smoke", family="lm", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab_size=1000, head_dim=32,
    pattern=("attn:moe",), n_experts=4, top_k=2,
    mlp_gated=True, act="silu", tie_embeddings=True,
    dtype="float32", param_dtype="float32",
)

TOPO = TopologyConfig(n_workers_single=16, n_workers_multi=32, grad_accum=1)
