"""Architecture config: Granite-34B code — dense MQA (kv=1), non-gated GELU MLP
Source: arXiv:2405.04324
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

FULL = ModelConfig(
    name="granite_34b", family="lm", n_layers=88, d_model=6144, n_heads=48,
    n_kv_heads=1, d_ff=24576, vocab_size=49152, head_dim=128,
    pattern=("attn:dense",), mlp_gated=False, act="gelu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="granite_34b_smoke", family="lm", n_layers=2, d_model=256, n_heads=8,
    n_kv_heads=1, d_ff=512, vocab_size=1000, head_dim=32,
    pattern=("attn:dense",), mlp_gated=False, act="gelu", tie_embeddings=False,
    dtype="float32", param_dtype="float32",
)

TOPO = TopologyConfig(n_workers_single=4, n_workers_multi=8, grad_accum=8)
