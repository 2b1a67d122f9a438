"""Architecture config: GPT-2 large (paper Table 1; peak LR 0.0002)
Source: Radford et al. 2019 / paper Table 1
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

PEAK_LR = 0.0002

FULL = ModelConfig(
    name="gpt2_large", family="lm", n_layers=36, d_model=1280, n_heads=20,
    n_kv_heads=20, d_ff=5120, vocab_size=50257, head_dim=64,
    pattern=("attn:dense",), mlp_gated=False, act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gpt2_large_smoke", family="lm", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=512, vocab_size=1000, head_dim=32,
    pattern=("attn:dense",), mlp_gated=False, act="gelu", tie_embeddings=True,
    dtype="float32", param_dtype="float32",
)

TOPO = TopologyConfig(n_workers_single=8, n_workers_multi=16, grad_accum=1)
