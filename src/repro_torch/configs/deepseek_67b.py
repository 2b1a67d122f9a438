"""Architecture config: DeepSeek-67B — dense llama-arch GQA
Source: arXiv:2401.02954
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

FULL = ModelConfig(
    name="deepseek_67b", family="lm", n_layers=95, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22016, vocab_size=102400, head_dim=128,
    pattern=("attn:dense",), mlp_gated=True, act="silu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek_smoke", family="lm", n_layers=2, d_model=256, n_heads=8,
    n_kv_heads=2, d_ff=512, vocab_size=1000, head_dim=32,
    pattern=("attn:dense",), mlp_gated=True, act="silu", tie_embeddings=False,
    dtype="float32", param_dtype="float32",
)

TOPO = TopologyConfig(n_workers_single=2, n_workers_multi=4, grad_accum=16)
