"""Architecture config: Minitron-4B (pruned Nemotron) — dense GQA
Source: arXiv:2407.14679
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

FULL = ModelConfig(
    name="minitron_4b", family="lm", n_layers=32, d_model=3072, n_heads=24,
    n_kv_heads=8, d_ff=9216, vocab_size=256000, head_dim=128,
    pattern=("attn:dense",), mlp_gated=True, act="silu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="minitron_4b_smoke", family="lm", n_layers=2, d_model=256, n_heads=8,
    n_kv_heads=2, d_ff=512, vocab_size=1000, head_dim=32,
    pattern=("attn:dense",), mlp_gated=True, act="silu", tie_embeddings=False,
    dtype="float32", param_dtype="float32",
)

TOPO = TopologyConfig(n_workers_single=16, n_workers_multi=32, grad_accum=1)
