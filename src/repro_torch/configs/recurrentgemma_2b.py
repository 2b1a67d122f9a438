"""Architecture config: RecurrentGemma-2B — hybrid RG-LRU + local attention (2:1)
Source: arXiv:2402.19427
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

FULL = ModelConfig(
    name="recurrentgemma_2b", family="lm", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000, head_dim=256,
    pattern=("rglru:dense", "rglru:dense", "swa:dense"), window=2048,
    rnn_width=2560, mlp_gated=True, act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma_smoke", family="lm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=1, d_ff=256, vocab_size=1000, head_dim=32,
    pattern=("rglru:dense", "swa:dense"), window=16, rnn_width=128,
    mlp_gated=True, act="gelu", tie_embeddings=True,
    dtype="float32", param_dtype="float32",
)

TOPO = TopologyConfig(
    n_workers_single=16, n_workers_multi=32, grad_accum=1,
    supports_long_context=True,  # RG-LRU state + 2048-window attention cache
)
