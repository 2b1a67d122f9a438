"""Architecture config: Gemma-3 1B — 5:1 local(sliding-window):global attention, kv=1
Source: hf:google/gemma-3-1b-pt
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

FULL = ModelConfig(
    name="gemma3_1b", family="lm", n_layers=26, d_model=1152, n_heads=4,
    n_kv_heads=1, d_ff=6912, vocab_size=262144, head_dim=256,
    pattern=("swa:dense",) * 5 + ("attn:dense",), window=512,
    mlp_gated=True, act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3_smoke", family="lm", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=1, d_ff=256, vocab_size=1000, head_dim=32,
    pattern=("swa:dense", "attn:dense"), window=16,
    mlp_gated=True, act="gelu", tie_embeddings=True,
    dtype="float32", param_dtype="float32",
)

TOPO = TopologyConfig(
    n_workers_single=16, n_workers_multi=32, grad_accum=1,
    supports_long_context=True,  # 5/6 layers sliding-window; global-KV @512k = 2.1GB
)
