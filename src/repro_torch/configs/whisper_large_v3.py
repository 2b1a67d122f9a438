"""Architecture config: Whisper-large-v3 backbone — enc-dec, conv/mel frontend STUBBED
Source: arXiv:2212.04356
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

FULL = ModelConfig(
    name="whisper_large_v3", family="encdec", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120, vocab_size=51866, head_dim=64,
    pattern=("xattn:dense",), enc_layers=32, enc_len=1500,
    mlp_gated=False, act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper_smoke", family="encdec", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab_size=1000, head_dim=32,
    pattern=("xattn:dense",), enc_layers=2, enc_len=64,
    mlp_gated=False, act="gelu", tie_embeddings=True,
    dtype="float32", param_dtype="float32",
)

TOPO = TopologyConfig(n_workers_single=16, n_workers_multi=32, grad_accum=1)
