"""Architecture config: Mamba-2 780M — attention-free SSD (state-space duality)
Source: arXiv:2405.21060
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

FULL = ModelConfig(
    name="mamba2_780m", family="lm", n_layers=48, d_model=1536, n_heads=24,
    n_kv_heads=24, d_ff=0, vocab_size=50280, head_dim=64,
    pattern=("ssm:none",), ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2_smoke", family="lm", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab_size=1000, head_dim=32,
    pattern=("ssm:none",), ssm_state=16, ssm_head_dim=32, ssm_expand=2,
    tie_embeddings=True, dtype="float32", param_dtype="float32",
)

TOPO = TopologyConfig(
    n_workers_single=16, n_workers_multi=32, grad_accum=1,
    supports_long_context=True,  # O(1) recurrent state
)
