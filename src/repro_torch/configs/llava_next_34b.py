"""Architecture config: LLaVA-NeXT-34B backbone — VLM, vision tower STUBBED (anyres patches)
Source: hf:llava-hf/llava-v1.6-mistral-7b-hf (34B per assignment)
"""

from repro_torch.configs.base import ModelConfig, TopologyConfig

FULL = ModelConfig(
    name="llava_next_34b", family="vlm", n_layers=60, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=20480, vocab_size=64000, head_dim=128,
    pattern=("attn:dense",), n_patches=2880,  # anyres: 5 tiles x 576
    mlp_gated=True, act="silu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llava_smoke", family="vlm", n_layers=2, d_model=256, n_heads=8,
    n_kv_heads=2, d_ff=512, vocab_size=1000, head_dim=32,
    pattern=("attn:dense",), n_patches=16,
    mlp_gated=True, act="silu", tie_embeddings=False,
    dtype="float32", param_dtype="float32",
)

TOPO = TopologyConfig(n_workers_single=4, n_workers_multi=8, grad_accum=8)
