"""The nano GPT the reference launcher trains by default (``--arch nano``):
2 layers, d_model 64, vocab 64, f32.  It trains with GPT-2 small's TOPO."""

from repro_torch.configs.base import ModelConfig

NANO = ModelConfig(
    name="nano_gpt", family="lm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=64, head_dim=16, mlp_gated=False,
    act="gelu", dtype="float32", param_dtype="float32", vocab_pad_to=64,
)
