"""The sequence model (decoder LM, encoder-decoder, VLM), its layers and the
flat parameter layout."""

from repro_torch.models.transformer import (
    decode_step,
    hidden_states,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)
