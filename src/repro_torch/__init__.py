"""PyTorch/CUDA port of the DSM training system (Algorithm 1 with AdamW
local steps) for one NVIDIA Hopper card.

The JAX package ``repro`` is the reference; this package imports none of it
and no JAX.  The global sign-momentum step and the AdamW local step run as
hand-written CUDA kernels on the card (``repro_torch.kernels``); on CPU
tensors their plain PyTorch versions run instead.
"""
