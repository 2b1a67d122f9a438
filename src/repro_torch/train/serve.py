"""Batched serving: prefill a prompt batch, then autoregressive decode.

The reference's ``train/serve.py`` for every mixer, with the encdec model's
frames or the VLM's patches in ``extra_batch``.  Prefill builds a cache of
the prefilled length, ``n_prefix + S`` (the VLM's patches, then the prompt;
a ``swa`` layer's last ``window`` positions), which is spliced into a zero
cache of ``n_prefix + S + max_new_tokens`` positions (a ring of ``window``
slots for ``swa``); an ``xattn`` layer's encoder keys and values ``kx`` /
``vx`` and a recurrent layer's state (``ssm``: the SSD state and the conv's
last inputs; ``rglru``: h and the conv's last inputs) copy through.  Each
decode step then writes one slot in place, at position ``n_prefix + S +
i``, and steps each recurrent state in place.

The reference's recurrent prefill keeps only the S conv inputs of a prompt
shorter than the conv's width - 1 (3), and its decode then raises on the
short window; the port left-pads them with zeros, the state its causal
conv implies.  A Mamba-2 prompt longer than 128 tokens must be a multiple
of 128 in both packages (the SSD's chunk).  The decode loop reads nothing back to the host but each MoE layer's
group sizes: positions are Python ints and the tokens stay on the device
until the end.

The reference sizes the cache ``S + max_new_tokens`` whatever the prefix
(``src/repro/train/serve.py:30``), so a VLM's prefill overruns it: its
splice raises when ``max_new_tokens < n_patches``, and otherwise its decode
writes past the cache's end (a clamped slot) from step ``max_new_tokens -
n_patches`` on.  The port sizes the cache to hold every position it writes.

    PYTHONPATH=src python -c "
    import torch
    from repro_torch.configs.nano import NANO
    from repro_torch.models import init_params
    from repro_torch.train.serve import generate
    params = init_params(torch.Generator().manual_seed(0), NANO)
    prompt = torch.randint(0, NANO.vocab_size, (2, 16))
    print(generate(params, NANO, prompt, max_new_tokens=8, device='cpu'))"
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.groups import Groups, each
from repro_torch.models import transformer as T


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def generate(
    params,
    cfg,
    prompt_tokens,                       # (B, S_prompt) ids
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    rng: Optional[torch.Generator] = None,
    extra_batch: Optional[dict] = None,  # {"frames": ...} (encdec) / {"patches": ...} (vlm)
    device="cuda",
):
    """Greedy (or temperature) decoding.  Returns (tokens (B, new) int64 on
    ``device``, stats with ``prefill_s``, ``decode_s`` and ``tok_per_s``).

    ``params``: the flat ``(N,)`` buffers of ``cfg``'s layout (a tensor, or
    the :class:`~repro_torch.groups.Groups` of a mixed-dtype model) or a ``{path:
    tensor}`` dict of its views; moved to ``device`` if they lie elsewhere.
    Temperature sampling draws Gumbel noise from ``rng``, a
    ``torch.Generator`` on ``device`` (default seeded 0): the same
    distribution as the reference's ``jax.random.categorical``, not its
    random numbers.  On the card the clock is read after
    ``torch.cuda.synchronize``.  ``extra_batch``: the rest of the
    reference's batch dict, an encdec model's ``frames`` (B, enc_len,
    d_model) or a VLM's ``patches`` (B, n_patches, d_model), moved to
    ``device``.
    """
    T.check_supported(cfg)
    dev = torch.device(device)
    if isinstance(params, (torch.Tensor, Groups)):
        params = T.layout(cfg).views(each(lambda t: t.to(dev), params))
    else:
        params = {k: v.to(dev) for k, v in params.items()}
    prompt = torch.as_tensor(prompt_tokens, dtype=torch.long).to(dev)
    batch = {"tokens": prompt, **{k: torch.as_tensor(v).to(dev)
                                  for k, v in (extra_batch or {}).items()}}
    B, S = prompt.shape
    n_prefix = batch["patches"].shape[1] if cfg.family == "vlm" else 0
    start = n_prefix + S                 # the first decoded position
    max_len = start + max_new_tokens

    with torch.no_grad():
        t0 = _clock(dev)
        logits, pcache = T.prefill(params, batch, cfg, remat=False)
        cache = T.init_cache(cfg, B, max_len, cfg.act_dtype, device=dev)
        cache = _splice_cache(cache, pcache, cfg, start)
        del pcache
        prefill_s = _clock(dev) - t0

        rng = rng if rng is not None else torch.Generator(device=dev).manual_seed(0)

        def pick(logits):
            logits = logits[:, : cfg.vocab_size]
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1)
            u = torch.rand(logits.shape, generator=rng, dtype=torch.float32, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
            return torch.argmax(logits / temperature + gumbel, dim=-1)

        tok = pick(logits)
        out = [tok]
        t0 = _clock(dev)
        for i in range(max_new_tokens - 1):
            logits, cache = T.decode_step(params, cache, tok, start + i, cfg)
            tok = pick(logits)
            out.append(tok)
        decode_s = _clock(dev) - t0
    return torch.stack(out, dim=1), {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "tok_per_s": (max_new_tokens - 1) * B / max(decode_s, 1e-9),
    }


def _splice_cache(big: dict, small: dict, cfg, prompt_len: int) -> dict:
    """Copy a prefill cache into a longer decode cache, in the big leaf's
    dtype.  A full-attention key/value leaf is the prefill's, zero-padded
    at the end of its sequence axis; a ``swa`` leaf is a ring (position p
    at slot ``p % w_big``) that prefill gave its last ``w_small`` positions
    in order, so it is padded and then rolled by ``(prompt_len - w_small) %
    w_big``; the cross-attention's ``kx`` / ``vx`` and the recurrent states
    copy through.
    ``prompt_len`` is the prefilled length (a VLM's patches included)."""
    T.check_supported(cfg)

    def splice_leaf(kind, name, big_leaf, small_leaf):
        mixer = kind.split(":")[0]
        ring = mixer == "swa"
        if (mixer in T.RECURRENT or name in ("kx", "vx")
                or (big_leaf.shape == small_leaf.shape and not ring)):
            return small_leaf.to(big_leaf.dtype)
        ax = big_leaf.dim() - 3  # seq axis of (..., S, kvh, hd)
        w_big, w_small = big_leaf.shape[ax], small_leaf.shape[ax]
        out = torch.zeros_like(big_leaf)
        out.narrow(ax, 0, w_small).copy_(small_leaf)
        if ring:
            out = torch.roll(out, (prompt_len - w_small) % w_big, dims=ax)
        return out

    def splice_entry(kind, big_e, small_e):
        return {name: splice_leaf(kind, name, big_e[name], small_e[name]) for name in big_e}

    return {"blocks": {key: splice_entry(cfg.pattern[int(key[1:])], big["blocks"][key],
                                         small["blocks"][key])
                       for key in big["blocks"]},
            "rem": tuple(splice_entry(cfg.pattern[i], b, s)
                         for i, (b, s) in enumerate(zip(big["rem"], small["rem"])))}
