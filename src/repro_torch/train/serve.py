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

On a rank of the ``(data, model)`` serving grid (``topo``, from
``distributed.mesh.serving_topology``) ``generate`` takes the rank's params
(its blocks: ``tensor_parallel.topology_layout``) and the whole prompt
batch, serves its data row's rows (``tensor_parallel.serve_rows``) from its
cache, picks each token over the model group (``vocab_argmax`` where the
logits are the rank's vocab block) and gathers the rows' tokens over the
data group: every rank returns the whole batch's tokens.  Where the batch
does not split over data (B % D or B < D; ``tensor_parallel.serve_split``)
every data row serves the whole batch: the prefill runs the rank's chunk of
the prompt's positions (where they divide into D), each full-attention
layer's cache holds the rank's block of its slots (where they divide), a
decode step combines the blocks' attention over data, and every data rank
holds the same logits, so the tokens need no gather.

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

from repro_torch.distributed import comm
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.groups import Groups, each
from repro_torch.models import transformer as T
from repro_torch.models.convert import ShardedParams


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
    topo=None,
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

    ``topo``: a serving rank's topology (``mesh.serving_topology``); the
    params are then the rank's blocks (its flat buffers or its
    ``ShardedParams``) and every rank passes the same whole batch.  Each
    token is the vocab-parallel argmax over the model group where the
    logits are the rank's vocab block, with the rank's Gumbel noise for
    its block from ``rng``, by default ``tensor_parallel.noise_generator(0,
    model index)`` (pass ``noise_generator(seed, topo.model_index, device)``
    for another seed); where the logits are whole on every rank, the dense
    pick with ``noise_generator(0, 0)``.  Each pick draws the whole batch's
    ``(B, block)`` noise and keeps the rank's rows, so every row of the
    batch has noise of its own and the tokens do not depend on the data
    split.  The stats are the rank's."""
    T.check_supported(cfg)
    dev = torch.device(device)
    params = T.serving_params(_device_params(params, cfg, topo, dev), cfg)
    prompt = torch.as_tensor(prompt_tokens, dtype=torch.long).to(dev)
    batch = {"tokens": prompt, **{k: torch.as_tensor(v).to(dev)
                                  for k, v in (extra_batch or {}).items()}}
    rows = TP.serve_rows(prompt.shape[0], topo)
    batch = {k: v[rows] for k, v in batch.items()}
    B, S = batch["tokens"].shape
    n_prefix = batch["patches"].shape[1] if cfg.family == "vlm" else 0
    start = n_prefix + S                 # the first decoded position
    max_len = start + max_new_tokens
    # where the batch does not split over data: the prompt's positions and
    # the full-attention caches' slots over data, where they divide
    place = () if topo is None else (topo.worker, topo.worker_index, topo.data)
    seq, slots = TP.serve_split(prompt.shape[0], start, max_new_tokens, cfg, *place)
    split = topo is not None and T.logits_split(params, cfg)
    rank_layout = params.layout if isinstance(params, ShardedParams) else None

    with torch.no_grad():
        t0 = _clock(dev)
        logits, pcache = T.prefill(params, batch, cfg, remat=False, seq=seq, slots=slots)
        cache = T.init_cache(cfg, B, max_len, cfg.act_dtype, device=dev, layout=rank_layout,
                             slots=slots)
        cache = _splice_cache(cache, pcache, cfg, start)
        del pcache
        prefill_s = _clock(dev) - t0

        if temperature > 0.0 and rng is None:
            rng = (torch.Generator(device=dev).manual_seed(0) if topo is None else
                   TP.noise_generator(0, topo.model_index if split else 0, dev))

        def pick(logits):
            if not split:
                logits = logits[:, : cfg.vocab_size]
            if temperature > 0.0:
                # the whole batch's noise for this vocab block, the rank's
                # rows cut from it: every row of the batch draws its own
                noise = gumbel((prompt.shape[0], logits.shape[-1]), rng, dev)[rows]
                logits = logits / temperature + noise
            if split:
                return TP.vocab_argmax(logits, topo.mp, cfg.vocab_size)
            return torch.argmax(logits, dim=-1)

        tok = pick(logits)
        out = [tok]
        t0 = _clock(dev)
        for i in range(max_new_tokens - 1):
            logits, cache = T.decode_step(params, cache, tok, start + i, cfg, slots=slots)
            tok = pick(logits)
            out.append(tok)
        decode_s = _clock(dev) - t0
    toks = torch.stack(out, dim=1)
    if topo is not None and rows.stop - rows.start < prompt.shape[0]:
        toks = comm.all_gather_dim(toks, topo.data, 0)
    return toks, {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "tok_per_s": (max_new_tokens - 1) * B / max(decode_s, 1e-9),
    }


def gumbel(shape, rng: torch.Generator, dev) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` (f32) from ``rng``'s uniforms."""
    u = torch.rand(shape, generator=rng, dtype=torch.float32, device=dev)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _device_params(params, cfg, topo, dev):
    """``params`` as ``{path: view}`` on ``dev``: a serving rank's as its
    ``ShardedParams`` (``tensor_parallel.topology_layout``)."""
    if isinstance(params, ShardedParams):
        return params.replace({k: v.to(dev) for k, v in params.items()})
    if isinstance(params, (torch.Tensor, Groups)):
        lay = TP.topology_layout(cfg, topo) if topo is not None else T.layout(cfg)
        return lay.views(each(lambda t: t.to(dev), params))
    if topo is not None and topo.model > 1:
        raise TypeError("a serving rank's params are its flat buffers or its ShardedParams "
                        "(a plain dict holds no rank layout)")
    return {k: v.to(dev) for k, v in params.items()}


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
