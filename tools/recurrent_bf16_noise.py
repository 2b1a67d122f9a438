"""Where a bf16 recurrent model's decode-vs-full-forward gap comes from.

A recurrent arch at full width and a chosen depth, random init from a seed,
bf16 parameters and activations: prefill a prompt, decode greedy tokens,
then one full forward over prompt + tokens (causal, so each position's
logits are the teacher-forced ones), and one full forward of the same
model in f32.  Prints, per decode step, the largest |logit| gap of the
decode against the bf16 full forward, of the decode against the f32 model,
and of the bf16 full forward against the f32 model: when the last two are
alike, the decode's gap is the bf16 model's own noise, not a fault of the
decode path.  ``--f32-conv`` makes the forward's causal conv accumulate in
f32, as the decode's one-token conv step does (the reference's forward conv
rounds each product and sum to the activation dtype).

    PYTHONPATH=src python tools/recurrent_bf16_noise.py --arch mamba2_780m \\
        --layers 48 --prompt 512 --new 24          # ~30 s, ~6 GB, CPU

Runs on the CPU unless ``--device cuda`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import load_arch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.serve import _splice_cache


def full_logits(params, cfg, seq, start: int, n: int):
    """Logits at positions start .. start + n - 1 of one forward over seq,
    padded on the right to a multiple of 128 for Mamba-2's SSD."""
    pad = (-seq.shape[1]) % 128 if seq.shape[1] > 128 else 0
    seq = torch.cat([seq, seq.new_zeros(seq.shape[0], pad)], dim=1)
    h = T.hidden_states(params, {"tokens": seq}, cfg)[0][:, start:start + n]
    return T._logits(params, h, cfg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_780m", choices=("mamba2_780m",
                                                              "recurrentgemma_2b"))
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f32-conv", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    if args.f32_conv:
        conv = L.conv1d_apply
        L.conv1d_apply = lambda p, x: conv({k: v.float() for k, v in p.items()},
                                           x.float()).to(x.dtype)
    cfg = dataclasses.replace(load_arch(args.arch).FULL, n_layers=args.layers)
    dev = torch.device(args.device)
    params = T.layout(cfg).views(T.init_params(torch.Generator().manual_seed(args.seed), cfg,
                                               device=dev))
    S, new, B = args.prompt, args.new, args.batch
    prompt = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(args.seed + 1)).to(dev)
    with torch.no_grad():
        logits, small = T.prefill(params, {"tokens": prompt}, cfg)
        cache = _splice_cache(T.init_cache(cfg, B, S + new, device=dev), small, cfg, S)
        decoded = [logits]
        toks = [logits[:, :cfg.vocab_size].argmax(-1)]
        for i in range(1, new):
            logits, cache = T.decode_step(params, cache, toks[-1], S + i - 1, cfg)
            decoded.append(logits)
            toks.append(logits[:, :cfg.vocab_size].argmax(-1))
        del cache
        seq = torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
        bf16 = full_logits(params, cfg, seq, S - 1, new)
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        f32 = full_logits({k: v.float() for k, v in params.items()}, cfg32, seq, S - 1, new)
    dec = torch.stack(decoded, dim=1)

    def gap(a, b):
        return [round(x, 4) for x in (a - b).abs().amax(dim=(0, 2)).tolist()]

    out = {"arch": args.arch, "layers": args.layers, "prompt": S, "new": new,
           "f32_conv": args.f32_conv, "max_abs_logit_f32": f32.abs().max().item(),
           "decode_vs_bf16_full": gap(dec, bf16), "decode_vs_f32_full": gap(dec, f32),
           "bf16_full_vs_f32_full": gap(bf16, f32)}
    for k, v in out.items():
        print(f"{k}: {v}")
    return out


if __name__ == "__main__":
    main()
