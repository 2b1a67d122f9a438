"""Serving example on the PyTorch port: train a byte-level model on this
repo's own source code with DSM, then serve batched greedy completions
through the production decode path (prefill + KV-cache ``decode_step``).

Run:  PYTHONPATH=src python examples/torch_serve_model.py
      (``--device cpu`` without a card; ``--steps`` outer steps, 40 by default)
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import TextCorpus
from repro_torch.train.serve import generate
from repro_torch.train.trainer import TrainSettings, run_training

ROOT = Path(__file__).resolve().parent.parent     # the repository: src/**/*.py
CFG = ModelConfig(
    name="bytelm", family="lm", n_layers=3, d_model=96, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=256, head_dim=24,
    pattern=("swa:dense", "swa:dense", "attn:dense"), window=64,
    dtype="float32", param_dtype="float32", vocab_pad_to=256,
)
PROMPTS = [b"def make_", b"import ja", b"class Mod", b"    return"]
NEW_TOKENS = 24


def settings(steps: int = 40) -> TrainSettings:
    return TrainSettings(algorithm="dsm", n_workers=2, tau=8, steps=steps,
                         b_micro=8, seq=192, peak_lr=1e-2, warmup=6,
                         global_lr=0.3, eval_every=10)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    corpus = TextCorpus(root=str(ROOT), pattern="src/**/*.py")
    print("training byte-level LM on the repository's own source ...")
    r = run_training(CFG, settings(args.steps), corpus, log=print, device=args.device)
    params = r["state"].x0

    width = max(len(p) for p in PROMPTS)
    batch = np.stack([np.frombuffer(p.rjust(width, b" "), dtype=np.uint8).astype(np.int64)
                      for p in PROMPTS])
    toks, stats = generate(params, CFG, torch.from_numpy(batch), max_new_tokens=NEW_TOKENS,
                           device=args.device)
    print(f"\nbatched decode: {stats['tok_per_s']:.1f} tok/s "
          f"(prefill {stats['prefill_s']:.2f}s)")
    completions = []
    for p, t in zip(PROMPTS, toks.cpu().numpy()):
        completions.append(bytes(int(x) % 256 for x in t).decode("latin1"))
        print(f"  {p.decode():>12s} -> {completions[-1]!r}")
    return {"final_eval": r["final_eval"], "history": r["history"], "tokens": toks.cpu(),
            "completions": completions, **stats}


if __name__ == "__main__":
    main()
