"""Theory demo on the PyTorch port: the randomized sign operators (paper
eqs. 9-10) behind Theorems 1-2 -- unbiasedness E[S_r(v)] = v/B (Lemma 1) --
and DSM trained with the deterministic sign against the randomized one.

Run:  PYTHONPATH=src python examples/torch_randomized_sign_theory.py
      (``--device cpu`` without a card; ``--steps`` outer steps, 20 by default)
"""

import argparse

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import randomized_sign_pm, randomized_sign_zero
from repro_torch.data.pipeline import MarkovCorpus
from repro_torch.train.trainer import TrainSettings, run_training

CFG = ModelConfig(name="nano", family="lm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                  d_ff=128, vocab_size=64, head_dim=16, mlp_gated=False, act="gelu",
                  dtype="float32", param_dtype="float32", vocab_pad_to=64)
DRAWS = 4000


def lemma1(device: str) -> dict:
    """max |E[S_r(v)] - v/B| over DRAWS draws of each operator, for a
    uniform v in [-1, 1]^512 and B = 1.2 |v|."""
    gen = torch.Generator(device).manual_seed(0)
    v = torch.rand(512, generator=gen, device=device) * 2 - 1
    bound = float(torch.linalg.vector_norm(v)) * 1.2
    out = {}
    for name, op in (("eq9 +-sign", randomized_sign_pm), ("eq10 zero/sign", randomized_sign_zero)):
        # the operators are elementwise: DRAWS independent draws at once
        mean = op(v.expand(DRAWS, -1), gen, bound).mean(0)
        out[name] = float((mean - v / bound).abs().max())
        print(f"{name}: max |E[S_r(v)] - v/B| = {out[name]:.4f}  (Lemma 1)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    out = {"lemma1": lemma1(args.device)}
    corpus = MarkovCorpus(CFG.vocab_size, branch=4, seed=7)
    for mode in ("sign", "rand_pm"):
        s = TrainSettings(algorithm="dsm", sign_mode=mode, n_workers=4, tau=4, steps=args.steps,
                          b_micro=8, seq=128, peak_lr=1e-2, global_lr=0.3, warmup=4,
                          eval_every=args.steps)
        r = run_training(CFG, s, corpus, device=args.device)
        out[mode] = r["final_eval"]
        print(f"DSM sign_mode={mode:8s}: final eval {r['final_eval']:.4f}")
    return out


if __name__ == "__main__":
    main()
