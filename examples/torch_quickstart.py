"""Quickstart on the PyTorch port: train a nano GPT with Distributed Sign
Momentum (Alg. 1) and compare against SlowMo at the same communication
budget.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      (``--device cpu`` without a card; ``--steps`` outer steps, 30 by default)
"""

import argparse

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import MarkovCorpus
from repro_torch.train.trainer import TrainSettings, run_training

CFG = ModelConfig(
    name="quickstart", family="lm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=64, head_dim=16, mlp_gated=False,
    act="gelu", dtype="float32", param_dtype="float32", vocab_pad_to=64,
)


def settings(steps: int = 30) -> dict:
    """``{name: TrainSettings}`` of the two runs, in order."""
    common = dict(n_workers=4, tau=8, steps=steps, b_micro=8, seq=128,
                  peak_lr=1e-2, warmup=5, eval_every=10)
    return {"dsm": TrainSettings(algorithm="dsm", global_lr=0.3, **common),
            "slowmo": TrainSettings(algorithm="slowmo", slow_beta=0.6, **common)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    corpus = MarkovCorpus(CFG.vocab_size, branch=4, seed=7)
    runs = settings(args.steps)
    titles = {"dsm": "Algorithm 1 (DSM): AdamW local steps + global sign momentum",
              "slowmo": "SlowMo baseline (same tau, same tokens)"}
    out = {}
    for name, s in runs.items():
        print(f"== {titles[name]} ==")
        r = run_training(CFG, s, corpus, log=print, device=args.device)
        out[name] = {"final_eval": r["final_eval"], "history": r["history"],
                     "comm_rounds": r["comm_rounds"]}
    print(f"\nDSM    final eval loss: {out['dsm']['final_eval']:.4f} "
          f"({out['dsm']['comm_rounds']} comm rounds)")
    print(f"SlowMo final eval loss: {out['slowmo']['final_eval']:.4f} "
          f"({out['slowmo']['comm_rounds']} comm rounds)")
    print(f"both use {runs['dsm'].tau}x fewer all-reduces than per-step DP")
    return out


if __name__ == "__main__":
    main()
