"""End-to-end run on the PyTorch port: pre-train a GPT-2-small-family
model from scratch with Algorithm 1, mirroring the paper's §4 protocol
(AdamW base optimizer, cosine LR with warmup, Lion betas for the global
step, tau=12).

Defaults are small (reduced width, 120 outer steps). Raise --layers /
--d-model / --seq to the paper's 124M config (12L/768) on the card: the
training code is identical, and ``python -m repro_torch.launch.dryrun``
reckons the full-size placements.

Run:  PYTHONPATH=src python examples/torch_train_gpt2_dsm.py --steps 120
      (``--device cpu`` without a card)
"""

import argparse

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import MarkovCorpus
from repro_torch.train.trainer import TrainSettings, run_training


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--tau", type=int, default=12)
    ap.add_argument("--n-workers", type=int, default=8)
    ap.add_argument("--peak-lr", type=float, default=5e-3)
    ap.add_argument("--global-lr", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> tuple:
    """(the model config, the run's TrainSettings) of the parsed flags."""
    cfg = ModelConfig(
        name="gpt2_family", family="lm", n_layers=args.layers,
        d_model=args.d_model, n_heads=max(args.d_model // 32, 1),
        n_kv_heads=max(args.d_model // 32, 1), d_ff=4 * args.d_model,
        vocab_size=256, head_dim=32, mlp_gated=False, act="gelu",
        tie_embeddings=True, dtype="float32", param_dtype="float32",
        vocab_pad_to=256,
    )
    s = TrainSettings(
        algorithm="dsm", base_opt="adamw", n_workers=args.n_workers,
        tau=args.tau, steps=args.steps, b_micro=2, seq=args.seq,
        peak_lr=args.peak_lr, warmup=max(args.steps // 10, 2),
        global_lr=args.global_lr,
        dsm_beta1=0.95, dsm_beta2=0.98, dsm_wd=0.1,  # paper's Lion params
        eval_every=max(args.steps // 6, 1),
    )
    return cfg, s


def main(argv=None) -> dict:
    args = parse(argv)
    cfg, s = build(args)
    corpus = MarkovCorpus(cfg.vocab_size, branch=8, seed=3)
    r = run_training(cfg, s, corpus, log=print, device=args.device)
    print(f"\nfinal eval loss {r['final_eval']:.4f}; "
          f"{r['tokens']/1e6:.1f}M tokens, {r['comm_rounds']} comm rounds "
          f"({args.tau}x fewer than per-step data parallel)")
    return {"final_eval": r["final_eval"], "history": r["history"], "tokens": r["tokens"],
            "comm_rounds": r["comm_rounds"]}


if __name__ == "__main__":
    main()
