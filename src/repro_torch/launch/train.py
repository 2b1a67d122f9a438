"""Training launcher of the port, with the reference launcher's training
flags and defaults (DSM with the arch's base optimizer, AdamW):

    PYTHONPATH=src python -m repro_torch.launch.train              # nano, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2_small --corpus text
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 --tau 2
    PYTHONPATH=src python -m repro_torch.launch.train --algorithm slowmo --base-opt sophia
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 --tau 2 \
        --faults "drop=0.25,straggle=0.1,nan=0.05,seed=0" --guard-nonfinite \
        --checkpoint-dir /tmp/ck            # add --resume to continue from it
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 --tau 2 \
        --run-dir build/run --log-every 1 --profile-steps 1:1 --sanitize

``--arch`` accepts ``nano``, ``<id>`` (FULL) or ``<id>_smoke`` of every
decoder-only arch: ``attn`` / ``swa`` mixers with dense or MoE FFNs
(gemma3_1b, granite_moe_3b_a800m, llama4_maverick_400b_a17b_smoke among
them) and the recurrent mamba2_780m and recurrentgemma_2b (whisper and
llava train on batch dicts through ``make_dsm_step``).  A model whose
training state (W copies of params, gradients and AdamW moments, plus x0
and m, each group in its dtype) exceeds the device's memory is refused
before anything is allocated: llama4_maverick_400b_a17b FULL has 397.7 B
parameters, ~21.5 TB of state at W=4; recurrentgemma_2b FULL 2.89 B, 156 GB
at W=4, over one 80 GB card.  The Markov corpus keeps a (vocab, vocab, 8) table, so a
50k-token vocabulary needs ``--corpus text`` (bytes of this repository's
Python sources).

Several ranks, one process each, start under ``torch.distributed.run``;
``--zero-sharded`` and ``--device-parallel-local`` then split the workers
over the ranks (the world must be a multiple of ``--n-workers``)::

    # four ranks on the CPU
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --dist-backend gloo \
        --zero-sharded --device-parallel-local
    # four ranks sharing one card: gloo; one card per rank: nccl (the default)
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --dist-backend gloo --zero-sharded --device-parallel-local

Under ``nccl`` rank r runs on ``cuda:LOCAL_RANK``; under ``gloo`` on the
``--device`` given.  Rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from repro_torch.configs import load_arch
from repro_torch.core.base_opt import REGISTRY
from repro_torch.train.trainer import ALGORITHMS, TrainSettings, resolve_device, run_training

MARKOV_LIMIT_BYTES = 8 << 30


def resolve_arch(name: str):
    """(ModelConfig, TopologyConfig) of an arch name."""
    if name == "nano":
        from repro_torch.configs.nano import NANO

        return NANO, load_arch("gpt2_small").TOPO
    if name.endswith("_smoke"):
        mod = load_arch(name[: -len("_smoke")])
        return mod.SMOKE, mod.TOPO
    mod = load_arch(name)
    return mod.FULL, mod.TOPO


def make_corpus(kind: str, vocab: int):
    from repro_torch.data.pipeline import MarkovCorpus, TextCorpus

    if kind == "text":
        return TextCorpus(str(Path(__file__).resolve().parents[2]), "**/*.py")
    if MarkovCorpus.table_bytes(vocab) > MARKOV_LIMIT_BYTES:
        raise SystemExit(f"the Markov corpus for vocab {vocab} needs "
                         f"{MarkovCorpus.table_bytes(vocab) / 1e9:.0f} GB; use --corpus text")
    return MarkovCorpus(vocab, seed=1)


def state_bytes(cfg, n_workers: int) -> int:
    """Bytes of a DSM + AdamW training state: per worker params and
    gradients in their dtypes and two f32 moments, plus x0 and the f32 m."""
    from repro_torch.models.transformer import layout

    lay = layout(cfg)
    return sum(n * (n_workers * (2 * dt.itemsize + 8) + dt.itemsize + 4)
               for dt, n in zip(lay.dtypes, lay.group_numels))


def device_bytes(device: str) -> int:
    import torch

    dev = resolve_device(device)      # raises without a card
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def check_fits(cfg, n_workers: int, device: str) -> None:
    """Refuse a model whose training state exceeds the device's memory."""
    need, have = state_bytes(cfg, n_workers), device_bytes(device)
    if need > have:
        from repro_torch.configs import specs

        raise SystemExit(
            f"{cfg.name}: {specs.param_count(cfg):,} parameters need {need / 1e9:,.1f} GB of "
            f"training state at W={n_workers}, over the {have / 1e9:,.1f} GB of {device}; "
            "train its _smoke config or a cut depth")


def plan(arch: str, tau: int = None) -> dict:
    """The reference launcher's ``--plan`` fields (arch, params_B, its two
    pod meshes, tau, base_opt, grad_accum, dryrun_cmd, here the port's
    dry-run), its ``per_chip_peak_GB`` and ``dominant_roofline_term`` on the
    single-pod mesh, which the reference reads from its single-pod dry-run
    record, here from the port's own ``--mesh single`` reckoning of rank 0
    (one H100 per rank), and beside them the port's one-card reckoning at
    ``n_workers_single`` workers: ``per_card_peak_GB``, ``dominant_term``
    and the card they are reckoned for (``repro_torch.launch.dryrun``, at
    train_4k on meta tensors).  Needs no card and allocates nothing."""
    from repro_torch.configs import specs
    from repro_torch.launch import dryrun

    cfg, topo = resolve_arch(arch)
    tau = tau or topo.tau
    rec = dryrun.reckon(arch, "train_4k", tau)
    pod = dryrun.reckon_pod(arch, "train_4k", False, tau)
    return {
        "arch": arch,
        "params_B": round(specs.param_count(cfg) / 1e9, 3),
        "mesh_single_pod": {"shape": [16, 16], "axes": ["data", "model"],
                            "n_workers": topo.n_workers_single},
        "mesh_multi_pod": {"shape": [2, 16, 16], "axes": ["pod", "data", "model"],
                           "n_workers": topo.n_workers_multi},
        "tau": tau,
        "base_opt": topo.base_opt,
        "grad_accum": topo.grad_accum,
        "dryrun_cmd": (f"PYTHONPATH=src python -m repro_torch.launch.dryrun --arch {arch} "
                       "--shape train_4k"),
        "per_chip_peak_GB": round(pod["memory"]["peak_bytes"] / 1e9, 2),
        "dominant_roofline_term": pod["dominant"],
        "per_card_peak_GB": round(rec["memory"]["peak_bytes"] / 1e9, 2),
        "dominant_term": rec["dominant"],
        "card": rec["card"],
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="nano")
    ap.add_argument("--algorithm", default="dsm", choices=ALGORITHMS)
    ap.add_argument("--base-opt", default=None, choices=tuple(REGISTRY),
                    help="base optimizer of the local steps (default: the arch's)")
    ap.add_argument("--tau", type=int, default=None)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--n-workers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--b-micro", type=int, default=4)
    ap.add_argument("--peak-lr", type=float, default=5e-3)
    ap.add_argument("--global-lr", type=float, default=0.3)
    ap.add_argument("--checkpoint", default=None,
                    help="save the final global params here (<path>.npz + .json)")
    ap.add_argument("--corpus", default="markov", choices=("markov", "text"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # --- several ranks (the reference launcher's mesh flags) ---
    ap.add_argument("--zero-sharded", action="store_true",
                    help="shard the DSM global state x0 / m over the ranks (ZeRO)")
    ap.add_argument("--device-parallel-local", action="store_true",
                    help="each rank runs its own workers' local steps")
    ap.add_argument("--dist-backend", default="nccl", choices=("nccl", "gloo"),
                    help="process-group backend under torch.distributed.run: nccl (one "
                         "card per rank) or gloo (ranks sharing a card, or the CPU)")
    # --- robustness (the reference's docs/fault_tolerance.md) ---
    ap.add_argument("--faults", default=None,
                    help="seeded fault-injection spec, e.g. "
                         "'drop=0.25,straggle=0.1,nan=0.05,seed=0'")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="atomic rotated checkpoints of the full training state land here")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="outer steps between checkpoints (default: steps // 5)")
    ap.add_argument("--resume", action="store_true",
                    help="resume bit for bit from the latest complete checkpoint in "
                         "--checkpoint-dir")
    ap.add_argument("--guard-spike-factor", type=float, default=0.0,
                    help="skip rounds whose loss exceeds this factor times the "
                         "accepted-loss EMA (0 disables)")
    ap.add_argument("--guard-nonfinite", action="store_true",
                    help="skip rounds that produce NaN/inf anywhere in the training state")
    # --- observability (the reference's docs/observability.md) ---
    ap.add_argument("--run-dir", default=None,
                    help="observability run directory: manifest.json, "
                         "events.jsonl (spans, comm ledger), scalars.csv; "
                         "inspect with `python -m repro_torch.obs summarize <dir>`")
    ap.add_argument("--log-every", type=int, default=0,
                    help="metric flush + log cadence in outer steps "
                         "(default: the eval cadence)")
    ap.add_argument("--profile-steps", default=None, metavar="A:B",
                    help="capture a torch.profiler trace for the inclusive "
                         "outer-step range A:B into <run-dir>/profile")
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted so that the reference's command lines run unchanged; "
                         "the port's DSM global step always goes through the DSM kernel "
                         "on the card (its plain version on CPU tensors)")
    ap.add_argument("--plan", action="store_true",
                    help="print the launch plan as JSON (the reference's fields, and the "
                         "dry-run's peak and dominant term for one card) and exit; "
                         "touches no device")
    # --- runtime sanitizers (the reference's docs/analysis.md) ---
    ap.add_argument("--sanitize", action="store_true",
                    help="no implicit host sync inside the outer step on the card "
                         "(CUDA sync debug mode 'error'; gloo's host staging exempt)")
    ap.add_argument("--sanitize-nans", action="store_true",
                    help="every floating tensor the outer step returns must be finite "
                         "(chaos tier: masked NaNs must never reach the state)")
    return ap


def init_ranks(args):
    """``(group, device)``: the process group of a run started by
    ``torch.distributed.run`` (None outside one) and this rank's device."""
    if "WORLD_SIZE" not in os.environ:
        return None, args.device
    from repro_torch.distributed import comm

    device = args.device
    if args.dist_backend == "nccl":
        import torch

        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
        torch.cuda.set_device(device)
    group = comm.init_group(args.dist_backend, "env://", int(os.environ["RANK"]),
                            int(os.environ["WORLD_SIZE"]))
    return group, device


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.plan:
        out = plan(args.arch, args.tau)
        print(json.dumps(out, indent=2))
        return out

    cfg, topo = resolve_arch(args.arch)
    s = TrainSettings(
        algorithm=args.algorithm, base_opt=args.base_opt or topo.base_opt,
        n_workers=args.n_workers, tau=args.tau or topo.tau, steps=args.steps,
        seq=args.seq, b_micro=args.b_micro, peak_lr=args.peak_lr,
        global_lr=args.global_lr, eval_every=max(args.steps // 5, 1),
        faults=args.faults, guard_nonfinite=args.guard_nonfinite,
        guard_spike_factor=args.guard_spike_factor, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        zero_sharded=args.zero_sharded, device_parallel_local=args.device_parallel_local,
        sanitize=args.sanitize, sanitize_nans=args.sanitize_nans, run_dir=args.run_dir,
        log_every=args.log_every, profile_steps=args.profile_steps,
    )
    check_fits(cfg, args.n_workers, args.device)
    corpus = make_corpus(args.corpus, cfg.vocab_size)
    group, device = init_ranks(args)
    try:
        result = run_training(cfg, s, corpus, log=print, device=device, group=group)
    finally:
        if group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    if group is not None and int(os.environ["RANK"]) != 0:
        return result
    print(f"final eval loss: {result['final_eval']:.4f} "
          f"(comm rounds: {result['comm_rounds']}, tokens: {result['tokens']}, "
          f"skipped rounds: {result['skipped_rounds']}, rollbacks: {result['rollbacks']})")
    if args.run_dir:
        print(f"run dir: {args.run_dir} "
              f"(summarize: python -m repro_torch.obs summarize {args.run_dir})")
    if args.checkpoint:
        from repro_torch.checkpoint import checkpoint as CK
        from repro_torch.groups import each, parts
        from repro_torch.models import convert
        from repro_torch.models.transformer import layout

        st = result["state"]
        final = st.x0 if hasattr(st, "x0") else st.params
        if sum(t.numel() for t in parts(final)) != layout(cfg).numel:
            # x0 holds ZeRO shards; the workers hold the whole x0
            final = each(lambda p: p[0], st.params)
        CK.save(args.checkpoint, convert.leaf_tree(layout(cfg), final), step=args.steps)
        print(f"saved checkpoint to {args.checkpoint}.npz")
    return result


if __name__ == "__main__":
    main()
