"""Training harness of the port: DSM (Algorithm 1) or any of the paper's
baselines, with any base optimizer, on any ``attn:dense`` ModelConfig: W
simulated workers in one process, or over the ranks of a process group, one
process per rank, each holding its own workers (``zero_sharded``,
``device_parallel_local``).

Runs on the card unless the caller passes ``device="cpu"``; there is no
fallback when no card is present.  f32 matmuls run in full f32 (no TF32),
so the f32 logits product matches the reference.

Fault tolerance as in the reference (``docs/fault_tolerance.md``): seeded
fault injection and the survivor-aware global step (DSM family only),
skip-round guards, atomic rotated checkpoints of the whole training state
with bit-exact resume, and bounded rollback to the last checkpoint.

Over a process group every rank builds the whole (W, tau, accum, B, S)
batch and takes its workers' rows, so the data is the dense run's worker for
worker; every rank returns the same history, rank 0 logs and writes the
checkpoints (in the dense layout), and every rank restores its part.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import checkpoint as CK
from repro_torch.core import DSMConfig, dsm_init, get_base_optimizer, make_dsm_step
from repro_torch.core import baselines as BL
from repro_torch.core.schedules import constant, cosine_with_warmup
from repro_torch.data.pipeline import MarkovCorpus, dsm_batches, eval_batch
from repro_torch.distributed import comm
from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import zero as Z
from repro_torch.models import convert as C
from repro_torch.models import transformer as T
from repro_torch.robustness import guards as G
from repro_torch.robustness.faults import FaultPlan

ALGORITHMS = (
    "dsm", "slowmo", "signed_slowmo", "lookahead", "signed_lookahead",
    "global_adamw", "local_avg", "perstep", "mv_signsgd",
)


@dataclasses.dataclass
class TrainSettings:
    """The reference's settings that this port runs, with its defaults."""

    algorithm: str = "dsm"
    base_opt: str = "adamw"
    n_workers: int = 8
    tau: int = 12
    steps: int = 60                 # outer steps
    b_micro: int = 4
    seq: int = 128
    peak_lr: float = 1e-3
    warmup: int = 24
    schedule: str = "cosine"
    global_lr: float = 1.0          # eta (DSM) / alpha (SlowMo)
    slow_beta: float = 0.5          # SlowMo / lookahead momentum
    dsm_beta1: float = 0.95
    dsm_beta2: float = 0.98
    dsm_wd: float = 0.1
    sign_mode: str = "sign"
    seed: int = 0
    eval_every: int = 10
    eval_batch: int = 16
    heterogeneous: bool = True
    zero_sharded: bool = False      # ZeRO-sharded global step over the ranks
    device_parallel_local: bool = False  # each rank runs its own workers' local phase
    # --- robustness (the reference's docs/fault_tolerance.md) ---
    faults: Any = None              # FaultPlan | FaultSpec | spec str, e.g.
    #                                 "drop=0.25,straggle=0.1,nan=0.05,seed=0"
    mask_nonfinite: bool = False    # survivor-aware mean w/o injection (DSM)
    guard_nonfinite: bool = False   # reject rounds with NaN/inf in the state
    guard_spike_factor: float = 0.0  # reject rounds w/ loss > factor*EMA (0=off)
    guard_ema_beta: float = 0.9     # loss EMA for spike detection
    guard_patience: int = 5         # K consecutive bad rounds -> rollback
    guard_max_rollbacks: int = 2    # bounded retry; exceeded -> RuntimeError
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0       # outer steps; <=0 -> max(1, steps // 5)
    checkpoint_keep: int = 3        # rotated retention
    resume: bool = False            # resume from checkpoint_dir's latest


def _schedule(s: TrainSettings):
    if s.schedule == "cosine":
        return cosine_with_warmup(s.peak_lr, s.steps, warmup_steps=s.warmup)
    return constant(s.peak_lr)


def build_algorithm(loss_fn, s: TrainSettings, layout, topo=None):
    """Returns (init(x0, n_workers) -> state, step(state, tokens, rng,
    faults=None) -> (state, metrics), eval_params(state) -> (N,) params,
    comm_multiplier).

    ``tokens``: (W, tau, 1, B_micro, S), the state's workers' rows; ``rng``:
    the ``torch.Generator`` that the randomized signs draw from; ``faults``:
    the round's ``FaultRound``, taken by the DSM family only.  ``topo``: the
    rank's place among the ranks, taken by the DSM family and the local-step
    baselines (see :data:`TOPOLOGY_ALGORITHMS`).
    """
    base = get_base_optimizer(s.base_opt)
    sched = _schedule(s)

    if s.algorithm in ("dsm", "signed_lookahead"):
        cfg = DSMConfig(
            tau=s.tau, global_lr=s.global_lr, beta1=s.dsm_beta1, beta2=s.dsm_beta2,
            weight_decay=s.dsm_wd, sign_mode=s.sign_mode, sign_bound=float(s.tau),
            zero_sharded=s.zero_sharded, device_parallel_local=s.device_parallel_local,
            mask_nonfinite=s.mask_nonfinite,
        )
        if s.algorithm == "signed_lookahead":
            cfg = dataclasses.replace(cfg, beta1=s.slow_beta, beta2=s.slow_beta,
                                      weight_decay=0.0)
        step = make_dsm_step(loss_fn, base, cfg, sched, layout, topo)
        sharded = s.zero_sharded and topo is not None
        return ((lambda x0, n: dsm_init(x0, base, n, topo, s.zero_sharded)), step,
                # x0 is the rank's shard: params[0] equals x0 after the gather
                (lambda st: st.params[0]) if sharded else (lambda st: st.x0), 1.0)

    if s.algorithm in BL.LOCAL_METHODS:
        kw = {"slowmo": dict(beta=s.slow_beta, alpha=s.global_lr),
              "signed_slowmo": dict(beta=s.slow_beta, eta=s.global_lr),
              "lookahead": dict(beta=s.slow_beta, eta=s.global_lr),
              "global_adamw": dict(eta=s.global_lr),
              "local_avg": {}}[s.algorithm]
        init, step = BL.LOCAL_METHODS[s.algorithm](loss_fn, base, s.tau, sched, layout,
                                                   topo=topo, **kw)
        return (init, (lambda st, tokens, rng, faults=None: step(st, tokens)),
                (lambda st: st.x0), 1.0)

    if s.algorithm == "perstep":
        init, step = BL.make_perstep_dp_step(loss_fn, base, s.tau, sched, layout)
        return (init, (lambda st, tokens, rng, faults=None: step(st, tokens)),
                (lambda st: st.params), float(s.tau))

    if s.algorithm == "mv_signsgd":
        init, step = BL.make_mv_signsgd_step(
            loss_fn, s.tau, gamma=s.peak_lr, eta=s.global_lr * s.peak_lr, layout=layout,
            beta=s.slow_beta, bound=1.0,
        )
        return init, (lambda st, tokens, rng, faults=None: step(st, tokens, rng)), \
            (lambda st: st.x), 1.0

    raise ValueError(f"unknown algorithm {s.algorithm!r}; have {ALGORITHMS}")


_DSM_FAMILY = ("dsm", "signed_lookahead")
# the algorithms that split the workers over the ranks; the others read no
# topology flag (as in the reference) and every rank runs them whole
TOPOLOGY_ALGORITHMS = _DSM_FAMILY + tuple(BL.LOCAL_METHODS)


def splits_workers(s: TrainSettings) -> bool:
    """The run splits its workers over the ranks of a topology."""
    return (s.zero_sharded or s.device_parallel_local) and s.algorithm in TOPOLOGY_ALGORITHMS


def _resolve_fault_plan(s: TrainSettings) -> Optional[FaultPlan]:
    if not s.faults:
        return None
    if s.algorithm not in _DSM_FAMILY:
        raise ValueError("fault injection needs the survivor-aware DSM step family; "
                         f"got algorithm={s.algorithm!r}")
    if isinstance(s.faults, FaultPlan):
        return s.faults
    return FaultPlan.from_spec(s.faults, s.n_workers, s.steps)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raises without a card."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass device='cpu' "
                           "to run the plain kernel versions on the CPU")
    return dev


def set_matmul_precision() -> None:
    """Full f32 matmuls and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_training(cfg, s: TrainSettings, corpus=None, log: Optional[Callable] = None,
                 device=None, params: Optional[torch.Tensor] = None,
                 on_round: Optional[Callable] = None, group=None,
                 time_collectives: bool = False) -> dict:
    """Train; returns dict(history, eval_losses, final_eval, tokens,
    comm_rounds, wall_s, outer_step_s, skipped_rounds, rollbacks,
    checkpoint_s, restore_s, state, comm, and peak_bytes on the card).

    ``params``: initial params in the port's flat layout, ``(N,)`` or
    ``(W, N)`` (for example ``convert.from_jax_numpy`` of the reference's
    ``init_params``); by default they are drawn from ``s.seed``.
    ``outer_step_s`` holds each round's time, ended by a device sync;
    ``on_round(t, state, metrics)`` runs after each round, outside that time.

    ``group``: the ``torch.distributed`` process group of a run with one
    process per rank; every rank calls ``run_training`` with the same
    arguments.  With ``s.zero_sharded`` or ``s.device_parallel_local`` the
    ranks form the reference's ``(worker, zero)`` grid
    (``repro_torch.distributed.mesh``) and each runs its own workers;
    ``group=None`` with either flag is the reference's one-device degenerate
    grid.  Without the flags every rank runs the whole algorithm.
    ``state`` is the rank's own part; ``comm`` holds this rank's collective
    calls and bytes, and with ``time_collectives`` their seconds (each
    collective then syncs the device before and after); ``peak_bytes`` is
    ``torch.cuda.max_memory_allocated`` of the run's card.

    Robustness settings, with the reference's semantics:

      * ``faults`` — seeded fault injection (DSM family only);
        ``mask_nonfinite`` masks non-finite workers without injection.
      * ``guard_nonfinite`` / ``guard_spike_factor`` — skip-round guards; with
        ``checkpoint_dir`` set, ``guard_patience`` consecutive bad rounds roll
        the run back to the last checkpoint, at most ``guard_max_rollbacks``
        times before raising RuntimeError.
      * ``checkpoint_dir`` / ``checkpoint_every`` / ``resume`` — atomic rotated
        checkpoints of the whole training state (optimizer state, the
        generator of the randomized signs, guard state, loss history; the
        data position is the step index), so a killed run restarts bit for
        bit from the last complete checkpoint.  ``checkpoint_s`` holds each
        save's seconds, ``restore_s`` the resume's (None without one).  A
        checkpoint holds the dense layout whatever the world size, so it
        restores under any other.
    """
    dev = resolve_device(device)
    set_matmul_precision()
    corpus = corpus or MarkovCorpus(cfg.vocab_size, seed=1)
    lay = T.layout(cfg)
    if params is None:
        gen = torch.Generator().manual_seed(s.seed)
        x0 = T.init_params(gen, cfg).to(dev)
    else:
        x0 = params.reshape(-1, lay.numel)[0].to(device=dev, dtype=cfg.p_dtype).clone()

    def loss_fn(p, tokens):
        return T.loss_fn(p, tokens, cfg)

    topo = None
    if splits_workers(s):
        topo = MESH.topology(s.n_workers, group, time_collectives)
    # one topology for rank-0-only work and barriers, whether or not the
    # algorithm splits its workers
    ranks = topo if topo is not None else MESH.topology(1, group, time_collectives)
    root = ranks.rank == 0
    log = log if root else None
    rows = slice(None) if topo is None else topo.worker_slice

    init, step, eval_params, comm_mult = build_algorithm(loss_fn, s, lay, topo)
    state = init(x0, s.n_workers)
    # the randomized signs' draws; each outer step that uses it advances it,
    # where the reference splits its key
    rng = torch.Generator(device=dev).manual_seed(s.seed)

    plan = _resolve_fault_plan(s)
    guards_on = s.guard_nonfinite or s.guard_spike_factor > 0
    guard = G.init_guard(dev) if guards_on else None
    step_fn = (G.make_guarded_step(step, nonfinite=s.guard_nonfinite,
                                   spike_factor=s.guard_spike_factor,
                                   ema_beta=s.guard_ema_beta, topo=topo)
               if guards_on else step)

    ckpt_on = bool(s.checkpoint_dir)
    ckpt_every = s.checkpoint_every if s.checkpoint_every > 0 else max(1, s.steps // 5)
    rollback_on = ckpt_on and guards_on and s.guard_patience > 0

    def ckpt_tree(st):
        # the reference's "state" and "guard" paths; the generator replaces
        # its threefry "key", which cannot be carried across
        tree = {"state": C.state_to_tree(st, cfg), "rng": rng.get_state()}
        if guard is not None:
            tree["guard"] = dict(guard._asdict())
        return tree

    def restore_latest():
        """Load the newest checkpoint into state, rng and guard in place;
        every rank reads the file and keeps its part."""
        nonlocal guard
        if topo is None:
            tree, step_no, extra = CK.restore_latest(s.checkpoint_dir, ckpt_tree(state))
            C.load_state_tree(state, tree["state"], cfg)
        else:
            dense = Z.dense_host(state, topo, lay.numel)
            tree, step_no, extra = CK.restore_latest(s.checkpoint_dir, ckpt_tree(dense))
            C.load_state_tree(dense, tree["state"], cfg)
            Z.load_local_part(state, dense, topo)
        rng.set_state(tree["rng"])
        if guards_on:
            guard = G.GuardState(**{k: v.to(dev) for k, v in tree["guard"].items()})
        return step_no, extra

    def make_batches(skip: int = 0):
        # data position == outer-step index: the stream is a pure function
        # of (corpus, seed), so a resume replays `skip` rounds
        it = dsm_batches(corpus, s.n_workers, s.tau, 1, s.b_micro, s.seq,
                         seed=s.seed, heterogeneous=s.heterogeneous)
        for _ in range(skip):
            next(it)
        return it

    history, evals, step_s, ckpt_s = [], [], [], []
    start_step, rollbacks, restore_s = 0, 0, None
    if s.resume and ckpt_on and CK.latest_checkpoint(s.checkpoint_dir) is not None:
        _sync(dev)
        tr = time.perf_counter()
        start_step, extra = restore_latest()
        _sync(dev)
        restore_s = time.perf_counter() - tr
        history = [float(x) for x in extra.get("history", [])]
        evals = [tuple(e) for e in extra.get("evals", [])]
        rollbacks = int(extra.get("rollbacks", 0))
        if log:
            log(f"resumed from checkpoint at step {start_step}")

    def ckpt_extra():
        return {"history": history, "evals": [list(e) for e in evals],
                "rollbacks": rollbacks,
                "skipped_rounds": int(guard.skipped) if guards_on else 0}

    def save(step_no: int) -> None:
        _sync(dev)
        tc = time.perf_counter()
        # shards and worker rows gathered to rank 0, which writes the dense
        # layout; the others wait until the file is complete
        dense = state if topo is None else Z.gather_state(state, topo, lay.numel)
        if root:
            CK.save_checkpoint(s.checkpoint_dir, ckpt_tree(dense), step_no,
                               keep=s.checkpoint_keep, extra=ckpt_extra())
        del dense
        comm.barrier(ranks, dev)
        ckpt_s.append(time.perf_counter() - tc)

    if ckpt_on and start_step == 0:
        save(0)   # the step-0 checkpoint: the rollback target always exists

    ev_tokens = torch.as_tensor(eval_batch(corpus, s.eval_batch, s.seq)["tokens"],
                                dtype=torch.long, device=dev)

    def eval_loss() -> float:
        with torch.no_grad():
            return float(T.loss_fn(lay.views(eval_params(state)), ev_tokens, cfg))

    batches = make_batches(start_step)
    t = start_step
    _sync(dev)
    t0 = time.time()
    while t < s.steps:
        ts = time.perf_counter()
        tokens = torch.as_tensor(next(batches)["tokens"][rows], dtype=torch.long).to(dev)
        fr = plan.round(t, dev) if plan is not None else None
        if guards_on:
            state, guard, metrics = step_fn(state, guard, tokens, rng, fr)
        else:
            state, metrics = step_fn(state, tokens, rng, fr)
        history.append(metrics["loss"])     # device scalar, read at sync points
        _sync(dev)
        step_s.append(time.perf_counter() - ts)
        if on_round is not None:
            on_round(t, state, metrics)

        if rollback_on and int(guard.bad_streak) >= s.guard_patience:
            if rollbacks >= s.guard_max_rollbacks:
                raise RuntimeError(
                    f"training diverged: {int(guard.bad_streak)} consecutive "
                    f"bad rounds at step {t} after {rollbacks} rollbacks")
            rollbacks += 1
            t_ck, extra = restore_latest()
            guard = guard._replace(bad_streak=torch.zeros_like(guard.bad_streak))
            history = [float(x) for x in extra.get("history", [])]
            evals = [tuple(e) for e in extra.get("evals", [])]
            if log:
                log(f"rollback #{rollbacks}: step {t} -> checkpoint at {t_ck}")
            batches = make_batches(t_ck)
            t = t_ck
            continue

        t += 1
        if t % s.eval_every == 0 or t == s.steps:
            el = eval_loss()
            evals.append((t, el))
            if log:
                log(f"step {t:4d} train={float(history[-1]):.4f} eval={el:.4f}")
        if ckpt_on and t % ckpt_every == 0:
            history = [float(x) for x in history]   # a checkpoint is a sync point
            save(t)
    wall = time.time() - t0
    out = {
        "history": [float(x) for x in history],
        "eval_losses": evals,
        "final_eval": evals[-1][1] if evals else float("nan"),
        "tokens": s.steps * s.tau * s.n_workers * s.b_micro * s.seq,
        "comm_rounds": int(s.steps * comm_mult),
        "wall_s": wall,
        "outer_step_s": step_s,
        "skipped_rounds": int(guard.skipped) if guards_on else 0,
        "rollbacks": rollbacks,
        "checkpoint_s": ckpt_s,
        "restore_s": restore_s,
        "state": state,
        "comm": ranks.stats.as_dict(),
    }
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out
