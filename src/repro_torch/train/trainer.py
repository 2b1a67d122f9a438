"""Training harness of the port: DSM (Algorithm 1) or any of the paper's
baselines, with any base optimizer, on any decoder-only (``lm``)
ModelConfig the port builds: W
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
batch and takes its workers' rows of every leaf, so the data is the dense
run's worker for worker; every rank returns the same history, rank 0 logs and writes the
checkpoints (in the dense layout), and every rank restores its part.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import kernels as K
from repro_torch.analysis import sanitize as SAN
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.core import (DSMConfig, dsm_init, get_base_optimizer, make_dsm_step,
                              make_local_phase)
from repro_torch.core import baselines as BL
from repro_torch.core.schedules import constant, cosine_with_warmup
from repro_torch.data.pipeline import MarkovCorpus, dsm_batches, eval_batch
from repro_torch.distributed import comm
from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import zero as Z
from repro_torch.groups import each, parts
from repro_torch.models import convert as C
from repro_torch.models import transformer as T
from repro_torch.obs import ledger as OL
from repro_torch.obs import metrics as OM
from repro_torch.obs import sinks as OS
from repro_torch.obs import tracing as OT
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
    # --- runtime sanitizers (the reference's docs/analysis.md) ---
    sanitize: bool = False          # no implicit host sync inside the outer
    #                                 step (CUDA sync debug mode "error")
    sanitize_nans: bool = False     # every floating tensor the step returns
    #                                 must be finite (the chaos tier)
    # --- observability (the reference's docs/observability.md) ---
    run_dir: Optional[str] = None   # obs run directory: manifest.json /
    #                                 events.jsonl / scalars.csv / profile/
    log_every: int = 0              # metric flush + log cadence in outer
    #                                 steps; <=0 -> eval_every
    profile_steps: Optional[str] = None  # "A:B": torch.profiler window
    #                                 (inclusive outer-step range)


def _schedule(s: TrainSettings):
    if s.schedule == "cosine":
        return cosine_with_warmup(s.peak_lr, s.steps, warmup_steps=s.warmup)
    return constant(s.peak_lr)


def build_algorithm(loss_fn, s: TrainSettings, layout, topo=None):
    """Returns (init(x0, n_workers) -> state, step(state, batch, rng,
    faults=None) -> (state, metrics), eval_params(state) -> (N,) params,
    comm_multiplier).

    ``batch``: the dict of (W, tau, 1, B_micro, ...) leaves, the state's
    workers' rows; ``loss_fn(params, microbatch)`` takes one microbatch's
    dict; ``rng``:
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
                (lambda st: each(lambda p: p[0], st.params)) if sharded else
                (lambda st: st.x0), 1.0)

    if s.algorithm in BL.LOCAL_METHODS:
        kw = {"slowmo": dict(beta=s.slow_beta, alpha=s.global_lr),
              "signed_slowmo": dict(beta=s.slow_beta, eta=s.global_lr),
              "lookahead": dict(beta=s.slow_beta, eta=s.global_lr),
              "global_adamw": dict(eta=s.global_lr),
              "local_avg": {}}[s.algorithm]
        init, step = BL.LOCAL_METHODS[s.algorithm](loss_fn, base, s.tau, sched, layout,
                                                   topo=topo, **kw)
        return (init, (lambda st, batch, rng, faults=None: step(st, batch)),
                (lambda st: st.x0), 1.0)

    if s.algorithm == "perstep":
        init, step = BL.make_perstep_dp_step(loss_fn, base, s.tau, sched, layout)
        return (init, (lambda st, batch, rng, faults=None: step(st, batch)),
                (lambda st: st.params), float(s.tau))

    if s.algorithm == "mv_signsgd":
        init, step = BL.make_mv_signsgd_step(
            loss_fn, s.tau, gamma=s.peak_lr, eta=s.global_lr * s.peak_lr, layout=layout,
            beta=s.slow_beta, bound=1.0,
        )
        return init, (lambda st, batch, rng, faults=None: step(st, batch, rng)), \
            (lambda st: st.x), 1.0

    raise ValueError(f"unknown algorithm {s.algorithm!r}; have {ALGORITHMS}")


_DSM_FAMILY = ("dsm", "signed_lookahead")
# the batch leaf, beside the tokens, of the families that run_training refuses
_EXTRA_LEAF = {"vlm": "patches", "encdec": "frames"}
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
    checkpoint_s, restore_s, state, comm, step_compiles, run_dir, phase_ms,
    final_metrics, probe_launches, and peak_bytes on the card).

    ``params``: initial params in the port's flat layout, ``(N,)`` or
    ``(W, N)``, the Groups of a mixed-dtype model (for example
    ``convert.from_jax_numpy`` of the reference's ``init_params``); by
    default they are drawn from ``s.seed``.  A mixed-dtype model runs every
    path, the ranks' too: each dtype group is sharded, scattered and
    gathered on its own (``repro_torch.distributed.zero``).  A ``vlm`` or
    ``encdec`` config raises ValueError: the corpus gives tokens only, as the
    reference's trainer feeds them (``make_dsm_step`` takes those families'
    batch dicts).
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

    Observability and sanitizers, with the reference's semantics and file
    format (``repro_torch.obs``, ``repro_torch.analysis.sanitize``):

      * ``run_dir`` — rank 0 writes manifest.json, events.jsonl (spans,
        the comm ledger after the first round, eval / checkpoint / rollback
        / resumed / device_memory / finished events) and one scalars.csv
        row per round, flushed every ``log_every`` rounds and at every eval,
        checkpoint and rollback with ONE device-to-host copy.  After the
        loop a probe times the local phase and the outer step on a clone of
        the final state; ``probe_launches`` holds the kernel launches it
        made (the run's results do not change).  ``phase_ms`` holds the
        spans; ``final_metrics`` the last scalars row (equal on every rank);
        ``peak_bytes`` is read before the probe.
      * ``profile_steps`` "A:B" — a ``torch.profiler`` trace of outer steps
        A..B in ``<run_dir>/profile`` (rank 0); a profiler that fails is a
        ``profile_failed`` event, not the end of the run.
      * ``sanitize`` — no implicit host sync inside each step call on the
        card; ``sanitize_nans`` — every floating tensor the step returns
        must be finite.  ``step_compiles`` is None: an eager step compiles
        nothing.
    """
    if cfg.family in _EXTRA_LEAF:
        raise ValueError(
            f"{cfg.name}: run_training feeds token batches only, as the reference's trainer "
            f"does (its loss_fn raises KeyError for a {cfg.family!r} batch without "
            f"{_EXTRA_LEAF[cfg.family]!r}); train the {cfg.family} family through "
            "repro_torch.core.dsm.make_dsm_step with a batch dict of tokens and "
            f"{_EXTRA_LEAF[cfg.family]}")
    dev = resolve_device(device)
    set_matmul_precision()
    corpus = corpus or MarkovCorpus(cfg.vocab_size, seed=1)
    lay = T.layout(cfg)
    if params is None:
        gen = torch.Generator().manual_seed(s.seed)
        x0 = each(lambda t: t.to(dev), T.init_params(gen, cfg))
    else:
        x0 = lay.empty(device=dev)
        for dst, src in zip(parts(x0), parts(params), strict=True):
            dst.copy_(src.reshape(-1, dst.numel())[0])

    def loss_fn(p, microbatch):
        return T.loss_fn(p, microbatch, cfg, remat=False)   # as the reference's trainer

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
    # the guarded round with no host read; its host counters are settled
    # after the call (G.settle_counters), outside the sanitizer
    step_fn = (G.make_guarded_device_step(step, nonfinite=s.guard_nonfinite,
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
            dense = Z.dense_host(state, topo, lay.group_numels)
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

    def device_batch(raw) -> dict:
        # the state's workers' rows of every leaf; token ids as int64
        return {k: torch.as_tensor(v[rows], dtype=torch.long if k == "tokens" else None).to(dev)
                for k, v in raw.items()}

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
        dense = state if topo is None else Z.gather_state(state, topo, lay.group_numels)
        if root:
            CK.save_checkpoint(s.checkpoint_dir, ckpt_tree(dense), step_no,
                               keep=s.checkpoint_keep, extra=ckpt_extra())
        del dense
        comm.barrier(ranks, dev)
        ckpt_s.append(time.perf_counter() - tc)

    if ckpt_on and start_step == 0:
        save(0)   # the step-0 checkpoint: the rollback target always exists

    ev_batch = {"tokens": torch.as_tensor(eval_batch(corpus, s.eval_batch, s.seq)["tokens"],
                                          dtype=torch.long, device=dev)}

    def eval_loss() -> float:
        with torch.no_grad():
            return float(T.loss_fn(lay.views(eval_params(state)), ev_batch, cfg, remat=False))

    # --- observability (the reference's docs/observability.md): run sinks,
    # comm ledger, phase spans, profiler window.  Per-round metrics stay on
    # the device in `pending`; flush_metrics() brings them over in one copy
    # at the sync points (log / eval / checkpoint / rollback / end).  Every
    # rank flushes (each returns the same final_metrics); rank 0 writes. ---
    obs_on = bool(s.run_dir)
    writer = profile = None
    phase_totals = OT.PhaseTotals()
    log_every = s.log_every if s.log_every > 0 else s.eval_every
    pending: list = []      # (outer step number, on-device metrics dict)
    if obs_on and root:
        manifest = OS.build_manifest(
            run_name=os.path.basename(os.path.normpath(s.run_dir)), settings=s,
            model_cfg=cfg, mesh=topo, device=dev, world=ranks.world)
        writer = OS.RunWriter(s.run_dir, manifest, resume=start_step > 0)
        if start_step > 0:
            writer.event("resumed", step=start_step)
    if obs_on:
        # parsed on every rank, so a bad spec stops them all; rank 0 profiles
        profile_steps = OT.parse_profile_steps(s.profile_steps)
        if writer is not None:
            profile = OT.ProfileWindow(
                profile_steps, os.path.join(s.run_dir, "profile"), dev,
                on_fail=lambda step, err: writer.event("profile_failed", step=step, error=err))
    # the first round's collectives, counted (the eager step has no program
    # to read ahead of time, see obs/ledger.py)
    ledger_from = ranks.stats.as_dict() if obs_on else None

    def emit(kind: str, **fields) -> None:
        if writer is not None:
            writer.event(kind, **fields)

    def span(name: str, seconds: float, **fields) -> None:
        phase_totals.add(name, seconds, n=fields.get("n", 1))
        if writer is not None:
            writer.span(name, seconds, **fields)

    def flush_metrics():
        """ONE device-to-host copy for every pending round; returns the
        last decoded scalar row (dict) or None.  Closes the running
        train-window span: the copy is its fence."""
        nonlocal window_t0, window_steps
        if not pending:
            return None
        fetched = OM.fetch_metrics([m for _, m in pending])
        if obs_on and window_steps:
            span("train_window", time.monotonic() - window_t0, n=window_steps,
                 step=pending[-1][0])
        row = None
        for (step_no, _), m in zip(pending, fetched):
            vals = OM.decode_metrics_row(m)
            if writer is not None:
                writer.metrics_row(step_no, vals)
            row = dict(zip(OM.METRIC_NAMES, (float(v) for v in vals)))
        pending.clear()
        window_steps = 0
        window_t0 = time.monotonic()
        return row

    # --- runtime sanitizers (the reference's docs/analysis.md): no host
    # sync around each step call; the eval / log / checkpoint reads and the
    # guard's verdict stay OUTSIDE, at the sanctioned sync points ---
    step_guard = (functools.partial(SAN.no_implicit_host_sync, dev) if s.sanitize
                  else contextlib.nullcontext)

    batches = make_batches(start_step)
    t = start_step
    _sync(dev)
    t0 = time.time()
    window_t0 = time.monotonic()
    window_steps = 0
    last_row = None
    try:
        while t < s.steps:
            if profile is not None:
                tick = time.monotonic()
                profile.tick(t)
                # the profiler's start and trace export stay out of the train window
                window_t0 += time.monotonic() - tick
            ts = time.perf_counter()
            batch = device_batch(next(batches))
            fr = plan.round(t, dev) if plan is not None else None
            with step_guard():
                if guards_on:
                    state, guard, metrics, counters = step_fn(state, guard, batch, rng, fr)
                else:
                    state, metrics = step_fn(state, batch, rng, fr)
                history.append(metrics["loss"])     # device scalar, read at sync points
                pending.append((t + 1, metrics))
                window_steps += 1
            if guards_on:
                G.settle_counters(state, metrics, counters)   # the verdict's host read
            _sync(dev)
            step_s.append(time.perf_counter() - ts)
            if s.sanitize_nans:
                SAN.debug_nans(t + 1, state=state, guard=guard, metrics=metrics)
            if ledger_from is not None:
                emit("comm_ledger", **OL.observed_ledger(
                    OL.stats_delta(ledger_from, ranks.stats.as_dict()),
                    group_numels=lay.group_numels, n_param_leaves=len(lay.names),
                    group_itemsizes=tuple(dt.itemsize for dt in lay.dtypes),
                    algo="dsm" if s.algorithm in _DSM_FAMILY else s.algorithm, tau=s.tau,
                    phase="global_zero" if s.zero_sharded and topo is not None
                    else "global_dense", world=topo.world if topo is not None else 1,
                    name="train_step"))
                ledger_from = None
            if on_round is not None:
                on_round(t, state, metrics)

            if rollback_on and int(guard.bad_streak) >= s.guard_patience:
                last_row = flush_metrics() or last_row  # rejected rounds are observations
                if rollbacks >= s.guard_max_rollbacks:
                    raise RuntimeError(
                        f"training diverged: {int(guard.bad_streak)} consecutive "
                        f"bad rounds at step {t} after {rollbacks} rollbacks")
                rollbacks += 1
                t_ck, extra = restore_latest()
                guard = guard._replace(bad_streak=torch.zeros_like(guard.bad_streak))
                history = [float(x) for x in extra.get("history", [])]
                evals = [tuple(e) for e in extra.get("evals", [])]
                emit("rollback", step=t, to_step=t_ck, n=rollbacks)
                if log:
                    log(f"rollback #{rollbacks}: step {t} -> checkpoint at {t_ck}")
                batches = make_batches(t_ck)
                t = t_ck
                window_t0 = time.monotonic()
                continue

            t += 1
            is_eval = t % s.eval_every == 0 or t == s.steps
            is_log = t % log_every == 0
            did_ckpt = ckpt_on and t % ckpt_every == 0
            if is_eval or is_log or did_ckpt:
                last_row = flush_metrics() or last_row
            if is_eval:
                with OT.Span("eval", dev) as sp:
                    el = eval_loss()
                if obs_on:
                    span("eval", sp.seconds, step=t)
                    emit("eval", step=t, eval_loss=el)
                evals.append((t, el))
                if log:
                    train = last_row["loss"] if last_row else float(history[-1])
                    log(f"step {t:4d} train={train:.4f} eval={el:.4f}")
            elif is_log and log and last_row is not None:
                log(f"step {t:4d} train={last_row['loss']:.4f}")
            if did_ckpt:
                history = [float(x) for x in history]   # a checkpoint is a sync point
                with OT.Span("checkpoint", dev) as sp:
                    save(t)
                if obs_on:
                    span("checkpoint", sp.seconds, step=t)
                    emit("checkpoint", step=t)
            if obs_on and (is_eval or is_log or did_ckpt):
                # eval / checkpoint time must not leak into the next train window
                window_t0 = time.monotonic()
    finally:
        if profile is not None:
            profile.close()
    wall = time.time() - t0
    tokens_total = s.steps * s.tau * s.n_workers * s.b_micro * s.seq
    last_row = flush_metrics() or last_row      # tail rounds (early exits)
    out = {
        "history": [float(x) for x in history],
        "eval_losses": evals,
        "final_eval": evals[-1][1] if evals else float("nan"),
        "tokens": tokens_total,
        "comm_rounds": int(s.steps * comm_mult),
        "wall_s": wall,
        "outer_step_s": step_s,
        "skipped_rounds": int(guard.skipped) if guards_on else 0,
        "rollbacks": rollbacks,
        "checkpoint_s": ckpt_s,
        "restore_s": restore_s,
        "state": state,
        "comm": ranks.stats.as_dict(),
        # an eager step compiles nothing: the reference's recompilation
        # counter has no counterpart
        "step_compiles": None,
        "run_dir": s.run_dir,
        "phase_ms": None,
        "final_metrics": last_row,
        "probe_launches": None,
    }
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if obs_on:
        steps_done = t - start_step
        if s.algorithm in _DSM_FAMILY and steps_done > 0:
            out["probe_launches"] = probe_phases(
                span, state, guard, step_fn, make_local_phase(loss_fn, get_base_optimizer(
                    s.base_opt), lay), device_batch(next(make_batches(start_step))),
                plan.round(start_step, dev) if plan is not None else None, s, dev)
        mem = OT.device_memory_stats(dev)
        if mem is not None:
            emit("device_memory", stats=mem)
        emit("finished", steps=steps_done, wall_s=wall,
             steps_per_s=steps_done / wall if wall > 0 else None, tokens=tokens_total,
             tokens_per_s=tokens_total / wall if wall > 0 else None,
             skipped_rounds=out["skipped_rounds"], rollbacks=rollbacks)
        out["phase_ms"] = phase_totals.as_dict()
        if writer is not None:
            writer.close()
    return out


def probe_phases(span, state, guard, step_fn, local_phase, batch, fr, s: TrainSettings,
                 dev) -> dict:
    """The post-run phase probe (the reference's): the local phase and the
    whole outer step cannot be fenced apart inside a round, so both are
    timed here (median of 3 after 1 warm-up, CUDA events on the card), and
    global step = outer step - local phase, written with ``probe=True``.
    The port's steps update their state in place, so the probe runs on a
    clone of the final state (its scratch shared) and of the guard and the
    generator: the run's results stay as they were.  Returns the kernel
    launches the probe made, which the run's own counts do not hold."""
    before = K.launch_counts()
    st = Z.map_state(state, torch.clone)
    rng = torch.Generator(device=dev).manual_seed(s.seed)
    if guard is not None:
        g = G.GuardState(*(x.clone() for x in guard))
        outer = functools.partial(step_fn, st, g, batch, rng, fr)
    else:
        outer = functools.partial(step_fn, st, batch, rng, fr)
    local_s = OT.timeit_fenced(lambda: local_phase(st, batch, s.peak_lr), iters=3, device=dev)
    step_s = OT.timeit_fenced(outer, iters=3, device=dev)
    span("local_phase", local_s, probe=True)
    span("global_step", max(step_s - local_s, 0.0), probe=True)
    del st
    return {k: n - before[k] for k, n in K.launch_counts().items()}
