"""Training harness of the port: DSM (Algorithm 1) or any of the paper's
baselines, with any base optimizer, on any ``attn:dense`` ModelConfig, W
simulated workers on one device.

Runs on the card unless the caller passes ``device="cpu"``; there is no
fallback when no card is present.  f32 matmuls run in full f32 (no TF32),
so the f32 logits product matches the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.core import DSMConfig, dsm_init, get_base_optimizer, make_dsm_step
from repro_torch.core import baselines as BL
from repro_torch.core.schedules import constant, cosine_with_warmup
from repro_torch.data.pipeline import MarkovCorpus, dsm_batches, eval_batch
from repro_torch.models import transformer as T

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


def _schedule(s: TrainSettings):
    if s.schedule == "cosine":
        return cosine_with_warmup(s.peak_lr, s.steps, warmup_steps=s.warmup)
    return constant(s.peak_lr)


def build_algorithm(loss_fn, s: TrainSettings, layout):
    """Returns (init(x0, n_workers) -> state, step(state, tokens, rng) ->
    (state, metrics), eval_params(state) -> (N,) params, comm_multiplier).

    ``tokens``: (W, tau, 1, B_micro, S); ``rng``: the ``torch.Generator``
    that the randomized signs draw from.
    """
    base = get_base_optimizer(s.base_opt)
    sched = _schedule(s)

    if s.algorithm in ("dsm", "signed_lookahead"):
        cfg = DSMConfig(
            tau=s.tau, global_lr=s.global_lr, beta1=s.dsm_beta1, beta2=s.dsm_beta2,
            weight_decay=s.dsm_wd, sign_mode=s.sign_mode, sign_bound=float(s.tau),
        )
        if s.algorithm == "signed_lookahead":
            cfg = dataclasses.replace(cfg, beta1=s.slow_beta, beta2=s.slow_beta,
                                      weight_decay=0.0)
        step = make_dsm_step(loss_fn, base, cfg, sched, layout)
        return (lambda x0, n: dsm_init(x0, base, n)), step, (lambda st: st.x0), 1.0

    if s.algorithm in BL.LOCAL_METHODS:
        kw = {"slowmo": dict(beta=s.slow_beta, alpha=s.global_lr),
              "signed_slowmo": dict(beta=s.slow_beta, eta=s.global_lr),
              "lookahead": dict(beta=s.slow_beta, eta=s.global_lr),
              "global_adamw": dict(eta=s.global_lr),
              "local_avg": {}}[s.algorithm]
        init, step = BL.LOCAL_METHODS[s.algorithm](loss_fn, base, s.tau, sched, layout, **kw)
        return init, (lambda st, tokens, rng: step(st, tokens)), (lambda st: st.x0), 1.0

    if s.algorithm == "perstep":
        init, step = BL.make_perstep_dp_step(loss_fn, base, s.tau, sched, layout)
        return (init, (lambda st, tokens, rng: step(st, tokens)), (lambda st: st.params),
                float(s.tau))

    if s.algorithm == "mv_signsgd":
        init, step = BL.make_mv_signsgd_step(
            loss_fn, s.tau, gamma=s.peak_lr, eta=s.global_lr * s.peak_lr, layout=layout,
            beta=s.slow_beta, bound=1.0,
        )
        return init, step, (lambda st: st.x), 1.0

    raise ValueError(f"unknown algorithm {s.algorithm!r}; have {ALGORITHMS}")


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
                 device=None, params: Optional[torch.Tensor] = None) -> dict:
    """Train; returns dict(history, eval_losses, final_eval, tokens,
    comm_rounds, wall_s, outer_step_s, state).

    ``params``: initial params in the port's flat layout, ``(N,)`` or
    ``(W, N)`` (for example ``convert.from_jax_numpy`` of the reference's
    ``init_params``); by default they are drawn from ``s.seed``.
    ``outer_step_s`` holds each outer step's time, ended by a device sync.
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

    init, step, eval_params, comm_mult = build_algorithm(loss_fn, s, lay)
    state = init(x0, s.n_workers)
    # the randomized signs' draws; each outer step that uses it advances it,
    # where the reference splits its key
    rng = torch.Generator(device=dev).manual_seed(s.seed)

    ev_tokens = torch.as_tensor(eval_batch(corpus, s.eval_batch, s.seq)["tokens"],
                                dtype=torch.long, device=dev)

    def eval_loss() -> float:
        with torch.no_grad():
            return float(T.loss_fn(lay.views(eval_params(state)), ev_tokens, cfg))

    batches = dsm_batches(corpus, s.n_workers, s.tau, 1, s.b_micro, s.seq,
                          seed=s.seed, heterogeneous=s.heterogeneous)
    history, evals, step_s = [], [], []
    _sync(dev)
    t0 = time.time()
    for t in range(1, s.steps + 1):
        ts = time.perf_counter()
        tokens = torch.as_tensor(next(batches)["tokens"], dtype=torch.long).to(dev)
        state, metrics = step(state, tokens, rng)
        history.append(metrics["loss"])     # device scalar, read at sync points
        _sync(dev)
        step_s.append(time.perf_counter() - ts)
        if t % s.eval_every == 0 or t == s.steps:
            el = eval_loss()
            evals.append((t, el))
            if log:
                log(f"step {t:4d} train={float(history[-1]):.4f} eval={el:.4f}")
    wall = time.time() - t0
    return {
        "history": [float(x) for x in history],
        "eval_losses": evals,
        "final_eval": evals[-1][1] if evals else float("nan"),
        "tokens": s.steps * s.tau * s.n_workers * s.b_micro * s.seq,
        "comm_rounds": int(s.steps * comm_mult),
        "wall_s": wall,
        "outer_step_s": step_s,
        "state": state,
    }
