"""One-card dry-run of the port: every (arch x input shape) built on ``meta``
tensors, which have shapes and dtypes and allocate nothing, with the FLOPs
counted and the peak device bytes reckoned per component, for one NVIDIA
H100 SXM (80 GB, 700 W).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2_780m \\
        --shape train_4k --smoke

The port's counterpart of the reference's ``launch/dryrun.py``, which lowers
and compiles each combination for a TPU pod mesh.  ``--arch all`` is the
reference's ``ARCH_IDS``, the paper's three GPT-2 sizes and ``nano``;
``--shape all`` every ``INPUT_SHAPES`` entry that ``arch_supports_shape``
admits (the reference's ``main``).  One JSON record per combination lands
in ``--outdir`` (``build/dryrun_torch``); a failure is the reference's
``status: error`` record.

* **train**: the DSM + base-optimizer state of ``TOPO.n_workers_single``
  workers per dtype group (``core.dsm.dsm_init``), one microbatch's forward
  and backward through ``loss_fn`` under ``TOPO.remat`` /
  ``remat_policy`` (the reference's ``build_train``), and the global
  step's temporaries (the port's ``worker_mean`` and ``stat_sums``; the DSM
  and AdamW kernels update in place and allocate nothing, so they are not
  run here).
* **prefill** / **decode**: one ``prefill`` (``remat=True``, as the
  reference's ``build_prefill``) or ``decode_step`` call on the spec'd
  cache, on the params alone.

Every output shape is checked.  FLOPs come from
``torch.utils.flop_counter.FlopCounterMode``: the matmul-class ops (mm,
bmm, addmm, convolutions, attention) only, where XLA's ``cost_analysis``
counts every op; a train record counts one microbatch's forward and
backward (with the recompute under remat) times W * tau * accum.  Bytes
come from :class:`MemoryTracker`: the bytes of every storage that an op
creates, from that op until the storage is freed, and their high-water
mark; the peak is the state (with the round's batch) plus the largest of
the local phase's, the global step's and the eval's high-water marks, or
the high-water mark of building the state where that is larger (over
ranks, before ``dsm_init`` keeps the rank's shards of x0 and m).
Nothing is scaled by a fitted constant.  A combination that does not fit
one card (a full-width config at train_4k: W=8 workers of 32 sequences of
4096 tokens) says so in ``fits_one_card``; it is a reckoning, not a
refusal.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, PAPER_ARCH_IDS, arch_supports_shape, specs
from repro_torch.core import base_opt as BO
from repro_torch.core import dsm as D
from repro_torch.groups import each
from repro_torch.launch.train import resolve_arch
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as OM

# NVIDIA H100 SXM 80GB at its 700 W power limit (NVIDIA data sheet): the
# dense bf16 tensor-core peak (989 TFLOP/s; 1979 is with sparsity) and the
# HBM3 rate (the constant chip_smoke.py's kernel bounds use)
CARD = "NVIDIA H100 SXM 80GB, 700 W"
BF16_DENSE_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
CARD_BYTES = 80e9
# bytes each kernel moves per element, by the group's dtype: params,
# gradients and the two f32 moments (AdamW); x0, m and the worker mean (DSM)
ADAMW_BYTES = {torch.bfloat16: 22, torch.float32: 28}
DSM_BYTES = {torch.bfloat16: 14, torch.float32: 20}
META = torch.device("meta")
ALL_ARCHS = ("nano",) + PAPER_ARCH_IDS + ARCH_IDS


class MemoryTracker(TorchDispatchMode):
    """Live bytes of the storages that ops create under it, on any device:
    a storage counts from the op that created it (not a view of, or an
    in-place write into, one of the op's inputs) until it is freed;
    ``peak`` is the high-water mark of ``live``.  Storages made before it
    was entered do not count.  On the card this is what
    ``torch.cuda.memory_allocated`` adds for the same ops, less the caching
    allocator's rounding up to 512 bytes and the library workspaces."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs = WeakIdKeyDictionary()

    def reset_peak(self) -> int:
        """Set the high-water mark to the live bytes; returns them."""
        self.peak = self.live
        return self.live

    def _free(self, nbytes: int, _ref) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {id(t.untyped_storage()) for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if id(st) in inputs or st in self._refs:
                continue
            n = st.nbytes()
            self._refs[st] = weakref.ref(st, lambda ref, n=n: self._free(n, ref))
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


def _as_model_batch(batch: dict) -> dict:
    """The spec's int32 token ids as the int64 ids the port's trainer feeds."""
    return {k: v.long() if k == "tokens" else v for k, v in batch.items()}


def _micro(cfg, b_micro: int, seq: int) -> dict:
    return _as_model_batch(specs.batch_specs(cfg, (b_micro,), seq))


@contextlib.contextmanager
def _meta_collectives():
    """``torch.distributed``'s collectives as no-ops: on ``meta`` tensors
    they move nothing, and the port preallocates every output buffer, so
    the device bytes around them are the port's own; ``CommStats`` counts
    each call and its bytes as on a run."""
    import torch.distributed as dist

    names = ("all_to_all_single", "all_gather", "all_reduce", "gather", "get_global_rank")
    saved = {n: getattr(dist, n) for n in names}
    try:
        for n in names:
            setattr(dist, n, lambda *a, **k: 0)
        yield
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def _global_step(state, losses, topo, numels, beta1: float) -> None:
    """The allocations of ``make_dsm_step``'s global phase on the DSM path
    (no faults): over ranks the gather of the losses, the worker mean (over
    ranks the scatter and the shard's mean), the metric pack's stat sums,
    the DSM kernel (in place, nothing allocated, not run), the all-gather of
    x_{t+1,0} and the workers' re-sync (in place)."""
    from repro_torch.distributed import comm
    from repro_torch.distributed import zero as Z

    gamma = 1e-3
    if topo is not None:
        losses = comm.gather_workers(losses, topo, dim=1)
    if topo is None:
        x_tau = D.worker_mean(state.params)
        stat = OM.stat_sums(state.x0, state.m, x_tau, gamma, beta1)
        x0 = state.x0
    else:
        x_tau = Z.scattered_worker_mean(state.params, topo)
        stat = Z.sharded_stat_sums(state.x0, state.m, x_tau, gamma, beta1, topo, numels)
        x0 = Z.gather_shards(state.x0, topo, numels)
    each(lambda p, x: p.copy_(x.expand_as(p)), state.params, x0)
    del x_tau, stat, x0, losses


def reckon_train(cfg, *, n_workers: int, tau: int, accum: int = 1, b_micro: int, seq: int,
                 base_opt: str = "adamw", remat: bool = False, remat_policy: str = "full",
                 eval_batch: int = 0, keep_x0: bool = True, world: int = 1) -> dict:
    """One outer step's FLOPs and peak device bytes, on ``meta``.

    ``keep_x0``: the initial x0 stays allocated beside the state, as in
    ``run_training``.  ``eval_batch``: sequences of ``run_training``'s eval
    forward (0: none).  ``world`` > 1 reckons rank 0 of that many ranks with
    the ZeRO-sharded global step and the device-parallel local phase; its
    ``comm`` holds the round's collective calls and bytes as ``CommStats``
    counts them."""
    from repro_torch.distributed import mesh

    lay = T.layout(cfg)
    base = BO.get_base_optimizer(base_opt)
    topo = None
    if world > 1:
        worker, zero = mesh.grid(n_workers, world)
        topo = mesh.Topology(n_workers, worker, zero, rank=0, group=object(),
                             backend="nccl")
    w_local = n_workers if topo is None else topo.local_workers
    tracker = MemoryTracker()
    with tracker:
        x0 = lay.empty(device=META)
        state = D.dsm_init(x0, base, n_workers, topo, global_sharded=topo is not None)
        if not keep_x0:
            del x0
        batch = _as_model_batch(specs.batch_specs(cfg, (w_local, tau, accum, b_micro), seq))
    # building the state can pass its final size: over ranks dsm_init holds
    # the whole x0 and m until it keeps the rank's shards
    init_bytes, state_bytes = tracker.peak, tracker.live

    tracker.reset_peak()
    with tracker, FlopCounterMode(display=False) as flops:
        leaves = lay.autograd_leaves(each(lambda p: p[0], state.params),
                                     each(lambda g: g[0], state.grads))
        loss = T.loss_fn(leaves, D.take(batch, 0, 0, 0), cfg, remat=remat,
                         remat_policy=remat_policy)
        loss.backward()
        del loss, leaves
    local_bytes = tracker.peak - state_bytes
    micro_flops = flops.get_total_flops()

    tracker.reset_peak()
    with tracker, _meta_collectives():
        losses = torch.empty(tau, w_local, device=META)
        _global_step(state, losses, topo, lay.group_numels, D.DSMConfig().beta1)
        del losses
    global_bytes = tracker.peak - state_bytes

    eval_bytes = 0
    if eval_batch:
        tracker.reset_peak()
        with tracker, torch.no_grad():
            # run_training's eval_params: x0, or over ranks the worker row
            x0v = lay.views(state.x0 if topo is None else each(lambda p: p[0], state.params))
            T.loss_fn(x0v, _micro(cfg, eval_batch, seq), cfg, remat=False)
            del x0v
        eval_bytes = tracker.peak - state_bytes

    rows = [(dt, n) for dt, n in zip(lay.dtypes, lay.group_numels)]
    shard = (lambda n: n) if topo is None else (lambda n: -(-n // world))
    kernel_bytes = sum(n * w_local * tau * ADAMW_BYTES[dt] * (base_opt == "adamw")
                       + shard(n) * DSM_BYTES[dt] for dt, n in rows)
    total_flops = micro_flops * w_local * tau * accum
    rec = {"kind": "train", "n_workers": n_workers, "world": world, "tau": tau,
           "grad_accum": accum, "b_micro": b_micro, "seq": seq, "base_opt": base_opt,
           "remat": remat, "remat_policy": remat_policy, "flops": total_flops,
           "microbatch_flops": micro_flops,
           "memory": {"init_bytes": init_bytes, "state_bytes": state_bytes,
                      "local_bytes": local_bytes, "global_bytes": global_bytes,
                      "eval_bytes": eval_bytes,
                      "peak_bytes": max(init_bytes, state_bytes + max(
                          local_bytes, global_bytes, eval_bytes))},
           "kernel_bytes_per_round": kernel_bytes}
    if topo is not None:
        rec["comm"] = topo.stats.as_dict()
        rec["comm_bytes_per_round"] = sum(v["bytes"] for v in rec["comm"].values())
    return _terms(rec, kernel_bytes)


def _terms(rec: dict, nbytes: int) -> dict:
    rec["t_compute_s"] = rec["flops"] / BF16_DENSE_FLOP_PER_S
    rec["t_memory_s"] = nbytes / HBM_BYTES_PER_S
    rec["dominant"] = "compute" if rec["t_compute_s"] >= rec["t_memory_s"] else "memory"
    rec["fits_one_card"] = rec["memory"]["peak_bytes"] <= CARD_BYTES
    rec["card"] = CARD
    return rec


def _shapes(tree) -> list:
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(tree)]


def _serve_record(kind: str, tracker: MemoryTracker, params_bytes: int, flops,
                  nbytes: int) -> dict:
    rec = {"kind": kind, "flops": flops.get_total_flops(),
           "memory": {"params_bytes": params_bytes, "call_bytes": tracker.peak - params_bytes,
                      "peak_bytes": tracker.peak}}
    return _terms(rec, nbytes)


def reckon_prefill(cfg, shape) -> dict:
    """One ``prefill`` call on the spec'd batch, on the params alone."""
    batch = _as_model_batch(specs.prefill_batch_specs(cfg, shape))
    tracker = MemoryTracker()
    with tracker:
        params = specs.abstract_params(cfg)
    params_bytes = tracker.reset_peak()
    with tracker, FlopCounterMode(display=False) as flops, torch.no_grad():
        logits, cache = T.prefill(params, batch, cfg, remat=True)
        n = shape.seq_len
        want = T.init_cache(cfg, shape.global_batch, n, cfg.act_dtype, device=META)
        if tuple(logits.shape) != (shape.global_batch, cfg.padded_vocab):
            raise ValueError(f"prefill logits {tuple(logits.shape)}")
        if _shapes(cache) != _shapes(want):
            raise ValueError("prefill cache shapes differ from init_cache's")
        cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
        del logits, cache, want
    return _serve_record("prefill", tracker, params_bytes, flops, params_bytes + cache_bytes)


def reckon_decode(cfg, shape) -> dict:
    """One ``decode_step`` on the spec'd cache, at its last position."""
    spec = specs.decode_specs(cfg, shape)
    tracker = MemoryTracker()
    with tracker:
        params = specs.abstract_params(cfg)
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len, cfg.act_dtype,
                             device=META)
    base = tracker.reset_peak()
    want = _shapes(spec["cache"])
    with tracker, FlopCounterMode(display=False) as flops, torch.no_grad():
        logits, cache = T.decode_step(params, cache, spec["tokens"].long(),
                                      shape.seq_len - 1, cfg)
        if tuple(logits.shape) != (shape.global_batch, cfg.padded_vocab):
            raise ValueError(f"decode logits {tuple(logits.shape)}")
        if _shapes(cache) != want:
            raise ValueError("decode changed the cache's shapes")
        del logits
    return _serve_record("decode", tracker, base, flops, base)


def reckon(arch: str, shape_name: str, tau: int = None) -> dict:
    """The record of one combination; ``arch`` as the launcher's
    ``--arch`` (``nano``, ``<id>``, ``<id>_smoke``), ``tau`` in place of
    ``TOPO.tau``."""
    cfg, topo = resolve_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        W = topo.n_workers_single
        batch = specs.train_batch_specs(cfg, topo, shape, W)
        lead = batch["tokens"].shape
        rec = reckon_train(cfg, n_workers=W, tau=tau or topo.tau, accum=topo.grad_accum,
                           b_micro=lead[3], seq=shape.seq_len, base_opt=topo.base_opt,
                           remat=topo.remat, remat_policy=topo.remat_policy)
    elif shape.kind == "prefill":
        rec = reckon_prefill(cfg, shape)
    else:
        rec = reckon_decode(cfg, shape)
    return rec


def run_one(arch: str, shape_name: str, outdir: str) -> dict:
    tag = f"{arch}.{shape_name}"
    t0 = time.time()
    try:
        rec = reckon(arch, shape_name)
        rec.update(status="ok", arch=arch, shape=shape_name,
                   seconds=round(time.time() - t0, 1))
    except Exception as e:  # noqa: BLE001 — record failures, they are bugs
        rec = {"status": "error", "arch": arch, "shape": shape_name,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:],
               "seconds": round(time.time() - t0, 1)}
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def combinations(archs: str, shapes: str, smoke: bool = False):
    """``(arch, shape, admitted)`` for every pair, ``admitted`` as the
    reference's ``main`` decides (``arch_supports_shape``); ``smoke`` takes
    each id's SMOKE config (``<id>_smoke``; nano has none)."""
    names = ALL_ARCHS if archs == "all" else tuple(archs.split(","))
    if smoke:
        names = tuple(a if a == "nano" else f"{a}_smoke" for a in names)
    shape_names = list(INPUT_SHAPES) if shapes == "all" else shapes.split(",")
    for arch in names:
        cfg, topo = resolve_arch(arch)
        for s in shape_names:
            yield arch, s, arch_supports_shape(cfg, topo, s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--smoke", action="store_true",
                    help="each id's SMOKE config (<id>_smoke; --arch also takes those names)")
    ap.add_argument("--outdir", default="build/dryrun_torch")
    args = ap.parse_args(argv)
    recs = []
    for arch, shape_name, admitted in combinations(args.arch, args.shape, args.smoke):
        if not admitted:
            print(f"SKIP {arch} x {shape_name} (sub-quadratic archs only)")
            continue
        rec = run_one(arch, shape_name, args.outdir)
        recs.append(rec)
        mark = "OK " if rec["status"] == "ok" else "ERR"
        extra = (f"dom={rec['dominant']} tc={rec['t_compute_s']:.3e} "
                 f"tm={rec['t_memory_s']:.3e} peakGB={rec['memory']['peak_bytes'] / 1e9:.2f}"
                 f"{'' if rec['fits_one_card'] else ' (over one card)'}"
                 if rec["status"] == "ok" else rec["error"][:200])
        print(f"{mark} {arch:28s} {shape_name:12s} ({rec['seconds']}s) {extra}", flush=True)
    return recs


if __name__ == "__main__":
    main()
