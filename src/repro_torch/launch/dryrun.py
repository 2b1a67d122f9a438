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

``--mesh card`` (the default) is that one-card reckoning.  ``--mesh
single|multi|both`` reckons rank 0 of the reference's training grid on its
pod meshes (``distributed.mesh.training_mesh``: (16, 16) or (2, 16, 16)
chips, ``MODEL_PAR`` = 16 on the model axis, W = ``TOPO.n_workers_single``
/ ``n_workers_multi``, ``zero`` = rows / W), as the reference's dry-run
does, with one H100 SXM per rank: its blocks of every leaf by the
placements (``distributed.tensor_parallel.rank_layout``), x0 and m
ZeRO-sharded over its ``(worker, zero)`` ranks, one microbatch through the
model-axis ``loss_fn`` with meta collectives (counted by ``CommStats`` per
group, times W_local * tau * accum), and the global step.  The worker
parameters' and base state's ``zero`` entries are sharded (FSDP,
``ZERO_AXIS``): the rank holds its zero block of its blocks, gathers each
layer at use over its zero group, runs its ``B_micro / Z`` rows where the
batch splits over zero (``batch_over_zero``), and its x0 and m are its chunk
of its zero block over its worker peers.  ``--no-zero-global-buffers``
(the reference's flag, train shapes only) puts x0 and m over ``("zero",)``
only: each worker peer holds the rank's whole zero block of them and the
round takes the replicated global step (``zero_global_buffers`` in the
record; on ``--mesh card`` it changes nothing).  A record carries the
reference's fields (``flops`` per rank, ``collectives`` per kind with
``wire_bytes`` under its ring model, ``memory``, ``t_compute_s`` /
``t_memory_s`` / ``t_collective_s``, ``dominant``, ``n_chips``, ``mesh``)
and ``fits_per_card``.

Prefill and decode on a pod mesh reckon rank 0 of the reference's serving
grid (``distributed.mesh.serving_mesh``: (16, 16), or (32, 16) with the
pod folded into data) through the rank's ``prefill`` / ``decode_step``
(:func:`reckon_serve`): its blocks of every leaf by the serving placement's
``model`` entries, cut once more by its ``data`` entries (FSDP over data,
``DATA_AXIS``: gathered at use per layer and call), its data row's ``B /
D`` sequences where the
batch splits over data (else the whole batch, ``batch_over_data``, with the prompt's positions
and the full-attention caches' slots over data where they divide:
``seq_over_data``, ``cache_slots_over_data``), its cache (the KV heads it
computes, its block of slots: ``cache_bytes_per_rank``, beside the
reference's ``cache_pspecs`` placement's), meta collectives counted per
group, and the training records' fields.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
from repro_torch.models.convert import flatten_tree
from repro_torch.obs import metrics as OM

# NVIDIA H100 SXM 80GB at its 700 W power limit (NVIDIA data sheet): the
# dense bf16 tensor-core peak (989 TFLOP/s; 1979 is with sparsity) and the
# HBM3 rate (the constant chip_smoke.py's kernel bounds use)
CARD = "NVIDIA H100 SXM 80GB, 700 W"
BF16_DENSE_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
CARD_BYTES = 80e9
# the link a pod mesh's collectives cross: NVLink joins the 8 GPUs of a
# node, so a 16-way model group spans two nodes and each rank's worker /
# zero peers sit in other nodes; the network between nodes bounds both
LINK = ("InfiniBand NDR, 400 Gb/s (50 GB/s) per GPU, one ConnectX-7 per GPU "
        "(NVIDIA DGX H100 data sheet): a 16-way model group spans two 8-GPU nodes")
LINK_BYTES_PER_S = 50e9
ZERO_AXIS = ("sharded (FSDP): each rank holds its zero block of its worker params, gradients "
             "and AdamW moments (param_pspecs(..., zero=Z, worker_axis=True)), gathers each "
             "layer at use over its zero group, and runs its B_micro / Z rows where "
             "train_batch_pspecs puts B_micro on zero (else the whole microbatch)")
DATA_AXIS = ("sharded (FSDP over data): each serving rank holds its data block of every leaf "
             "that param_pspecs(..., zero=D, zero_axes=('data',)) cuts, gathered at use per "
             "layer and call")
# CommStats names -> the reference's collective kinds
COMM_KINDS = {"scatter_rows": "reduce-scatter", "reduce_scatter": "reduce-scatter",
              "all_gather_shards": "all-gather", "gather_workers": "all-gather",
              "all_gather": "all-gather", "all_reduce_sum": "all-reduce",
              "all_reduce_min": "all-reduce", "all_reduce_max": "all-reduce"}
MESHES = {"single": (False,), "multi": (True,), "both": (False, True)}
# bytes each kernel moves per element, by the group's dtype: params,
# gradients and the two f32 moments (AdamW); x0, m and the worker mean (DSM)
ADAMW_BYTES = {torch.bfloat16: 22, torch.float32: 28}
DSM_BYTES = {torch.bfloat16: 14, torch.float32: 20}
META = torch.device("meta")
ATTN_NAMES = ("wq", "wk", "wv", "wo")   # the reference's, left whole unless TOPO.attn_tp
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

    names = ("all_to_all_single", "all_gather", "all_reduce", "gather", "get_global_rank",
             "reduce_scatter")
    saved = {n: getattr(dist, n) for n in names}
    try:
        for n in names:
            setattr(dist, n, lambda *a, **k: 0)
        yield
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def _global_step(state, losses, topo, numels, beta1: float, sharded: bool = True) -> None:
    """The allocations of ``make_dsm_step``'s global phase on the DSM path
    (no faults): over ranks the gather of the losses, the worker mean (over
    ranks the scatter and the shard's mean, or with x0 and m not
    ``sharded`` the scatter and the all-gather of the whole mean), the
    metric pack's stat sums, the DSM kernel (in place, nothing allocated,
    not run), the all-gather of x_{t+1,0} where x0 is sharded, and the
    workers' re-sync (in place)."""
    from repro_torch.distributed import comm
    from repro_torch.distributed import zero as Z

    gamma = 1e-3
    dtopo = None if topo is None else topo.dp
    if topo is not None:
        losses = comm.gather_workers(losses, dtopo, dim=1)
    if topo is None:
        x_tau = D.worker_mean(state.params)
        stat = OM.stat_sums(state.x0, state.m, x_tau, gamma, beta1)
        x0 = state.x0
    elif not sharded:
        x_tau = Z.replicated_worker_mean(state.params, dtopo)
        stat = OM.stat_sums(state.x0, state.m, x_tau, gamma, beta1)
        if topo.fsdp and topo.zero > 1:
            stat = comm.all_reduce(stat, topo.zp, "sum")
        if topo.model > 1:
            stat = comm.all_reduce(stat, topo.mp, "sum")
        x0 = state.x0
    else:
        x_tau = Z.scattered_worker_mean(state.params, dtopo)
        over = topo.wz if topo.fsdp and topo.zero > 1 else None
        stat = Z.sharded_stat_sums(state.x0, state.m, x_tau, gamma, beta1, dtopo, numels,
                                   over=over)
        if topo.model > 1:
            stat = comm.all_reduce(stat, topo.mp, "sum")
        x0 = Z.gather_shards(state.x0, dtopo, numels)
    each(lambda p, x: p.copy_(x.expand_as(p)), state.params, x0)
    del x_tau, stat, x0, losses


def reckon_train(cfg, *, n_workers: int, tau: int, accum: int = 1, b_micro: int, seq: int,
                 base_opt: str = "adamw", remat: bool = False, remat_policy: str = "full",
                 eval_batch: int = 0, keep_x0: bool = True, world: int = 1, model: int = 1,
                 replicate_names: tuple = (), fsdp: bool = False,
                 zero_global_buffers: bool = True) -> dict:
    """One outer step's FLOPs and peak device bytes, on ``meta``.

    ``keep_x0``: the initial x0 stays allocated beside the state, as in
    ``run_training``.  ``eval_batch``: sequences of ``run_training``'s eval
    forward (0: none).  ``world`` > 1 reckons rank 0 of that many ranks with
    the ZeRO-sharded global step and the device-parallel local phase; its
    ``comm`` holds the round's collective calls and bytes as ``CommStats``
    counts them, the model group's (``model`` > 1: ``world / model`` groups
    of ``model`` ranks, the rank holding its blocks of every leaf, leaves
    named in ``replicate_names`` whole) as ``<name>@model``, over one
    microbatch times W_local * tau * accum.  ``fsdp``: the rank's blocks
    cut over its ``zero`` ranks too (``<name>@zero``; the losses'
    all-reduce over them once per round where ``B_micro`` splits), its x0
    and m its chunk over its worker peers.  ``zero_global_buffers`` off
    (the reference dry-run's ``--no-zero-global-buffers``): x0 and m are
    not cut over the worker peers (the ``(worker, zero)`` ranks without
    FSDP), every one of which holds the rank's whole blocks (under FSDP its
    whole zero block) of them, and the round takes the replicated global
    step (``DSMConfig.zero_sharded`` off); the record's
    ``zero_global_buffers`` says which placement it reckoned (False on one
    rank, where x0 and m are whole)."""
    from repro_torch.distributed import comm as CM
    from repro_torch.distributed import mesh
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.comm import CommStats

    base = BO.get_base_optimizer(base_opt)
    topo = None
    if world > 1:
        worker, zero = mesh.grid(n_workers, world, model)
        marker = object() if model > 1 else None
        cut = fsdp and zero > 1
        topo = mesh.Topology(n_workers, worker, zero, rank=0, group=object(),
                             backend="nccl", model=model, dp_group=object(),
                             model_group=marker, fsdp="zero" if cut else "",
                             zero_group=object() if cut else None,
                             peer_group=object() if cut and worker > 1 else None)
    lay = (T.layout(cfg) if topo is None else TP.topology_layout(cfg, topo, replicate_names))
    w_local = n_workers if topo is None else topo.local_workers
    split = TP.zero_split(lay, b_micro)
    tracker = MemoryTracker()
    with tracker:
        x0 = lay.empty(device=META)
        sharded = topo is not None and zero_global_buffers
        state = D.dsm_init(x0, base, n_workers, topo, global_sharded=sharded)
        if not keep_x0:
            del x0
        batch = _as_model_batch(specs.batch_specs(cfg, (w_local, tau, accum, b_micro), seq))
    # building the state can pass its final size: over ranks dsm_init holds
    # the whole x0 and m until it keeps the rank's shards
    init_bytes, state_bytes = tracker.peak, tracker.live

    tracker.reset_peak()
    with tracker, FlopCounterMode(display=False) as flops, _meta_collectives():
        leaves = lay.autograd_leaves(each(lambda p: p[0], state.params),
                                     each(lambda g: g[0], state.grads))
        if lay.zero > 1:
            leaves.zero_mode = "sum" if split else "slice"
        loss = T.loss_fn(leaves, D.take(batch, 0, 0, 0, TP.zero_rows(lay, b_micro)), cfg,
                         remat=remat, remat_policy=remat_policy)
        loss.backward()
        del loss, leaves
    local_bytes = tracker.peak - state_bytes
    micro_flops = flops.get_total_flops()
    if topo is not None:
        # the model group's collectives of one microbatch, for every one of
        # the round's; the global step's are counted afresh
        scale = w_local * tau * accum
        comm = {k: {"calls": v["calls"] * scale, "bytes": v["bytes"] * scale}
                for k, v in topo.stats.as_dict().items()}
        topo = dataclasses.replace(topo, stats=CommStats())

    tracker.reset_peak()
    with tracker, _meta_collectives():
        losses = torch.empty(tau, w_local, device=META)
        if split:
            # the local phase's end: a worker's loss, the mean of its zero ranks'
            CM.all_reduce(losses, topo.zp, "sum")
        _global_step(state, losses, topo, lay.group_numels, D.DSMConfig().beta1, sharded)
        del losses
    global_bytes = tracker.peak - state_bytes

    eval_bytes = 0
    if eval_batch:
        tracker.reset_peak()
        with tracker, torch.no_grad(), _meta_collectives():
            # run_training's eval_params: x0, or over ranks the worker row
            x0v = lay.views(state.x0 if topo is None else each(lambda p: p[0], state.params))
            T.loss_fn(x0v, _micro(cfg, eval_batch, seq), cfg, remat=False)
            del x0v
        eval_bytes = tracker.peak - state_bytes

    rows = [(dt, n) for dt, n in zip(lay.dtypes, lay.group_numels)]
    shard = (lambda n: -(-n // topo.dp.world)) if sharded else (lambda n: n)
    kernel_bytes = sum(n * w_local * tau * ADAMW_BYTES[dt] * (base_opt == "adamw")
                       + shard(n) * DSM_BYTES[dt] for dt, n in rows)
    total_flops = micro_flops * w_local * tau * accum
    rec = {"kind": "train", "n_workers": n_workers, "world": world, "tau": tau,
           "grad_accum": accum, "b_micro": b_micro, "seq": seq, "base_opt": base_opt,
           "remat": remat, "remat_policy": remat_policy, "zero_global_buffers": sharded,
           "flops": total_flops,
           "microbatch_flops": micro_flops,
           "memory": {"init_bytes": init_bytes, "state_bytes": state_bytes,
                      "local_bytes": local_bytes, "global_bytes": global_bytes,
                      "eval_bytes": eval_bytes,
                      "peak_bytes": max(init_bytes, state_bytes + max(
                          local_bytes, global_bytes, eval_bytes))},
           "kernel_bytes_per_round": kernel_bytes}
    if topo is not None:
        for k, v in topo.stats.as_dict().items():
            have = comm.setdefault(k, {"calls": 0, "bytes": 0})
            have["calls"] += v["calls"]
            have["bytes"] += v["bytes"]
        rec["comm"] = comm
        rec["comm_bytes_per_round"] = sum(v["bytes"] for v in rec["comm"].values())
        rec["model"] = model
        if fsdp:
            rec.update(fsdp=True, zero=zero, batch_over_zero=split)
    return _terms(rec, kernel_bytes)


def collectives(comm: dict) -> dict:
    """Bytes per collective kind of a ``CommStats`` dict (both groups), and
    ``wire_bytes`` under the reference's ring model: an all-reduce moves
    about twice its payload, the others once (``dryrun.py:75-96``)."""
    out = {k: 0 for k in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                          "collective-permute")}
    for name, rec in comm.items():
        out[COMM_KINDS[name.split("@")[0]]] += rec["bytes"]
    out["wire_bytes"] = (2 * out["all-reduce"] + out["all-gather"] + out["reduce-scatter"]
                         + out["all-to-all"] + out["collective-permute"])
    return out


def reckon_pod(arch: str, shape_name: str, multi_pod: bool, tau: int = None,
               zero_global_buffers: bool = True) -> dict:
    """Rank 0 of the reference's grid on its pod mesh, for one H100 SXM per
    rank, with the reference's record fields: at train shapes its training
    grid (``training_mesh(make_production_mesh(multi_pod), W)``), at
    serving shapes its serving grid (``serving_mesh``, :func:`reckon_serve`),
    with the reference's FSDP placement over zero (data).
    ``zero_global_buffers`` off (train shapes only, as the reference's
    ``--no-zero-global-buffers``): x0 and m over ``("zero",)`` only, the
    rank's whole zero block of them on every worker peer
    (:func:`reckon_train`)."""
    from repro_torch.distributed import mesh
    from repro_torch.launch.train import resolve_arch

    cfg, topo = resolve_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    base = mesh.make_production_mesh(multi_pod=multi_pod)
    if shape.kind != "train":
        grid = mesh.serving_mesh(base)
        dims = mesh.mesh_dims(grid)
        rec = reckon_serve(cfg, shape.kind, shape.global_batch, shape.seq_len, dims["data"],
                           dims["model"], fsdp=True)
        rec.update(data_axis=DATA_AXIS)
        return _pod_terms(rec, grid, multi_pod)
    W = topo.n_workers_multi if multi_pod else topo.n_workers_single
    grid = mesh.training_mesh(base, W)
    dims = mesh.mesh_dims(grid)
    lead = specs.train_batch_specs(cfg, topo, shape, W)["tokens"].shape
    rep = () if topo.attn_tp else ATTN_NAMES
    rec = reckon_train(cfg, n_workers=W, tau=tau or topo.tau, accum=topo.grad_accum,
                       b_micro=lead[3], seq=shape.seq_len, base_opt=topo.base_opt,
                       remat=topo.remat, remat_policy=topo.remat_policy, world=grid.size,
                       model=dims["model"], replicate_names=rep, fsdp=True,
                       zero_global_buffers=zero_global_buffers)
    rec.update(zero_axis=ZERO_AXIS,
               state_bytes_per_rank=rec["memory"]["state_bytes"])
    return _pod_terms(rec, grid, multi_pod)


def _pod_terms(rec: dict, grid, multi_pod: bool) -> dict:
    """A rank's record on a pod mesh: its collectives per kind, their time
    over ``LINK``, the dominant of the three terms, whether it fits a card."""
    from repro_torch.distributed import mesh

    coll = collectives(rec["comm"])
    rec.update(collectives=coll, t_collective_s=coll["wire_bytes"] / LINK_BYTES_PER_S,
               link=LINK, n_chips=grid.size, mesh=mesh.mesh_dims(grid), multi_pod=multi_pod,
               fits_per_card=rec["memory"]["peak_bytes"] <= CARD_BYTES)
    rec["dominant"] = max((("compute", rec["t_compute_s"]), ("memory", rec["t_memory_s"]),
                           ("collective", rec["t_collective_s"])), key=lambda kv: kv[1])[0]
    return rec


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache))


def reference_cache_bytes(cfg, batch: int, max_len: int, data: int, model: int) -> int:
    """A rank's bytes of the whole batch's cache of ``max_len`` positions
    under the reference's placement (``sharding.cache_pspecs``: the batch
    dim, else the next divisible one, over data; the last divisible dim
    over model)."""
    from repro_torch.distributed import sharding

    cache = T.init_cache(cfg, batch, max_len, cfg.act_dtype, device=META)
    leaves = dict(flatten_tree(cache, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    sizes = {"data": data, "model": model}
    total = 0
    for path, spec in sharding.cache_pspecs(cache, data, model).items():
        cut = 1
        for entry in spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                cut *= sizes.get(ax, 1)
        total += leaves[path].numel() * leaves[path].element_size() // cut
    return total


def reckon_serve(cfg, kind: str, batch: int, seq: int, data: int = 1, model: int = 1,
                 new: int = 0, fsdp: bool = False) -> dict:
    """Rank 0 of a ``(data, model)`` serving grid on ``meta``, its FLOPs,
    peak bytes and collectives: ``kind`` ``"prefill"`` (one ``prefill``, as
    the reference's ``build_prefill``: remat on, a ``batch`` x ``seq``
    batch of the family's spec, on the rank's blocks as they are),
    ``"decode"`` (one ``decode_step`` on a cache of ``seq`` positions, at
    its last, on params ``transformer.serving_params`` resolved beforehand,
    as ``generate``'s every step) or ``"generate"``
    (``train.serve.generate`` of ``new`` tokens after a ``seq``-token
    prompt, a VLM's patches or an encdec's frames beside it, greedy).  The
    rank holds its blocks of every leaf (``tensor_parallel.rank_layout``
    with ``model`` > 1) and serves its rows (``tensor_parallel.serve_rows``);
    ``comm`` is its ``CommStats`` (``<name>@model``, ``<name>@data``).
    ``fsdp``: the blocks cut over data too, gathered at use per layer and
    call (``mesh.serving_topology(..., fsdp=True)``).  Where the batch does
    not split over data (``batch_over_data`` false) the rank serves the
    whole batch over the split ``tensor_parallel.serve_split`` gives: a
    prefill's chunk of the sequence, a full-attention cache's block of
    slots, each where it divides (``seq_over_data``,
    ``cache_slots_over_data``)."""
    from repro_torch.distributed import mesh
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.train.serve import generate

    if kind not in ("prefill", "decode", "generate"):
        raise ValueError(f"kind must be 'prefill', 'decode' or 'generate', got {kind!r}")
    topo = mesh.Topology(data, data, 1, rank=0, group=object(), backend="nccl", model=model,
                         dp_group=object(), model_group=object() if model > 1 else None,
                         fsdp="data" if fsdp else "")
    lay = TP.topology_layout(cfg, topo)
    rows = TP.serve_rows(batch, topo)
    b = rows.stop - rows.start
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    length = n_prefix + seq + new if kind == "generate" else seq
    # the positions the call prefills (none: a decode step alone)
    n0 = {"prefill": seq, "decode": 0, "generate": n_prefix + seq}[kind]
    chunk, slots = TP.serve_split(batch, n0, length - n0, cfg, data, 0, topo.data)
    tracker = MemoryTracker()
    cache = None
    with tracker, torch.no_grad(), _meta_collectives():
        params = lay.views(lay.empty(device=META))
        if kind == "decode":
            # generate resolves its params once, then decodes token by token
            params = T.serving_params(params, cfg)
            cache = T.init_cache(cfg, b, seq, cfg.act_dtype, device=META, layout=lay,
                                 slots=slots)
    topo.stats.reset()
    base = tracker.reset_peak()
    params_bytes = sum(n * dt.itemsize for dt, n in zip(lay.dtypes, lay.group_numels))
    rank_cache = T.init_cache(cfg, b, length, cfg.act_dtype, device=META, layout=lay,
                              slots=slots)
    want = _shapes(rank_cache)
    vocab = cfg.padded_vocab // model if T.logits_split(params, cfg) else cfg.padded_vocab
    with tracker, FlopCounterMode(display=False) as flops, torch.no_grad(), _meta_collectives():
        if kind == "prefill":
            inputs = _as_model_batch(specs.batch_specs(cfg, (b,), seq))
            logits, cache = T.prefill(params, inputs, cfg, remat=True, seq=chunk, slots=slots)
            if _shapes(cache) != want:
                raise ValueError("prefill cache shapes differ from the rank's init_cache's")
        elif kind == "decode":
            tokens = torch.empty(b, dtype=torch.long, device=META)
            logits, cache = T.decode_step(params, cache, tokens, seq - 1, cfg, slots=slots)
            if _shapes(cache) != want:
                raise ValueError("decode changed the cache's shapes")
        else:
            prompt = _as_model_batch(specs.batch_specs(cfg, (batch,), seq + n_prefix))
            toks, _ = generate(params, cfg, prompt.pop("tokens"), new, extra_batch=prompt,
                               device=META, topo=topo)
            logits = torch.empty(b, vocab, device=META)
            if tuple(toks.shape) != (batch, new):
                raise ValueError(f"generate tokens {tuple(toks.shape)}")
            del toks
        if tuple(logits.shape) != (b, vocab):
            raise ValueError(f"{kind} logits {tuple(logits.shape)}, want {(b, vocab)}")
        del logits, cache
    nbytes = cache_bytes(rank_cache)
    rec = {"kind": kind, "batch": batch, "batch_per_rank": b, "seq": seq, "new_tokens": new,
           "data": data, "model": model, "batch_over_data": batch % data == 0 and batch >= data,
           "flops": flops.get_total_flops(),
           "memory": {"params_bytes": params_bytes, "cache_bytes_per_rank": nbytes,
                      "cache_bytes_per_rank_reference_placement": reference_cache_bytes(
                          cfg, batch, length, data, model),
                      "call_bytes": tracker.peak - base, "peak_bytes": tracker.peak},
           "comm": topo.stats.as_dict()}
    if not rec["batch_over_data"]:
        full = any(T._parse_kind(k)[0] in ("attn", "xattn") for k in cfg.pattern)
        rec.update(seq_over_data=chunk is not None,
                   cache_slots_over_data=slots is not None and full)
    return _terms(rec, params_bytes + nbytes)


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


def run_one(arch: str, shape_name: str, outdir: str, multi_pod=None,
            zero_global_buffers: bool = True) -> dict:
    """One record: the one-card reckoning (``multi_pod`` None), or rank 0
    of a pod mesh (False: single pod, True: two pods; ``zero_global_buffers``
    as :func:`reckon_pod`'s)."""
    tag = f"{arch}.{shape_name}" + ("" if multi_pod is None else
                                    f".{'multipod' if multi_pod else 'singlepod'}")
    t0 = time.time()
    try:
        if multi_pod is None:
            rec = reckon(arch, shape_name)
        else:
            rec = reckon_pod(arch, shape_name, multi_pod,
                             zero_global_buffers=zero_global_buffers)
        rec.setdefault("status", "ok")
        rec.update(arch=arch, shape=shape_name, seconds=round(time.time() - t0, 1))
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
    ap.add_argument("--mesh", choices=("card",) + tuple(MESHES), default="card",
                    help="card: one H100 (default); single / multi / both: rank 0 of the "
                         "reference's pod training grid, MODEL_PAR on the model axis")
    ap.add_argument("--no-zero-global-buffers", action="store_true",
                    help="train shapes on a pod mesh: x0 and m over zero only, every worker "
                         "peer holding the rank's whole zero block of them (the default cuts "
                         "them over the worker peers too)")
    args = ap.parse_args(argv)
    recs = []
    pods = (None,) if args.mesh == "card" else MESHES[args.mesh]
    for arch, shape_name, admitted in combinations(args.arch, args.shape, args.smoke):
        if not admitted:
            print(f"SKIP {arch} x {shape_name} (sub-quadratic archs only)")
            continue
        for mp in pods:
            kw = {}
            if INPUT_SHAPES[shape_name].kind == "train" and args.no_zero_global_buffers:
                kw["zero_global_buffers"] = False
            rec = run_one(arch, shape_name, args.outdir, mp, **kw)
            recs.append(rec)
            _report(rec, mp)
    return recs


def _report(rec: dict, multi_pod) -> None:
    mark = "OK " if rec["status"] == "ok" else "ERR"
    where = "" if multi_pod is None else ("multi  " if multi_pod else "single ")
    if rec["status"] == "ok":
        extra = (f"dom={rec['dominant']} tc={rec['t_compute_s']:.3e} "
                 f"tm={rec['t_memory_s']:.3e} "
                 + (f"tn={rec['t_collective_s']:.3e} " if multi_pod is not None else "")
                 + f"peakGB={rec['memory']['peak_bytes'] / 1e9:.2f}")
        fits = rec["fits_one_card"] if multi_pod is None else rec["fits_per_card"]
        extra += "" if fits else (" (over one card)" if multi_pod is None else
                                  " (over one card per rank)")
    else:
        extra = rec.get("reason", rec.get("error", ""))[:200]
    print(f"{mark} {rec['arch']:28s} {rec['shape']:12s} {where}({rec['seconds']}s) {extra}",
          flush=True)


if __name__ == "__main__":
    main()
