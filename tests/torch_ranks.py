"""What the port's multi-rank tests and ``chip_smoke.py`` run in each
rank's process.

``repro_torch.distributed.spawn.run_ranks`` starts every rank in a fresh
process, which imports the function it runs by name; these live apart from
the test files so that a rank imports neither JAX nor the JAX package."""

import contextlib
import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.dsm import DSMConfig
from repro_torch.distributed import mesh
from repro_torch.distributed import zero as Z
from repro_torch.groups import Groups, each
from repro_torch.models.convert import state_fields
from repro_torch.robustness.faults import FaultRound


def flat_state(state, prefix: str = "") -> dict:
    """``{dotted field name: tensor or int}`` of a training state on the
    CPU, less its scratch buffers (``params``, ``x0``, ``base_state.m``...).
    A mixed-dtype model's buffer names each group's tensor apart, in the
    dense layout of its group: ``x0.0``, ``x0.1``, ``base_state.m.1``."""
    out = {}
    for name, v in state_fields(state):
        if isinstance(v, Groups):
            out.update({f"{prefix}{name}.{i}": t.cpu() for i, t in enumerate(v)})
        elif isinstance(v, torch.Tensor):
            out[prefix + name] = v.cpu()
        elif isinstance(v, int):
            out[prefix + name] = v
        else:
            out.update(flat_state(v, f"{prefix}{name}."))
    return out


def train_rank(rank: int, world: int, cfg, settings: list, device: str = "cpu",
               params: Optional[torch.Tensor] = None, corpus=None,
               fields: Optional[tuple] = None) -> list:
    """A training run on this rank: ``run_training`` on the default group,
    collectives timed, for each of ``settings`` in turn.  Each result (on
    the CPU) holds ``history``, ``eval_losses``, ``final_eval``,
    ``skipped_rounds``, ``rollbacks``, ``outer_step_s``, ``comm``,
    ``final_metrics``, ``peak_bytes`` (on the card) and this process's kernel
    ``launches`` in the run (with a ``run_dir``, those of the post-run phase
    probe are apart, in ``probe_launches``); on
    rank 0 also ``state``, the final state in the dense layout
    (:func:`flat_state`), or only its ``fields`` of the DSM state (for
    example ``("x0", "m")``, which a full-width run gathers without the
    workers' rows).  ``cfg`` and ``params`` may be lists, one entry per
    settings entry, so that one start of the ranks trains several models."""
    from repro_torch import kernels as K
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import run_training, splits_workers

    group = dist.group.WORLD
    cfgs = cfg if isinstance(cfg, list) else [cfg] * len(settings)
    inits = params if isinstance(params, list) else [params] * len(settings)
    out = []
    for cfg, params, s in zip(cfgs, inits, settings, strict=True):
        numels = T.layout(cfg).group_numels
        K.reset_launch_counts()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res = run_training(cfg, s, corpus, device=device, params=params, group=group,
                           time_collectives=True)
        probe = res["probe_launches"] or {}
        res["launches"] = {k: n - probe.get(k, 0) for k, n in K.launch_counts().items()}
        state = res.pop("state")
        topo = mesh.topology(s.n_workers, group) if splits_workers(s) else None
        if fields is not None:
            state = {k: getattr(state, k) if topo is None else Z.gather_state(
                getattr(state, k), topo, numels) for k in fields}
        elif topo is not None:
            state = Z.gather_state(state, topo, numels)
        if rank == 0:
            res["state"] = flat_state(state)
        out.append(res)
        del state
    return out


def global_step_rank(rank: int, world: int, cases: list) -> list:
    """Each case's ZeRO pieces on this rank: the scattered and replicated
    worker means, the stat sums, and the sharded global step (x0 / m
    gathered).  A case: ``params`` (W, N), ``x0``, ``m`` (numpy f32),
    ``dtype``, ``weights`` ((W,) or None), ``gamma``, ``cfg`` (DSMConfig
    keywords), ``seed`` (the generator of the randomized signs)."""
    out = []
    for c in cases:
        dt = getattr(torch, c["dtype"])
        n_workers, n = c["params"].shape
        topo = mesh.topology(n_workers, dist.group.WORLD)
        rows = torch.from_numpy(c["params"][topo.worker_slice]).to(dt)
        weights = None if c["weights"] is None else torch.from_numpy(c["weights"])
        a, b = Z.my_bounds(n, topo)
        x_tau = Z.scattered_worker_mean(rows, topo, weights)
        x0 = torch.from_numpy(c["x0"][a:b]).to(dt)
        m = torch.from_numpy(c["m"][a:b])
        cfg = DSMConfig(**c["cfg"])
        stat = Z.sharded_stat_sums(x0, m, x_tau, c["gamma"], cfg.beta1, topo, (n,))
        rng = torch.Generator().manual_seed(c["seed"])
        Z.sharded_global_sign_momentum_step(x0, m, x_tau, c["gamma"], cfg, topo, (n,), rng)
        out.append({"bounds": (a, b), "x_tau": x_tau,
                    "x_tau_full": Z.replicated_worker_mean(rows, topo, weights),
                    "stat": stat, "x0": Z.gather_shards(x0, topo, (n,)),
                    "m": Z.gather_shards(m, topo, (n,))})
    return out


def collectives_rank(rank: int, world: int, n_workers: int) -> dict:
    """Each collective of ``comm`` on small tensors of known values."""
    from repro_torch.distributed import comm

    topo = mesh.topology(n_workers, dist.group.WORLD)
    w = topo.worker_index
    losses = torch.tensor([[10.0 * w + k] for k in range(3)])          # (tau=3, W_local=1)
    total = comm.all_reduce(torch.tensor([rank + 1.0]), topo, "sum")
    low = comm.all_reduce(torch.tensor([rank + 1], dtype=torch.int32), topo, "min")
    root = comm.gather_to_root(torch.full((2,), rank, dtype=torch.bfloat16), topo)
    comm.barrier(topo, "cpu")
    return {"losses": comm.gather_workers(losses, topo, dim=1), "sum": total, "min": low,
            "root": root, "stats": topo.stats.as_dict(),
            "grid": (topo.worker, topo.zero, topo.worker_index, topo.zero_index,
                     topo.worker_slice.start, topo.worker_slice.stop)}


def outer_steps_rank(rank: int, world: int, n_workers: int, flags: dict, rounds: list) -> list:
    """The metric packs of nano DSM outer steps (AdamW, tau 2) on this rank,
    one per ``rounds`` entry: None (dense round) or the (W,) survivor /
    stale / corrupt masks of a fault round."""
    from repro_torch.configs.nano import NANO
    from repro_torch.core import base_opt, schedules
    from repro_torch.core.dsm import dsm_init, make_dsm_step
    from repro_torch.data.pipeline import MarkovCorpus, dsm_batches
    from repro_torch.models import transformer as T
    from repro_torch.robustness.faults import FaultRound

    topo = None if world == 0 else mesh.topology(n_workers, dist.group.WORLD)
    base = base_opt.adamw()
    lay = T.layout(NANO)
    step = make_dsm_step(lambda p, mb: T.loss_fn(p, mb, NANO, remat=False), base,
                         DSMConfig(tau=2, global_lr=0.3, **flags), schedules.constant(5e-3), lay,
                         topo)
    x0 = T.init_params(torch.Generator().manual_seed(0), NANO)
    state = dsm_init(x0, base, n_workers, topo, flags.get("zero_sharded", False))
    rows = slice(None) if topo is None else topo.worker_slice
    batches = dsm_batches(MarkovCorpus(NANO.vocab_size, seed=1), n_workers, 2, 1, 2, 32, seed=0)
    packs = []
    for masks in rounds:
        batch = {"tokens": torch.from_numpy(next(batches)["tokens"][rows]).long()}
        faults = None if masks is None else FaultRound(*(torch.tensor(m) for m in masks))
        state, metrics = step(state, batch, None, faults)
        packs.append(metrics["pack"])
    return packs


def batch_dict_steps_rank(rank: int, world: int, cfg, n_workers: int, flags: dict, x0,
                          batches: list) -> dict:
    """DSM outer steps (AdamW, constant gamma 1e-3, eta 0.5) of ``cfg`` on
    the batch dicts of ``batches`` (numpy leaves (W, tau, 1, B_micro, ...),
    ``tokens`` as int ids): every leaf's rows of this rank's workers, as the
    trainer slices a batch.  ``world == 0`` runs the dense path in this
    process.  Runs on one torch thread, so that the CPU's matmuls split
    their sums alike in every process.  Returns the losses and the final x0
    and m (gathered from the shards)."""
    from repro_torch.core import base_opt, schedules
    from repro_torch.core.dsm import dsm_init, make_dsm_step
    from repro_torch.models import transformer as T

    torch.set_num_threads(1)
    topo = None if world == 0 else mesh.topology(n_workers, dist.group.WORLD)
    base = base_opt.adamw()
    lay = T.layout(cfg)
    tau = batches[0]["tokens"].shape[1]
    step = make_dsm_step(lambda p, mb: T.loss_fn(p, mb, cfg, remat=False), base,
                         DSMConfig(tau=tau, global_lr=0.5, **flags), schedules.constant(1e-3),
                         lay, topo)
    state = dsm_init(x0, base, n_workers, topo, flags.get("zero_sharded", False))
    rows = slice(None) if topo is None else topo.worker_slice
    losses = []
    for raw in batches:
        batch = {k: torch.from_numpy(v[rows]) for k, v in raw.items()}
        batch["tokens"] = batch["tokens"].long()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    sharded = topo is not None and flags.get("zero_sharded", False)
    numels = lay.group_numels
    return {"losses": losses,
            **{k: Z.gather_shards(getattr(state, k), topo, numels) if sharded
               else getattr(state, k)
               for k in ("x0", "m")}}


def groups_step_rank(rank: int, world: int, cases: list) -> list:
    """Each case's ZeRO pieces on a buffer of dtype groups on this rank: the
    scattered and replicated worker means, the stat sums, the sharded global
    step (x0 / m gathered), this rank's collectives.  A case: per group
    (each a list) ``params`` (W, n_g), ``x0``, ``m`` (numpy f32), ``dtype``;
    and ``gamma``, ``cfg`` (DSMConfig keywords), ``seed`` (the generator of
    the randomized signs)."""
    return [_groups_step(c) for c in cases]


def _groups_step(case: dict) -> dict:
    from repro_torch.groups import parts

    n_workers = case["params"][0].shape[0]
    topo = mesh.topology(n_workers, dist.group.WORLD)
    numels = tuple(p.shape[1] for p in case["params"])
    dts = [getattr(torch, d) for d in case["dtype"]]
    rows = Groups(torch.from_numpy(p[topo.worker_slice]).to(dt)
                  for p, dt in zip(case["params"], dts))
    bounds = [Z.my_bounds(n, topo) for n in numels]
    x_tau = Z.scattered_worker_mean(rows, topo)
    x0 = Groups(torch.from_numpy(x[a:b]).to(dt) for x, (a, b), dt in
                zip(case["x0"], bounds, dts))
    m = Groups(torch.from_numpy(x[a:b]) for x, (a, b) in zip(case["m"], bounds))
    cfg = DSMConfig(**case["cfg"])
    stat = Z.sharded_stat_sums(x0, m, x_tau, case["gamma"], cfg.beta1, topo, numels)
    rng = torch.Generator().manual_seed(case["seed"])
    Z.sharded_global_sign_momentum_step(x0, m, x_tau, case["gamma"], cfg, topo, numels, rng)
    return {"bounds": bounds, "x_tau": list(parts(x_tau)),
            "x_tau_full": list(parts(Z.replicated_worker_mean(rows, topo))),
            "stat": stat, "x0": list(parts(Z.gather_shards(x0, topo, numels))),
            "m": list(parts(Z.gather_shards(m, topo, numels))), "comm": topo.stats.as_dict()}


def groups_state_rank(rank: int, world: int, cfg, n_workers: int, global_sharded: bool) -> dict:
    """A DSM + AdamW state of ``cfg`` (every buffer random, from seed 0) in
    the dense layout, this rank's part of it loaded from a
    :func:`~repro_torch.distributed.zero.dense_host` template through
    ``load_local_part``, and that part gathered back to rank 0 with
    ``gather_state``; each as :func:`flat_state`, the dense one and the
    gathered one on rank 0 only."""
    from repro_torch.core.base_opt import adamw
    from repro_torch.core.dsm import dsm_init
    from repro_torch.models import transformer as T
    from repro_torch.robustness.guards import state_tensors

    topo = mesh.topology(n_workers, dist.group.WORLD)
    lay = T.layout(cfg)
    gen = torch.Generator().manual_seed(0)
    dense = dsm_init(lay.empty(), adamw(), n_workers)
    for t in state_tensors(dense):
        t.copy_(torch.randn(t.shape, generator=gen))
    dense.t, dense.inner = 3, 36
    mine = dsm_init(each(torch.zeros_like, lay.empty()), adamw(), n_workers, topo,
                    global_sharded)
    template = Z.dense_host(mine, topo, lay.group_numels)
    for dst, src in zip(state_tensors(template), state_tensors(dense), strict=True):
        dst.copy_(src)
    template.t, template.inner = dense.t, dense.inner
    Z.load_local_part(mine, template, topo)
    gathered = Z.gather_state(mine, topo, lay.group_numels)
    return {"dense": flat_state(dense) if rank == 0 else None, "mine": flat_state(mine),
            "gathered": flat_state(gathered) if rank == 0 else None,
            "bounds": [Z.my_bounds(n, topo) for n in lay.group_numels]}


def recorded_collectives_rank(rank: int, world: int, n_workers: int) -> dict:
    """Each collective of ``comm`` under one ``CollectiveRecorder``, then
    torch.distributed's own forbidden kinds under another: the recorded ops
    and this rank's ``CommStats``."""
    from repro_torch.analysis.collective_audit import CollectiveRecorder
    from repro_torch.distributed import comm

    topo = mesh.topology(n_workers, dist.group.WORLD)
    rows = torch.arange(2 * 300, dtype=torch.bfloat16).reshape(2, 300)[:topo.local_workers]
    with CollectiveRecorder() as rec:
        comm.gather_workers(torch.ones(3, topo.local_workers), topo, dim=1)
        comm.scatter_rows(rows, topo, Z.chunk_size(300, world))
        comm.all_gather_shards(torch.ones(Z.chunk_size(300, world)), topo,
                               Z.chunk_size(300, world), 300)
        comm.all_reduce(torch.ones(7), topo, "sum")
        comm.all_reduce(torch.ones(1, dtype=torch.int32), topo, "min")
        comm.gather_to_root(torch.ones(5, dtype=torch.bfloat16), topo)
        comm.barrier(topo, "cpu")
    with CollectiveRecorder() as raw:
        dist.barrier()
        dist.broadcast(torch.ones(4), 0)
        dist.all_gather_into_tensor(torch.empty(world * 4), torch.ones(4))
        dist.all_to_all_single(torch.empty(world * 2), torch.ones(world * 2))
        if rank == 0:
            dist.send(torch.ones(2), 1)
        elif rank == 1:
            dist.recv(torch.empty(2), 0)
    return {"ops": rec.ops, "raw": raw.ops, "stats": topo.stats.as_dict()}


def planted_barrier_rank(rank: int, world: int, n_workers: int) -> dict:
    """The audit of a nano device-parallel local phase whose loss calls
    ``torch.distributed.barrier()``: a collective inside the local steps."""
    from repro_torch.analysis.collective_audit import CollectiveBudget, audit_call
    from repro_torch.configs.nano import NANO
    from repro_torch.core import base_opt
    from repro_torch.core.dsm import dsm_init, make_local_phase
    from repro_torch.models import transformer as T

    topo = mesh.topology(n_workers, dist.group.WORLD)
    lay = T.layout(NANO)

    def loss(p, mb):
        dist.barrier()
        return T.loss_fn(p, mb, NANO, remat=False)

    base = base_opt.adamw()
    state = dsm_init(T.init_params(torch.Generator().manual_seed(0), NANO), base, n_workers,
                     topo)
    local = make_local_phase(loss, base, lay)
    tokens = torch.randint(0, NANO.vocab_size, (topo.local_workers, 2, 1, 2, 16),
                           generator=torch.Generator().manual_seed(0))
    report = audit_call(local, (state, {"tokens": tokens}, 1e-3),
                        CollectiveBudget.for_phase("local", lay, world, n_workers),
                        "local_phase_planted_barrier", topo.stats)
    return report.to_json()


def dp_audit(rank: int, world: int, cfg, n_workers: int, tau: int, params) -> dict:
    """The reference's in-test audit (``tests/test_device_parallel.py``): the
    device-parallel local phase of ``cfg`` issues ZERO collectives (the
    ``local`` budget), one outer step fits the ``global_dense`` budget."""
    from repro_torch.analysis.collective_audit import CollectiveBudget, audit_call
    from repro_torch.core import base_opt, schedules
    from repro_torch.core.dsm import dsm_init, make_dsm_step, make_local_phase
    from repro_torch.models import transformer as T

    topo = mesh.topology(n_workers, dist.group.WORLD)
    lay = T.layout(cfg)
    base = base_opt.adamw()
    tokens = torch.randint(0, cfg.vocab_size, (n_workers, tau, 1, 2, 32),
                           generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens[topo.worker_slice]}
    state = dsm_init(params, base, n_workers, topo)
    local = make_local_phase(lambda p, mb: T.loss_fn(p, mb, cfg, remat=False), base, lay)
    step = make_dsm_step(lambda p, mb: T.loss_fn(p, mb, cfg, remat=False), base,
                         DSMConfig(tau=tau, device_parallel_local=True),
                         schedules.constant(2e-2), lay, topo)
    budget = CollectiveBudget.for_phase
    return {"local_phase": audit_call(local, (state, batch, 2e-2),
                                      budget("local", lay, world, n_workers), "local_phase",
                                      topo.stats).to_json(),
            "outer_step": audit_call(step, (state, batch),
                                     budget("global_dense", lay, world, n_workers),
                                     "outer_step", topo.stats).to_json()}


def oversized_chunk_rank(rank: int, world: int, n_workers: int, tau: int) -> dict:
    """:func:`dp_audit`'s outer step at nano twice, each time with a lowering
    that sends twice the bytes it should: a copy of ``comm.scatter_rows``
    that pads every column chunk to twice its size, and then
    ``zero.chunk_size`` inflated twice over (the sharding the budget must
    not take its ceilings from).  ``{plant: outer step's report}``."""
    from repro_torch.configs.nano import NANO
    from repro_torch.distributed import comm
    from repro_torch.models import transformer as T

    scatter_rows, chunk_size = comm.scatter_rows, Z.chunk_size

    def padded_scatter(rows, topo, chunk):
        n_local, n = rows.shape
        flat = rows.new_zeros(n_local, topo.world * chunk)
        flat[:, :n] = rows
        wide = rows.new_zeros(n_local, topo.world, 2 * chunk)
        wide[:, :, :chunk] = flat.view(n_local, topo.world, chunk)
        return scatter_rows(wide.view(n_local, -1), topo, 2 * chunk)[:, :chunk]

    params = T.init_params(torch.Generator().manual_seed(0), NANO)
    out = {}
    for plant, module, name, fn in (
            ("padded_scatter_rows", comm, "scatter_rows", padded_scatter),
            ("inflated_chunk_size", Z, "chunk_size", lambda n, s: 2 * chunk_size(n, s))):
        setattr(module, name, fn)
        try:
            out[plant] = dp_audit(rank, world, NANO, n_workers, tau, params)["outer_step"]
        finally:
            comm.scatter_rows, Z.chunk_size = scatter_rows, chunk_size
    return out


def train_and_audit_rank(rank: int, world: int, cfg, settings: list, device: str = "cpu",
                         params=None) -> list:
    """:func:`train_rank`'s results, then :func:`dp_audit` at the first
    settings' worker count and tau, in the same start of the ranks."""
    out = train_rank(rank, world, cfg, settings, device, params)
    return out + [dp_audit(rank, world, cfg, settings[0].n_workers, settings[0].tau, params)]


def tp_losses_rank(rank: int, world: int, cases: list) -> list:
    """:func:`tp_loss_rank` for each ``(cfg, row, batches[, remat])`` of
    ``cases`` over all ``world`` ranks as one model group, in one start of
    the ranks."""
    return [tp_loss_rank(rank, world, cfg, world, row, batches, remat=bool(remat and remat[0]))
            for cfg, row, batches, *remat in cases]


def tp_loss_rank(rank: int, world: int, cfg, model: int, row, batches: list,
                 n_workers: int = 1, remat: bool = False, replicate_names: tuple = ()) -> dict:
    """The model-axis ``loss_fn`` (``remat``: each pattern repeat
    checkpointed) and its gradient on this rank, for each microbatch of
    ``batches`` (dicts of CPU tensors): ``row`` is the dense ``(N,)``
    params, cut to the rank's blocks (the leaves named in
    ``replicate_names`` whole).  Returns the losses, the rank's gradient
    rows (its layout) and its ``CommStats``."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T

    torch.set_num_threads(1)
    topo = mesh.topology(n_workers, dist.group.WORLD, model=model)
    lay = TP.topology_layout(cfg, topo, replicate_names)
    mine = C.shard_flat(row, T.layout(cfg), lay)
    out = {"losses": [], "grads": [], "index": topo.model_index}
    for mb in batches:
        grad = each(torch.zeros_like, mine)
        leaves = lay.autograd_leaves(mine, grad)
        loss = T.loss_fn(leaves, mb, cfg, remat=remat)
        loss.backward()
        out["losses"].append(loss.detach())
        out["grads"].append(grad)
    out["comm"] = topo.stats.as_dict()
    return out


def sp_losses_rank(rank: int, world: int, cases: list) -> list:
    """Each case (a dict: ``cfg``, ``row``, ``batch``, optionally
    ``replicate`` (leaf names held whole) and ``remat``) over all ``world``
    ranks as one model group: :func:`tp_loss_rank`'s results of ``cfg`` as
    given, with the shape of every block's output (the residual between
    blocks, recorded at ``transformer._apply_block``) under ``shapes``, and
    under ``plain`` its losses and gradient with ``attn_seq_shard`` off."""
    from repro_torch.models import transformer as T

    out = []
    for c in cases:
        run = functools.partial(tp_loss_rank, rank, world, model=world, row=c["row"],
                                batches=[c["batch"]], remat=c.get("remat", False),
                                replicate_names=c.get("replicate", ()))
        shapes, block = [], T._apply_block

        def recording(*a, **k):
            x, aux = block(*a, **k)
            shapes.append(tuple(x.shape))
            return x, aux

        T._apply_block = recording
        try:
            res = run(cfg=c["cfg"])
        finally:
            T._apply_block = block
        plain = run(cfg=dataclasses.replace(c["cfg"], attn_seq_shard=False))
        out.append(dict(res, shapes=shapes, plain={k: plain[k] for k in ("losses", "grads")}))
    return out


def tp_dsm_rank(rank: int, world: int, cfg, n_workers: int, model: int, flags: dict, row,
                batches: list, gamma: float = 1e-3) -> dict:
    """DSM outer steps (AdamW, constant ``gamma``, eta 0.5) of ``cfg`` over
    the ``(worker, zero, model)`` grid of ``world`` ranks, from the dense
    ``(N,)`` params ``row`` cut to this rank's blocks, on the batch dicts of
    ``batches`` (numpy leaves (W, tau, 1, B_micro, ...), this rank's
    workers' rows taken).  Returns per round the losses and this rank's
    x_tau (the worker mean of its blocks, whole), x0 and m (its blocks,
    whole: gathered over its ``(worker, zero)`` ranks under ZeRO), its
    ``CommStats`` and kernel launches; ``world == 0`` runs the dense path
    in this process."""
    torch.set_num_threads(1)
    topo = None if world == 0 else mesh.topology(n_workers, dist.group.WORLD, model=model)
    return dsm_case(topo, cfg, n_workers, flags, row, batches, gamma)


def fsdp_dsm_rank(rank: int, world: int, cases: list) -> list:
    """:func:`dsm_case` for each case of ``cases``, dicts of ``cfg``,
    ``n_workers``, ``model``, ``fsdp`` (the blocks cut over the zero group),
    ``flags``, ``row``, ``batches``, ``gamma`` and optionally ``nan_rank``
    and ``replicate`` (leaf names held whole on every model rank), over the
    grid of all ``world`` ranks, in one start of the ranks."""
    torch.set_num_threads(1)
    out = []
    for c in cases:
        topo = mesh.topology(c["n_workers"], dist.group.WORLD, model=c["model"],
                             fsdp=c["fsdp"])
        out.append(dsm_case(topo, c["cfg"], c["n_workers"], c["flags"], c["row"],
                            c["batches"], c["gamma"], c.get("nan_rank"), c.get("replicate", ()),
                            c.get("seed")))
    return out


def algorithms_rank(rank: int, world: int, cases: list) -> list:
    """Each case on this rank of the ``(worker, zero, model)`` grid of all
    ``world`` ranks, in one start of the ranks: a dict of ``cfg``,
    ``n_workers``, ``model``, ``fsdp``, ``replicate`` (leaf names held whole
    on every model rank), ``row``, ``batches``, ``gamma`` and either
    ``flags``, ``seed`` and optionally ``faults`` (a DSM run,
    :func:`dsm_case`; ``seed`` seeds the randomized signs' generator) or
    ``method`` and ``kw`` (a local-step baseline, :func:`baseline_case`)."""
    torch.set_num_threads(1)
    out = []
    for c in cases:
        topo = mesh.topology(c["n_workers"], dist.group.WORLD, model=c["model"],
                             fsdp=c["fsdp"])
        if "method" in c:
            out.append(baseline_case(topo, c["cfg"], c["n_workers"], c["method"], c["kw"],
                                     c["row"], c["batches"], c["gamma"], c["replicate"]))
        else:
            out.append(dsm_case(topo, c["cfg"], c["n_workers"], c["flags"], c["row"],
                                c["batches"], c["gamma"], replicate_names=c["replicate"],
                                seed=c["seed"], faults=c.get("faults")))
    return out


def baseline_case(topo, cfg, n_workers: int, method: str, kw: dict, row, batches: list,
                  gamma: float, replicate_names: tuple = ()) -> dict:
    """A local-step baseline's outer steps (``core.baselines.LOCAL_METHODS
    [method]`` with ``kw``; AdamW, constant ``gamma``) of ``cfg`` on
    ``topo`` (None: the dense path) from the dense ``(N,)`` params ``row``
    cut to the rank's blocks, on the batch dicts of ``batches`` (numpy
    leaves (W, tau, 1, B_micro, ...), the rank's workers' rows taken).
    Returns per round the metrics' loss, the rank's worker mean (under a
    topology) and its x0 and aux buffers (its blocks), its ``CommStats`` and
    kernel launches."""
    from repro_torch import kernels as K
    from repro_torch.core import base_opt, schedules
    from repro_torch.core import baselines as BL
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T

    lay = TP.topology_layout(cfg, topo, replicate_names)
    x0 = C.shard_flat(row, T.layout(cfg), lay) if lay.sharded else row
    tau = batches[0]["tokens"].shape[1]
    init, step = BL.LOCAL_METHODS[method](
        lambda p, mb: T.loss_fn(p, mb, cfg, remat=False), base_opt.adamw(), tau,
        schedules.constant(gamma), lay, topo=topo, **kw)
    state = init(x0, n_workers)
    rows = slice(None) if topo is None else topo.worker_slice
    K.reset_launch_counts()
    out = {"losses": [], "x_tau": [], "x0": [], "aux": [],
           "index": 0 if topo is None else topo.model_index,
           "zero_index": 0 if topo is None else topo.zero_index,
           "rank": 0 if topo is None else topo.rank}
    mean = Z.replicated_worker_mean

    def recorded(*a, **k):
        out["x_tau"].append(each(torch.clone, mean(*a, **k)))
        return out["x_tau"][-1]

    Z.replicated_worker_mean = recorded
    try:
        for raw in batches:
            batch = {k: torch.from_numpy(v[rows]) for k, v in raw.items()}
            batch["tokens"] = batch["tokens"].long()
            state, metrics = step(state, batch)
            out["losses"].append(metrics["loss"])
            out["x0"].append(each(torch.clone, state.x0))
            out["aux"].append([t.clone() for t in base_opt._buffers(state.aux)])
    finally:
        Z.replicated_worker_mean = mean
    out["comm"] = None if topo is None else topo.stats.as_dict()
    out["launches"] = K.launch_counts()
    return out


def dsm_case(topo, cfg, n_workers: int, flags: dict, row, batches: list, gamma: float,
             nan_rank: Optional[int] = None, replicate_names: tuple = (),
             seed: Optional[int] = None, faults: Optional[list] = None) -> dict:
    """:func:`tp_dsm_rank`'s run on ``topo`` (None: the dense path), its
    blocks by ``tensor_parallel.topology_layout`` (under FSDP its zero
    blocks: x_tau, x0 and m whole over its worker peers; the leaves named in
    ``replicate_names`` whole).  ``nan_rank``: that rank sets one element of
    its first worker's block to NaN after each local phase.  ``seed``: the
    randomized signs draw from a generator on ``row``'s device seeded with
    it.  ``faults``: per round the ``(survivors, stale, corrupt)`` bool
    masks of all W workers, the round's ``FaultRound``.  Each round also
    returns the metrics' ``survivors`` and the rank's params rows."""
    from repro_torch import kernels as K
    from repro_torch.core import base_opt, schedules
    from repro_torch.core import dsm as D
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.groups import parts
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T

    lay = TP.topology_layout(cfg, topo, replicate_names)
    x0 = C.shard_flat(row, T.layout(cfg), lay) if lay.sharded else row
    base = base_opt.adamw()
    tau = batches[0]["tokens"].shape[1]
    make_local = D.make_local_phase

    def poisoned(*a, **k):
        local = make_local(*a, **k)

        def run(state, batch, g):
            losses = local(state, batch, g)
            parts(state.params)[0][0, 0] = float("nan")
            return losses
        return run

    if topo is not None and topo.rank == nan_rank:
        D.make_local_phase = poisoned
    try:
        step = D.make_dsm_step(lambda p, mb: T.loss_fn(p, mb, cfg, remat=False), base,
                               DSMConfig(tau=tau, global_lr=0.5, **flags),
                               schedules.constant(gamma), lay, topo)
    finally:
        D.make_local_phase = make_local
    state = D.dsm_init(x0, base, n_workers, topo, flags.get("zero_sharded", False))
    rows = slice(None) if topo is None else topo.worker_slice
    state_bytes = state_nbytes(state, x0, batches[0]["tokens"][rows])
    dtopo = None if topo is None else topo.dp
    sharded = topo is not None and flags.get("zero_sharded", False)
    means = []
    mean_fns = {name: getattr(Z, name) for name in ("scattered_worker_mean",
                                                   "replicated_worker_mean")}

    # the whole blocks are gathered over ranks whose CommStats are apart
    quiet = None if dtopo is None else dataclasses.replace(dtopo, stats=type(dtopo.stats)())

    def whole(t):
        return Z.gather_shards(t, quiet, lay.group_numels) if sharded else t

    def recording(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            means.append(out)
            return out
        return wrapped

    dense_mean = D.worker_mean
    D.worker_mean = lambda p: means.append(dense_mean(p)) or means[-1]
    for name, fn in mean_fns.items():
        setattr(Z, name, recording(fn))
    rng = None if seed is None else torch.Generator(parts(row)[0].device).manual_seed(seed)
    K.reset_launch_counts()
    out = {"losses": [], "x_tau": [], "x0": [], "m": [], "params": [], "survivors": [],
           "state_bytes": state_bytes,
           "index": 0 if topo is None else topo.model_index,
           "zero_index": 0 if topo is None else topo.zero_index,
           "rank": 0 if topo is None else topo.rank}
    try:
        for raw in batches:
            batch = {k: torch.from_numpy(v[rows]) for k, v in raw.items()}
            batch["tokens"] = batch["tokens"].long()
            fr = None if faults is None else FaultRound(*(torch.tensor(m) for m in
                                                          faults[len(out["losses"])]))
            state, metrics = step(state, batch, rng, fr)
            out["losses"].append(metrics["loss"])
            out["survivors"].append(metrics.get("survivors"))
            out["x_tau"].append(each(torch.clone, whole(means[-1])))
            out["x0"].append(each(torch.clone, whole(state.x0)))
            out["m"].append(each(torch.clone, whole(state.m)))
            out["params"].append(each(torch.clone, state.params))
            out.setdefault("packs", []).append(metrics["pack"])
    finally:
        D.worker_mean = dense_mean
        for name, fn in mean_fns.items():
            setattr(Z, name, fn)
    out["comm"] = None if topo is None else topo.stats.as_dict()
    out["launches"] = K.launch_counts()
    return out


def state_nbytes(state, x0, tokens) -> int:
    """A rank's state as the dry-run counts it: the state's buffers (its
    scratch gradients too), the kept x0 and its round of tokens (int64)."""
    held = ([t for _, v in state_fields(state) if not isinstance(v, int) for t in _tensors(v)]
            + _tensors(state.grads) + _tensors(x0))
    return sum(t.numel() * t.element_size() for t in held) + int(tokens.size) * 8


def _tensors(v) -> list:
    """Every tensor of a state field: a tensor, Groups or a state of them."""
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, Groups):
        return list(v)
    return [t for _, x in state_fields(v) for t in _tensors(x)]


def fsdp_grads_rank(rank: int, world: int, model: int, cases: list) -> list:
    """One microbatch's forward and backward through ``core.dsm.worker_grads``
    on an FSDP rank of (worker 1, zero world / model, model) for each case
    ``(cfg, row, batch, remat)``: ``row`` the dense ``(N,)`` params, cut to
    the rank's zero blocks, ``batch`` the whole microbatch (a dict of
    (B_micro, ...) CPU tensors; the rank takes its rows where they split
    over zero).  Returns per case the rank's loss (its rows' mean), its
    gradient (its layout), its grid place and its ``CommStats``; one
    topology for every case."""
    from repro_torch.core import dsm as D
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T

    torch.set_num_threads(1)
    topo = mesh.topology(1, dist.group.WORLD, model=model, fsdp=True)
    out = []
    for cfg, row, batch, remat in cases:
        topo.stats.reset()
        lay = TP.topology_layout(cfg, topo)
        params = each(lambda t: t.unsqueeze(0), C.shard_flat(row, T.layout(cfg), lay))
        grads = each(torch.zeros_like, params)
        losses = torch.zeros(1)
        D.worker_grads(lambda p, mb, cfg=cfg, remat=remat: T.loss_fn(p, mb, cfg, remat=remat),
                       lay, params, grads, {k: v[None, None] for k, v in batch.items()}, losses)
        out.append({"loss": losses[0], "grads": each(lambda g: g[0], grads),
                    "model_index": topo.model_index, "zero_index": topo.zero_index,
                    "comm": topo.stats.as_dict()})
    return out


def tp_audit_rank(rank: int, world: int, cfg, n_workers: int, model: int, tau: int) -> dict:
    """The collective audit of a model-axis outer step of ``cfg`` (ZeRO,
    device-parallel local phase) over the ``(worker, zero, model)`` grid of
    ``world`` ranks, and of a local phase whose loss also all-reduces the
    rank's x0 blocks over its ``(worker, zero)`` ranks: ``{name: report}``."""
    from repro_torch.analysis.collective_audit import (CollectiveBudget, audit_call,
                                                       group_name, reckoned_model_ops)
    from repro_torch.core import base_opt, schedules
    from repro_torch.core.dsm import dsm_init, make_dsm_step, make_local_phase
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T

    torch.set_num_threads(1)
    topo = mesh.topology(n_workers, dist.group.WORLD, model=model)
    lay = TP.topology_layout(cfg, topo)
    x0 = C.shard_flat(T.init_params(torch.Generator().manual_seed(0), cfg), T.layout(cfg), lay)
    base = base_opt.adamw()
    tokens = torch.randint(0, cfg.vocab_size, (n_workers, tau, 1, 2, 32),
                           generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens[topo.worker_slice]}

    def loss(p, mb):
        return T.loss_fn(p, mb, cfg, remat=False)

    def budget(phase):
        return CollectiveBudget.for_phase(
            phase, lay, topo.dp.world, n_workers, group_name(topo.model_group),
            reckoned_model_ops(cfg, lay, phase, topo.local_workers, tau, 2, 32))

    step = make_dsm_step(loss, base, DSMConfig(tau=tau, zero_sharded=True,
                                               device_parallel_local=True),
                         schedules.constant(2e-2), lay, topo)
    state = dsm_init(x0, base, n_workers, topo, True)
    out = {"outer_step": audit_call(step, (state, batch), budget("global_zero"),
                                    "outer_step", topo.stats).to_json()}

    def planted(p, mb):
        buf = x0.clone()
        dist.all_reduce(buf, group=topo.dp_group)
        return loss(p, mb)

    local = make_local_phase(planted, base, lay)
    state = dsm_init(x0, base, n_workers, topo, True)
    out["planted_local_phase"] = audit_call(local, (state, batch, 2e-2), budget("local"),
                                            "planted_local_phase").to_json()
    # one all-reduce per local step and worker
    out["planted_bytes"] = tau * topo.local_workers * x0.numel() * x0.element_size()
    return out


def fsdp_audit_rank(rank: int, world: int, cfg, n_workers: int, model: int, tau: int) -> dict:
    """The collective audit of an FSDP outer step of ``cfg`` (ZeRO,
    device-parallel local phase, ``B_micro`` 2 over zero 2) over the
    ``(worker, zero, model)`` grid of ``world`` ranks, and of a local phase
    whose loss also all-gathers a small buffer over the rank's zero group:
    ``{name: report}``."""
    from repro_torch.analysis.collective_audit import (CollectiveBudget, audit_call,
                                                       group_name, reckoned_model_ops,
                                                       reckoned_zero_ops)
    from repro_torch.core import base_opt, schedules
    from repro_torch.core.dsm import dsm_init, make_dsm_step, make_local_phase
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T

    torch.set_num_threads(1)
    topo = mesh.topology(n_workers, dist.group.WORLD, model=model, fsdp=True)
    lay = TP.topology_layout(cfg, topo)
    x0 = C.shard_flat(T.init_params(torch.Generator().manual_seed(0), cfg), T.layout(cfg), lay)
    base = base_opt.adamw()
    tokens = torch.randint(0, cfg.vocab_size, (n_workers, tau, 1, 2, 32),
                           generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens[topo.worker_slice]}

    def loss(p, mb):
        return T.loss_fn(p, mb, cfg, remat=False)

    def budget(phase):
        args = (cfg, lay, phase, topo.local_workers, tau, 2, 32)
        return CollectiveBudget.for_phase(
            phase, lay, topo.dp.world, n_workers, group_name(topo.model_group),
            reckoned_model_ops(*args) if model > 1 else None, group_name(topo.zero_group),
            reckoned_zero_ops(*args))

    step = make_dsm_step(loss, base, DSMConfig(tau=tau, zero_sharded=True,
                                               device_parallel_local=True),
                         schedules.constant(2e-2), lay, topo)
    state = dsm_init(x0, base, n_workers, topo, True)
    out = {"outer_step": audit_call(step, (state, batch), budget("global_zero"),
                                    "outer_step", topo.stats).to_json()}

    def planted(p, mb):
        small = torch.zeros(4)
        dist.all_gather([torch.empty(4) for _ in range(topo.zero)], small,
                        group=topo.zero_group)
        return loss(p, mb)

    local = make_local_phase(planted, base, lay)
    state = dsm_init(x0, base, n_workers, topo, True)
    out["planted_local_phase"] = audit_call(local, (state, batch, 2e-2), budget("local"),
                                            "planted_local_phase").to_json()
    return out


def algorithm_step(cfg, algo: Optional[dict], tau: int, gamma: float, eta: float, lay,
                   topo=None, device: str = "cuda") -> tuple:
    """``(init(x0, n_workers) -> state, step(state, batch) -> (state,
    metrics))`` of one of ``chip_smoke.py``'s runs of ``cfg`` on ``lay``
    over ``topo`` (None: the dense run), AdamW local steps at a constant
    ``gamma``: DSM (``algo`` None, or ``{"sign_mode": ..., "seed": ...}``:
    the randomized signs from a generator on ``device`` seeded with
    ``seed``, each rank's its own) with ``eta``, the ZeRO-sharded global
    step (``{"zero_sharded": False}``: the replicated one, x0 and m whole
    over the worker peers) and the device-parallel local phase over ranks;
    or the local-step baseline ``{"method": name, **its global step's
    keywords}``."""
    from repro_torch.core import base_opt, schedules
    from repro_torch.core import baselines as BL
    from repro_torch.core import dsm as D

    algo = dict(algo or {})
    base = base_opt.adamw()
    loss = functools.partial(_loss, cfg=cfg)
    if "method" in algo:
        return BL.LOCAL_METHODS[algo.pop("method")](loss, base, tau, schedules.constant(gamma),
                                                    lay, topo=topo, **algo)
    seed = algo.pop("seed", None)
    sharded = topo is not None and algo.pop("zero_sharded", True)
    flags = dict(zero_sharded=sharded, device_parallel_local=True) if topo is not None else {}
    step = D.make_dsm_step(loss, base, DSMConfig(tau=tau, global_lr=eta, **flags, **algo),
                           schedules.constant(gamma), lay, topo)
    rng = None if seed is None else torch.Generator(device).manual_seed(seed)

    def init(x0, n_workers: int):
        return D.dsm_init(x0, base, n_workers, topo, sharded)

    return init, lambda state, batch: step(state, batch, rng)


def _loss(p, mb, cfg):
    from repro_torch.models import transformer as T

    return T.loss_fn(p, mb, cfg, remat=False)


def momentum(state):
    """The f32 buffer a round's check holds beside x0: DSM's m, a
    baseline's first aux buffer (SlowMo's u, global AdamW's m)."""
    from repro_torch.core.base_opt import _buffers

    return state.m if hasattr(state, "m") else _buffers(state.aux)[0]


@contextlib.contextmanager
def recorded_means(seen: dict):
    """While active, every worker mean over ranks (the scattered one of a
    ZeRO-sharded DSM step, the replicated one of a baseline) is kept in
    ``seen["x_tau"]``."""
    fns = {name: getattr(Z, name) for name in ("scattered_worker_mean",
                                               "replicated_worker_mean")}

    def keeping(fn):
        def mean(*a, **k):
            seen["x_tau"] = fn(*a, **k)
            return seen["x_tau"]
        return mean

    for name, fn in fns.items():
        setattr(Z, name, keeping(fn))
    try:
        yield seen
    finally:
        for name, fn in fns.items():
            setattr(Z, name, fn)


def model_axis_rank(rank: int, world: int, cases: list, out_dir: str,
                    prefix: str = "") -> list:
    """``chip_smoke.py``'s model-axis runs on this rank, one per case:
    ``(cfg, n_workers, model, seed, batches, gamma, eta[, leaves held
    whole[, algo]])`` (a batch's leaves (W, tau, 1, B_micro, ...):
    ``tokens``, a VLM's ``patches``; ``algo``: :func:`algorithm_step`'s).
    Each draws the dense initial params on the card from ``seed`` (the
    dense run's draw), keeps this rank's blocks and runs ``len(batches)``
    outer steps (DSM unless ``algo`` names a baseline: AdamW, ZeRO-sharded
    global step, device-parallel local phase) over the ``(worker, zero,
    model)`` grid of ``world`` ranks.  After each round the first ``(worker,
    zero)`` rank of each model index saves its blocks of x_tau, x0 and m (a
    baseline's first aux buffer, :func:`momentum`), whole, to ``out_dir``
    (``<prefix><case>_<model index>_<round>.pt``, CPU tensors).  Returns per
    case the per-worker losses (tau, W) of each DSM round (``loss``: every
    round's mean), the peak (``max_memory_allocated`` from the state's build
    on), the collectives, the kernel launches, each outer step's host ms,
    the case's seconds (``case_s``, the draw included) and, per round, the
    routes of every MoE layer call (:func:`recorded_routes`, on the host;
    none without a MoE layer)."""
    import os
    import time

    from repro_torch import kernels as K
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T
    from repro_torch.obs import metrics as OM

    out = []
    for i, (cfg, n_workers, model, seed, batches, gamma, eta, *extra) in enumerate(cases):
        rep, algo = (tuple(extra) + ((), None))[:2]
        t_case = time.perf_counter()
        topo = mesh.topology(n_workers, dist.group.WORLD, model=model)
        lay = TP.topology_layout(cfg, topo, rep)
        row = T.init_params(torch.Generator("cuda").manual_seed(seed), cfg, device="cuda")
        x0 = C.shard_flat(row, T.layout(cfg), lay)
        del row
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tau = batches[0]["tokens"].shape[1]
        init, step = algorithm_step(cfg, algo, tau, gamma, eta, lay, topo)
        state = init(x0, n_workers)
        dtopo = topo.dp
        quiet = dataclasses.replace(dtopo, stats=type(dtopo.stats)())
        saves = dtopo.rank == 0
        seen = {}
        stats_fn = OM.loss_stats

        def loss_stats(losses):
            seen["losses"] = losses.detach().cpu()
            return stats_fn(losses)

        OM.loss_stats = loss_stats
        K.reset_launch_counts()
        res = {"losses": [], "loss": [], "step_ms": [], "routes": [], "index": topo.model_index,
               "zero_index": topo.zero_index, "rank": rank, "grid": (topo.worker, topo.zero)}
        try:
            for k, raw in enumerate(batches):
                batch = {n: torch.from_numpy(v[topo.worker_slice]).to("cuda")
                         for n, v in raw.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with recorded_routes([]) as routes, recorded_means(seen):
                    state, metrics = step(state, batch)
                torch.cuda.synchronize()
                res["step_ms"].append((time.perf_counter() - t0) * 1e3)
                res["losses"].append(seen.pop("losses", None))
                res["loss"].append(metrics["loss"].item())
                res["routes"].append([r.cpu() for r in routes])
                del batch, routes
                blocks = {n: Z.gather_shards(t, quiet, lay.group_numels)
                          for n, t in (("x_tau", seen.pop("x_tau")), ("x0", state.x0),
                                       ("m", momentum(state)))}
                if saves:
                    torch.save({n: each(lambda t: t.cpu(), t) for n, t in blocks.items()},
                               os.path.join(out_dir, f"{prefix}{i}_{topo.model_index}_{k}.pt"))
                del blocks
        finally:
            OM.loss_stats = stats_fn
        res["launches"] = K.launch_counts()
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["comm"] = topo.stats.as_dict()
        res["case_s"] = time.perf_counter() - t_case
        out.append(res)
        del state, x0, step
        torch.cuda.empty_cache()
    return out


def _recording(fn, into: list, at=None):
    """``fn`` that appends each result (or its item ``at``) to ``into``."""
    def wrapped(*a, **k):
        r = fn(*a, **k)
        into.append(r if at is None else r[at])
        return r
    return wrapped


def serve_rank(rank: int, world: int, cases: list) -> list:
    """Each serving case on this rank of the ``(data, model)`` grid of
    ``world`` ranks (``mesh.serving_topology``).  A case is a dict: ``cfg``,
    ``model`` (M), ``row`` (the dense ``(N,)`` params, cut to the rank's
    blocks), ``batch`` (the whole batch dict of CPU tensors), ``dec_tokens``
    ((steps, B) teacher-forced decode tokens), ``new`` (generate's tokens),
    ``temperature`` (0: greedy) and optionally ``fsdp`` (the rank holds its
    data block of each leaf the placement cuts over ``data``) and
    ``replicate`` (leaf names held whole on every model rank).  Where the
    batch does not split over data the rank serves every row over
    ``tensor_parallel.serve_split``'s split, as ``generate`` does: the
    prefill over its chunk of the prompt's positions (``seq``), its cache's
    full-attention blocks of the decode length's slots (``slots``), kept by
    the prefill and read by each decode step.  Returns per case: the
    rank's grid place, rows and split (``seq`` / ``slots`` without their
    group, or None); its prefill logits and cache; its init_cache of the
    decode length and each teacher-forced ``decode_step``'s logits and the
    cache after them (on params ``serving_params`` resolved first, its
    collectives apart); generate's tokens (the whole batch's); each phase's
    ``CommStats``; with a temperature, each pick's logits and the Gumbel
    noise of each draw (the whole batch's rows for the rank's block)."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.comm import CommStats
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T
    from repro_torch.train import serve as S

    torch.set_num_threads(1)
    out = []
    for case in cases:
        cfg, batch, dec = case["cfg"], case["batch"], case["dec_tokens"]
        topo = mesh.serving_topology(dist.group.WORLD, model=case["model"],
                                     fsdp=case.get("fsdp", False))
        rep = case.get("replicate", ())
        lay = TP.topology_layout(cfg, topo, rep)
        # (data D, model 1) without FSDP: every rank holds the dense params
        mine = case["row"] if lay.model_dims == () else C.shard_flat(case["row"], T.layout(cfg),
                                                                     lay)

        def fresh():
            t = dataclasses.replace(topo, stats=CommStats())
            return t, TP.topology_layout(cfg, t, rep).views(mine)

        rows = TP.serve_rows(batch["tokens"].shape[0], topo)
        local = {k: v[rows] for k, v in batch.items()}
        b, s = local["tokens"].shape
        n0 = s + (cfg.n_patches if cfg.family == "vlm" else 0)
        seq, slots = TP.serve_split(batch["tokens"].shape[0], n0, case["new"], cfg, topo.worker,
                                    topo.worker_index)
        res = {"rank": rank, "data_index": topo.worker_index, "model_index": topo.model_index,
               "rows": (rows.start, rows.stop),
               **{k: None if v is None else tuple(v) for k, v in (("seq", seq), ("slots", slots))}}
        with torch.no_grad():
            t, params = fresh()
            seq, slots = (None if v is None else v._replace(axis=t.data) for v in (seq, slots))
            logits, small = T.prefill(params, local, cfg, remat=False, seq=seq, slots=slots)
            # a copy: the splice passes recurrent states through, and decode
            # then steps them in place
            kept_cache = torch.utils._pytree.tree_map(torch.clone, small)
            res["prefill"] = {"logits": logits, "cache": kept_cache, "comm": t.stats.as_dict()}
            t, params = fresh()
            slots = None if slots is None else slots._replace(axis=t.data)
            params = T.serving_params(params, cfg)
            resolved = t.stats.as_dict()
            t.stats.reset()
            cache = T.init_cache(cfg, b, n0 + case["new"], layout=getattr(params, "layout", None),
                                 slots=slots)
            res["init_cache"] = {k: tuple(v.shape) for k, v in C.flatten_tree(
                cache, is_leaf=lambda x: isinstance(x, torch.Tensor))}
            cache = S._splice_cache(cache, small, cfg, n0)
            steps = []
            for i, tok in enumerate(dec):
                logits, cache = T.decode_step(params, cache, tok[rows], n0 + i, cfg, slots=slots)
                steps.append(logits)
            res["decode"] = {"logits": steps, "cache": cache, "comm": t.stats.as_dict(),
                             "serving_params_comm": resolved}
        t, params = fresh()
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        picks = {"logits": [], "noise": []}
        gumbel, prefill, decode_step = S.gumbel, T.prefill, T.decode_step
        if case["temperature"] > 0:
            S.gumbel = _recording(gumbel, picks["noise"])
            T.prefill = _recording(prefill, picks["logits"], 0)
            T.decode_step = _recording(decode_step, picks["logits"], 0)
        try:
            toks, _ = S.generate(params, cfg, batch["tokens"], case["new"],
                                 temperature=case["temperature"], extra_batch=extra,
                                 device="cpu", topo=t)
        finally:
            S.gumbel, T.prefill, T.decode_step = gumbel, prefill, decode_step
        res["generate"] = {"tokens": toks, "comm": t.stats.as_dict(), **picks}
        out.append(res)
    return out


def serve_full_width_rank(rank: int, world: int, cases: list) -> list:
    """``chip_smoke.py``'s serving cases on this rank of the ``(data, model)``
    grid of ``world`` ranks, one per case: ``(cfg, model, seed, prompt,
    new, extra[, fsdp])`` (``extra``: the batch's other leaves, a VLM's
    ``patches``, on the host; ``fsdp``: the data entries cut,
    ``serving_topology(..., fsdp=True)``).  Each draws the dense params on
    the card from ``seed`` (the dense run's draw; one rank at a time), keeps
    this rank's blocks, warms up with a 2-token ``generate`` and then generates ``new`` greedy tokens for the whole
    ``prompt`` batch (its data row's rows served here), its collectives
    counted apart (the warm-up on the prompts' first 8 tokens).  With
    ``cfg.attn_seq_shard`` the rank's prefill cache of the prompt is then
    compared with its prefill's without the flag (``sp_cache``: the bytes of
    each and the elements whose bits differ).  Returns per
    case: the rank's grid place and rows, the tokens (the whole batch's),
    each pick's logits (its rows, and its vocab block where they are split;
    on the CPU), ``generate``'s seconds and tokens/s, the peak
    (``max_memory_allocated`` over the timed call, the blocks included), the
    blocks' bytes, the bytes held beside them when the call starts (the
    prompt, the cuBLAS workspace) and the ``CommStats``."""
    import time

    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.comm import CommStats
    from repro_torch.groups import parts
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T
    from repro_torch.train import serve as S
    from repro_torch.train.trainer import set_matmul_precision

    set_matmul_precision()
    out = []
    for cfg, model, seed, prompt, new, extra, *fsdp in cases:
        t_case = time.perf_counter()
        topo = mesh.serving_topology(dist.group.WORLD, model=model, fsdp=bool(fsdp and fsdp[0]))
        # one rank draws at a time: four whole-depth draws at once (each the
        # dense model and an f32 draw of its largest leaf) need not fit
        # beside what the calling process holds on the card
        for turn in range(world):
            if turn == rank:
                row = T.init_params(torch.Generator("cuda").manual_seed(seed), cfg,
                                    device="cuda")
                lay = TP.topology_layout(cfg, topo)
                # (data D, model 1) without FSDP: the rank holds the dense params
                mine = row if lay.model_dims == () else C.shard_flat(row, T.layout(cfg), lay)
                del row
                torch.cuda.empty_cache()
            dist.barrier()
        prompt = prompt.to("cuda")
        extra = {k: v.to("cuda") for k, v in extra.items()} or None
        S.generate(mine, cfg, prompt[:, :8], 2, extra_batch=extra, device="cuda",
                   topo=dataclasses.replace(topo, stats=CommStats()))
        timed = dataclasses.replace(topo, stats=CommStats())
        logits = []
        prefill, decode_step = T.prefill, T.decode_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params_bytes = sum(t.numel() * t.element_size() for t in parts(mine))
        held = torch.cuda.memory_allocated() - params_bytes
        T.prefill = _recording(prefill, logits, 0)
        T.decode_step = _recording(decode_step, logits, 0)
        try:
            toks, stats = S.generate(mine, cfg, prompt, new, extra_batch=extra, device="cuda",
                                     topo=timed)
        finally:
            T.prefill, T.decode_step = prefill, decode_step
        peak = torch.cuda.max_memory_allocated()
        rows = TP.serve_rows(prompt.shape[0], topo)
        res = {"rank": rank, "data_index": topo.worker_index,
               "model_index": topo.model_index, "rows": (rows.start, rows.stop),
               "tokens": toks.cpu(), "logits": [t.cpu() for t in logits], **stats,
               "peak_bytes": peak, "params_bytes": params_bytes, "held_bytes": held,
               "comm": timed.stats.as_dict()}
        if cfg.attn_seq_shard:
            res["sp_cache"] = _sp_cache_bits(mine, cfg, topo, {"tokens": prompt[rows], **{
                k: v[rows] for k, v in (extra or {}).items()}}, new, prompt.shape[0])
        res["case_s"] = time.perf_counter() - t_case
        out.append(res)
        del mine, logits, prompt, extra
        torch.cuda.empty_cache()
    return out


def _sp_cache_bits(params, cfg, topo, batch: dict, new: int, whole: int) -> dict:
    """The rank's prefill cache of ``batch`` (its rows of a ``whole``-row
    batch) under ``cfg.attn_seq_shard`` against its prefill's without the
    flag, each over the split ``generate`` takes for ``new`` tokens
    (``tensor_parallel.serve_split``: where the batch does not split over
    data, the rank's chunk of the prompt and its block of the
    full-attention caches' slots): the bytes of each and the elements whose
    bits differ."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.comm import CommStats
    from repro_torch.models import transformer as T

    caches = []
    tokens = batch["tokens"]
    n0 = tokens.shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    for c in (cfg, dataclasses.replace(cfg, attn_seq_shard=False)):
        t = dataclasses.replace(topo, stats=CommStats())
        seq, slots = TP.serve_split(whole, n0, new, c, t.worker, t.worker_index, t.data)
        with torch.no_grad():
            caches.append(T.prefill(TP.topology_layout(c, t).views(params), batch, c,
                                    remat=False, seq=seq, slots=slots)[1])
    leaves = [torch.utils._pytree.tree_leaves(c) for c in caches]
    nbytes = [sum(x.numel() * x.element_size() for x in ls) for ls in leaves]
    differ = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                 for a, b in zip(*leaves)) if nbytes[0] == nbytes[1] else -1
    return {"bytes": nbytes[0], "bytes_without": nbytes[1], "bytes_differing": differ}


def model_axis_serve_rank(rank: int, world: int, cases: list, out_dir: str,
                          serve_cases: list, fsdp_cases: tuple = (),
                          algo_cases: tuple = ()) -> dict:
    """:func:`model_axis_rank`'s training cases and its ``algo_cases``
    (``algorithms``, saved with the prefix ``o``), then
    :func:`serve_full_width_rank`'s serving cases, then
    :func:`fsdp_full_width_rank`'s (saving under ``out_dir/fsdp``), in one
    start of the ranks; ``wall``: the wall clock (``time.time``) as the rank
    enters and as each of the three ends."""
    import os
    import time

    wall = [time.time()]
    out = {"train": model_axis_rank(rank, world, cases, out_dir)}
    out["algorithms"] = model_axis_rank(rank, world, algo_cases, out_dir, prefix="o")
    wall.append(time.time())
    out["serve"] = serve_full_width_rank(rank, world, serve_cases)
    wall.append(time.time())
    out["fsdp"] = fsdp_full_width_rank(rank, world, fsdp_cases, os.path.join(out_dir, "fsdp"))
    wall.append(time.time())
    return dict(out, wall=wall)


CHECK_CHUNK = 1 << 26          # elements per slice of a check's temporaries


def _slices(n: int):
    for c0 in range(0, n, CHECK_CHUNK):
        yield slice(c0, min(n, c0 + CHECK_CHUNK))


def gap_excess(a, b, ref_mags, rel: float) -> float:
    """max_i (|a_i - b_i| - rel * mags_i) over every dtype group, with mags
    the larger magnitude of the ``ref_mags`` tensors (element for element):
    the check ``gap <= C + R |x|`` is ``gap_excess(..., R) <= C``.  Taken
    in slices of CHECK_CHUNK elements on ``b``'s device, so that the f32
    temporaries of a model of billions of parameters fit beside it."""
    import functools
    import math

    from repro_torch.groups import parts

    worst = -math.inf
    for i, (x, y) in enumerate(zip(parts(a), parts(b), strict=True)):
        for s in _slices(y.shape[-1]):
            mag = functools.reduce(torch.maximum, [parts(t)[i][..., s].to(y.device).float().abs()
                                                   for t in ref_mags])
            gap = (x[..., s].to(y.device).float() - y[..., s].float()).abs()
            worst = max(worst, (gap - rel * mag).max().item())
            del mag, gap
    return worst


def round_check(ours: dict, theirs: dict, x0_before, b: dict, gamma: float, beta2: float,
                m_prev: float) -> tuple:
    """One round of a run against another from the same ``x0_before``
    (``ours`` / ``theirs``: ``x_tau``, ``x0`` and ``m``, whole buffers of the
    same layout; checked in slices on ``theirs``' device) within a round ``b`` of
    ``chip_smoke.model_axis_bounds``: x_tau's and x0's gaps within C + R
    |x|; m's, element by element, within beta2 times the last round's bound
    (``m_prev``) plus (1 - beta2) / gamma times x0's (before) and x_tau's
    bounds, plus 1e-6 |m|.  Returns (the round's readings with ``ok``, the
    next round's ``m_prev``)."""
    import math

    from repro_torch.groups import parts

    excess = {n: gap_excess(ours[n], theirs[n], [ours[n], theirs[n]], b[n][1])
              for n in ("x_tau", "x0")}
    m_c = beta2 * m_prev + (1 - beta2) / gamma * (b["x0_before"][0] + b["x_tau"][0])
    m_excess, m_next = -math.inf, 0.0
    for g, (mo, mt) in enumerate(zip(parts(ours["m"]), parts(theirs["m"]), strict=True)):
        dev = mt.device
        for s in _slices(mt.shape[-1]):
            mag = ((1 - beta2) / gamma) * (
                b["x0_before"][1] * parts(x0_before)[g][s].to(dev).float().abs()
                + b["x_tau"][1] * torch.maximum(parts(ours["x_tau"])[g][s].to(dev).float().abs(),
                                                parts(theirs["x_tau"])[g][s].float().abs()))
            mag += 1e-6 * mt[s].abs()
            m_excess = max(m_excess, ((mo[s].to(dev) - mt[s]).abs() - mag).max().item())
            m_next = max(m_next, mag.max().item())
            del mag
    gaps = {n: max((p[..., s].to(q.device).float() - q[..., s].float()).abs().max().item()
                   for p, q in zip(parts(ours[n]), parts(theirs[n]))
                   for s in _slices(q.shape[-1])) for n in ("x_tau", "x0", "m")}
    ok = excess["x_tau"] <= b["x_tau"][0] and excess["x0"] <= b["x0"][0] and m_excess <= m_c
    return ({"max_gap": gaps, "excess_over_R": {**excess, "m": m_excess}, "m_bound_C": m_c,
             "ok": ok}, m_c + m_next)


@contextlib.contextmanager
def recorded_routes(into: list):
    """While active, each ``layers.route`` call's experts ((T, K) in top-k
    order, on the call's device) appended to ``into``: the routes a MoE
    layer took, on the dense path and on a model rank alike."""
    from repro_torch.models import layers as L

    orig = L.route

    def route(probs, k):
        vals, idx = orig(probs, k)
        into.append(idx)
        return vals, idx

    L.route = route
    try:
        yield into
    finally:
        L.route = orig


def zero_cut(flat, mlay, zlay):
    """``zlay``'s zero block of buffers in ``mlay``'s layout (the model
    block it cuts), in their dtypes: each leaf narrowed along its zero
    dim."""
    from repro_torch.models import convert as C

    out = C._like(flat, zlay.group_numels)
    src, dst = mlay.views(flat), zlay.views(out)
    for i, name in enumerate(zlay.names):
        dst[name].copy_(C.shard_leaf(src[name], zlay.zero_dims[i], zlay.zero, zlay.zero_index))
    return out


def fsdp_full_width_rank(rank: int, world: int, cases, out_dir: str) -> list:
    """``chip_smoke.py``'s FSDP runs on this rank, one per case, a dict:
    ``name``, ``cfg``, ``n_workers``, ``model``, ``fsdp``, ``seed``,
    ``batches``, ``gamma``, ``eta``, and optionally ``save`` (the first
    worker peer of each (model, zero) index saves its zero blocks of x_tau,
    x0 and m, whole, to ``out_dir`` as ``<name>_<model>_<zero>_<round>.pt``),
    ``keep`` (this rank's zero blocks of each round kept on the host for a
    later case), ``against`` (``(kept case, bounds)``: each round held
    against that case's, bit for bit where ``bounds`` is None, else within
    :func:`round_check` of ``bounds[round]``), ``params`` (the first
    worker's params row kept beside x0 and m, and held too), ``algo`` (:func:`algorithm_step`'s: the
    randomized signs, a baseline, whose saved ``m`` is its first aux
    buffer, :func:`momentum`, or the replicated global step) and
    ``digest`` (each round's SHA-256 of the bits of this rank's x0 and m,
    which its worker peers hold alike where they are not sharded).  A save also
    holds each round's mean loss (``loss``).  Each draws the dense params
    on the card from ``seed``, one rank at a time (once per config and seed:
    the rank keeps its model block on the host), keeps this rank's blocks
    (under FSDP its zero blocks; a run without FSDP is cut to the zero blocks
    of the same grid's FSDP layout for the comparisons) and runs the DSM
    outer steps (AdamW, ZeRO-sharded global step, device-parallel local
    phase).  Returns per case the per-worker losses (tau, W) of each round,
    the peak (``max_memory_allocated`` from the state's build on), the bytes
    held beside the run's x0 block when it starts, the state bytes as the
    dry-run counts them, the collectives, the kernel launches, each outer
    step's host ms, the comparisons, and the case's seconds to the end of
    its run (``run_s``) and of its comparisons (``case_s``).  The ranks
    build one set of subgroups per grid (``fsdp=True``); a run without FSDP
    takes that topology's view without it."""
    import os
    import time

    from repro_torch import kernels as K
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T
    from repro_torch.obs import metrics as OM

    out, kept, drawn, grids = [], {}, {}, {}
    for case in cases:
        t_case = time.perf_counter()
        cfg, W, name = case["cfg"], case["n_workers"], case["name"]
        grid = (W, case["model"])
        if grid not in grids:
            # one set of subgroups per grid: a run without FSDP takes its view
            grids[grid] = mesh.topology(W, dist.group.WORLD, model=case["model"], fsdp=True)
        topo = dataclasses.replace(grids[grid], stats=type(grids[grid].stats)(),
                                   **({} if case["fsdp"] else
                                      dict(fsdp="", zero_group=None, peer_group=None)))
        lay = TP.topology_layout(cfg, topo)
        mlay = TP.rank_layout(cfg, topo.model, topo.model_index)
        zlay = TP.rank_layout(cfg, topo.model, topo.model_index, zero=topo.zero,
                              zero_index=topo.zero_index)
        key = (cfg.name, case["seed"], topo.model_index)
        if key not in drawn:
            # the rank's model block of the dense draw, kept on the host for
            # the cases that start from the same draw; one rank draws at a time
            for turn in range(world):
                if turn == rank:
                    row = T.init_params(torch.Generator("cuda").manual_seed(case["seed"]), cfg,
                                        device="cuda")
                    drawn[key] = each(lambda t: t.cpu(), C.shard_flat(row, T.layout(cfg), mlay))
                    del row
                    torch.cuda.empty_cache()
                dist.barrier()
        x0 = each(lambda t: t.to("cuda"), drawn[key])
        if lay.zero > 1:
            x0 = zero_cut(x0, mlay, lay)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res_held = torch.cuda.memory_allocated() - sum(t.numel() * t.element_size()
                                                       for t in _tensors(x0))
        tau = case["batches"][0]["tokens"].shape[1]
        init, step = algorithm_step(cfg, case.get("algo"), tau, case["gamma"], case["eta"], lay,
                                    topo)
        state = init(x0, W)
        state_bytes = state_nbytes(state, x0, case["batches"][0]["tokens"][topo.worker_slice])
        dtopo = topo.dp
        quiet = dataclasses.replace(dtopo, stats=type(dtopo.stats)())

        def mine(t):
            """This rank's zero block of a block buffer of ``lay``."""
            return t if lay.zero > 1 else zero_cut(t, lay, zlay)

        before = each(lambda t: t.cpu(), mine(x0))
        seen = {}
        stats_fn = OM.loss_stats

        def loss_stats(losses):
            seen["losses"] = losses.detach().cpu()
            return stats_fn(losses)

        OM.loss_stats = loss_stats
        K.reset_launch_counts()
        res = {"name": name, "losses": [], "loss": [], "step_ms": [], "rank": rank,
               "grid": (topo.worker, topo.zero, topo.model), "index": topo.model_index,
               "zero_index": topo.zero_index, "rounds": [], "state_bytes": state_bytes,
               "held_bytes": res_held}
        m_prev, rounds = 0.0, []
        try:
            for k, raw in enumerate(case["batches"]):
                batch = {n: torch.from_numpy(v[topo.worker_slice]).to("cuda")
                         for n, v in raw.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with recorded_means(seen):
                    state, metrics = step(state, batch)
                torch.cuda.synchronize()
                res["step_ms"].append((time.perf_counter() - t0) * 1e3)
                res["losses"].append(seen.get("losses"))
                res["loss"].append(metrics["loss"].item())
                blocks = {n: each(lambda t: t.cpu(), mine(Z.gather_shards(t, quiet,
                                                                          lay.group_numels)))
                          for n, t in (("x_tau", seen.pop("x_tau")), ("x0", state.x0),
                                       ("m", momentum(state)))}
                blocks["losses"] = seen.pop("losses", None)
                blocks["loss"] = metrics["loss"].item()
                if case.get("params"):
                    blocks["params"] = each(lambda t: t.cpu(),
                                            mine(each(lambda p: p[0], state.params)))
                if case.get("digest"):
                    res.setdefault("digests", []).append(
                        {n: _digest(blocks[n]) for n in ("x0", "m")})
                if case.get("save") and dtopo.rank == 0:
                    torch.save(blocks, os.path.join(
                        out_dir, f"{name}_{topo.model_index}_{topo.zero_index}_{k}.pt"))
                if case.get("keep") or case.get("against"):
                    rounds.append((before, blocks))
                before = blocks["x0"]
                del blocks
        finally:
            OM.loss_stats = stats_fn
        res["launches"] = K.launch_counts()
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["comm"] = topo.stats.as_dict()
        res["block_numel"] = lay.numel
        del state, x0, step, batch
        torch.cuda.empty_cache()
        res["run_s"] = time.perf_counter() - t_case
        if case.get("keep"):
            kept[name] = rounds
        if case.get("against"):
            ref, bounds = case["against"]
            for k, ((_, ours), (ref_before, theirs)) in enumerate(zip(rounds, kept[ref])):
                res["rounds"].append(_held_against(ours, theirs, ref_before, bounds and bounds[k],
                                                   case["gamma"], m_prev))
                m_prev = res["rounds"][-1].pop("m_next", 0.0)
        res["case_s"] = time.perf_counter() - t_case
        out.append(res)
    return out


def _digest(t) -> str:
    """The SHA-256 of the bits of a host tensor or Groups, group by group."""
    import hashlib

    h = hashlib.sha256()
    for x in _flat_parts(t):
        h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _held_against(ours: dict, theirs: dict, before, bound, gamma: float, m_prev: float) -> dict:
    """One round's blocks (host tensors) against another run's on the card:
    bit for bit (``bound`` None: x_tau, x0, m, the losses and, where both
    kept them, the params) or within :func:`round_check`'s ``bound``."""
    if bound is None:
        same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for n in ("x_tau", "x0", "m", "losses", "params") if n in ours or n in theirs
                   for a, b in zip(_flat_parts(ours[n]), _flat_parts(theirs[n]), strict=True))
        return {"bit_equal": same, "ok": same}
    card = [{n: each(lambda t: t.to("cuda"), v) for n, v in d.items()
             if n not in ("losses", "loss")}
            for d in (ours, theirs)]
    check, m_next = round_check(*card, each(lambda t: t.to("cuda"), before), bound, gamma,
                                DSMConfig().beta2, m_prev)
    del card
    torch.cuda.empty_cache()
    return {**check, "loss_gap": (ours["losses"] - theirs["losses"]).abs().max().item(),
            "m_next": m_next}


def _flat_parts(t) -> list:
    """A tensor or Groups as a list of contiguous tensors."""
    from repro_torch.groups import parts

    return [p.contiguous() for p in parts(t)]
