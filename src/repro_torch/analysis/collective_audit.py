"""Collective auditor of the port: the reference's ``repro.analysis.hlo_audit``
for eager PyTorch over c10d process groups.

The paper's claim is a collective budget: one reduction round per tau local
steps, none inside them.  The reference compiles each step and parses the
collectives out of the compiled HLO.  The port has no compiled program, so
:class:`CollectiveRecorder` watches the step run instead: a
``TorchDispatchMode`` that records every op of the ``c10d`` namespace that
the step dispatches — its kind, the dtype and shape of every tensor it
sends, its bytes and the Python line that issued it (the reference's "HLO
line") — and forwards every op, c10d or not, as ``func(*args, **kwargs)``:
it copies nothing and reads no tensor's values, so it syncs nothing.  It
sees a ``torch.distributed`` call wherever it is written, so it does not
depend on ``distributed/comm.py``'s own ``CommStats``, which counts only
the calls that go through ``comm.py``.  gloo's host copies of card tensors
(``comm._staged``) are the same ops on host tensors of the same bytes.

The dispatch-mode stack is per thread.  The autograd engine carries it to
its device threads; a collective issued from another thread would pass
unseen, and :func:`audit_call` then finds ``CommStats`` ahead of the
recorder for ``comm.py``'s collectives.

Kinds (the reference's names):

  * ``allreduce_`` -> ``all-reduce``; ``reduce_scatter_*`` ->
    ``reduce-scatter``.
  * ``alltoall_base_`` -> ``reduce-scatter``: ``comm.scatter_rows`` is the
    port's reduce-scatter.  It moves each worker's column chunk whole to
    the chunk's owner, which sums the W rows in worker order, as the dense
    mean sums them (``distributed/zero.py``), so the mean over the ranks is
    the dense mean bit for bit; a ring reduce-scatter would fix another
    summation order, and sign() amplifies the difference.  The data that
    moves is the reduction's operand, so the op is the reduction round.
  * ``allgather_*`` -> ``all-gather``.
  * anything else (``gather_``, ``broadcast_``, ``barrier``, ``send``,
    ``recv_``, an unmapped op) -> its own name, outside both classes, so
    forbidden in the outer step.

Budgets (:meth:`CollectiveBudget.for_phase`): the logical rounds of
``obs.comm_model.phase_collective_budget`` (the reference's
``benchmarks/comm.py:124``), lowered as the port lowers them.  The
reference's XLA lowers a round leaf by leaf; the port lowers it dtype group
by dtype group (``comm.py``), so a round allows one model-payload op per
group and class.  The port's all-reduce of the worker mean is a scatter
plus a gather (without ZeRO each group's mean is scattered, then gathered;
under ZeRO the gather of x_{t+1,0} takes its place, and a group kept whole
gathers its mean instead), as the reference's reduction round is one
equivalence class of all-reduce and reduce-scatter: so ``global_dense``
has a gather round in the port too.  That is the port's lowering of the
same single round, not a wider budget.

Over a model axis (``distributed.mesh.Topology.model`` > 1) each recorded
op carries its process group, and the ops of the rank's model group are
counted apart: they are the tensor-parallel collectives of the local
steps (``distributed.tensor_parallel``), per layer and microbatch, and the
stat sums' all-reduce of a global phase, and they must equal, per kind in
calls and bytes, the count reckoned from the placements
(:func:`reckoned_model_ops`).  Under FSDP the ops of the rank's zero group
(the gathers of each layer's zero blocks, their gradients' reduce-scatters,
the round's loss all-reduce: ``tensor_parallel.local_phase_collectives``)
are counted apart the same way and must equal their reckoning
(:func:`reckoned_zero_ops`): the local phase admits them by count, as it
admits the model group's, and a stray one is caught.  The other ops, those
of the ``(worker, zero)`` ranks (under FSDP the worker peers and the stat
sums' all-reduce), stay held to the one-round budget over the rank's
blocks.

``standard_audit()`` runs the reference's matrix on R gloo ranks: the
dense, device-parallel and ZeRO-sharded outer steps, the bare local phase,
the trainer's step and, with ``self_test``, a planted extra all-reduce that
must fail.  ``python -m repro_torch.analysis audit`` runs it.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import sysconfig
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.lint import PACKAGE, package_path
from repro_torch.obs.comm_model import GATHER_CLASS, REDUCE_CLASS, phase_collective_budget
from repro_torch.obs.ledger import KIND_CLASS, stats_delta

# c10d op -> (the reference's kind, the argument that holds what this rank sends)
C10D_KINDS = {
    "allreduce_": ("all-reduce", "tensors"),
    "allreduce_coalesced_": ("all-reduce", "tensors"),
    "reduce_scatter_": ("reduce-scatter", "input_tensors"),
    "_reduce_scatter_base_": ("reduce-scatter", "input_tensor"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "inputs"),
    "alltoall_base_": ("reduce-scatter", "input"),
    "allgather_": ("all-gather", "input_tensors"),
    "_allgather_base_": ("all-gather", "input_tensor"),
    "allgather_coalesced_": ("all-gather", "input_list"),
    "allgather_into_tensor_coalesced_": ("all-gather", "inputs"),
}
# an unmapped op's payload: its first argument of these names (for a recv,
# the buffer it fills)
_SEND_ARGS = ("input", "input_tensor", "input_tensors", "input_list", "inputs", "tensors",
              "tensor")
# ops of at most this many bytes are metric ops (the reference's 1 KiB floor)
METRIC_BYTES = 1024
# the reference's payload headroom on every byte ceiling
PAYLOAD_SLACK = 1.5
# metric ops of a global phase: the loss gather, and the stat-sum all-reduce
METRIC_REDUCTIONS = 2
# elements per row of the reference's lane-aligned slab, the unit a group
# is split over the ranks in
SLAB_LANES = 128
COMM_FILE = "repro_torch/distributed/comm.py"

_LIBRARY_DIRS = tuple({os.path.dirname(torch.__file__), sysconfig.get_paths()["purelib"],
                       sysconfig.get_paths()["platlib"]})


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    kind: str      # the reference's kind, e.g. "all-reduce"
    op: str        # the c10d op, e.g. "allreduce_"
    shapes: tuple  # "dtype[dims]" of every tensor the rank sends
    bytes: int     # bytes this rank sends
    site: str      # "file:line" of the Python call that issued it
    group: str = ""  # the process group's name (``ProcessGroup.group_name``)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _site() -> str:
    """The innermost Python frame outside torch and the installed packages
    (``typing_extensions.deprecated`` wraps some of torch.distributed) that
    called the op, past this function, :func:`_record` and the recorder's
    dispatch."""
    frame = sys._getframe(3)
    while frame is not None and frame.f_code.co_filename.startswith(_LIBRARY_DIRS):
        frame = frame.f_back
    if frame is None:
        return "?"
    path = frame.f_code.co_filename
    inside = package_path(path)
    return f"{path if inside is None else PACKAGE + '/' + inside}:{frame.f_lineno}"


def _op_name(func) -> str:
    return func._schema.name.split("::", 1)[1]


def _record(func, args: tuple, kwargs: dict) -> CollectiveOp:
    name = _op_name(func)
    bound = {a.name: v for a, v in zip(func._schema.arguments, args)}
    bound.update(kwargs)
    kind, arg = C10D_KINDS.get(name, (name.strip("_"), None))
    if arg is None:
        arg = next((a for a in _SEND_ARGS if a in bound), None)
    sent = _tensors(bound.get(arg))
    return CollectiveOp(
        kind=kind, op=name,
        shapes=tuple(f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}" for t in sent),
        bytes=sum(t.numel() * t.element_size() for t in sent), site=_site(),
        group=_group_name(bound.get("process_group")))


def _group_name(pg) -> str:
    """The name of a c10d op's process group (the op's argument is the
    group boxed as a ``ScriptObject``)."""
    if pg is None:
        return ""
    from torch._C._distributed_c10d import ProcessGroup

    return ProcessGroup.unbox(pg).group_name


def group_name(group) -> str:
    """The name a recorded op carries for ``group`` (a ``torch.distributed``
    process group)."""
    return "" if group is None else group.group_name


class CollectiveRecorder(TorchDispatchMode):
    """Records every c10d op dispatched on this thread (``ops``); every op
    runs as it would without the mode."""

    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            self.ops.append(_record(func, args, kwargs))
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# Budgets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveBudget:
    """Per-phase ceiling on the collectives one outer step may issue on a
    rank: model-payload ops (more than ``METRIC_BYTES``) per class, metric
    ops (at most that) in both classes together, and bytes sent per class."""

    phase: str
    max_reduce_ops: int
    max_gather_ops: int
    max_metric_ops: int
    max_reduce_bytes: int
    max_gather_bytes: int
    reduce_class: tuple = REDUCE_CLASS
    gather_class: tuple = GATHER_CLASS
    # over a model axis: the model group's name and its ops, {kind: (calls,
    # bytes)} (:func:`reckoned_model_ops`), held apart from the ceilings above;
    # under FSDP the zero group's the same way (:func:`reckoned_zero_ops`)
    model_group: str = ""
    model_ops: Optional[dict] = None
    zero_group: str = ""
    zero_ops: Optional[dict] = None

    @classmethod
    def for_phase(cls, phase: str, layout, world: int, n_workers: int,
                  model_group: str = "", model_ops: Optional[dict] = None,
                  zero_group: str = "", zero_ops: Optional[dict] = None
                  ) -> "CollectiveBudget":
        """The budget of ``phase`` for a model of ``layout``
        (``FlatLayout``: its groups' element counts and dtypes) over
        ``world`` ranks holding ``n_workers`` workers.

        Only the rounds of ``obs.comm_model.phase_collective_budget`` are
        used; the ceilings are the port's lowering of them, worked out from
        the layout alone and not from ``distributed.zero``'s sharding, which
        is what the audit checks.  The reference's slab layout splits a
        group of n elements of s bytes into rows of ``SLAB_LANES`` and the
        rows evenly over the ranks, so a rank holds
        ``ceil(n / (SLAB_LANES * world)) * SLAB_LANES`` elements of it.
        Its reduction round (``scatter_rows``) sends that chunk of each of
        the rank's ``n_workers / world`` worker rows to every rank: about
        (n_workers / world) * n * s bytes, n_workers chunks; its gather
        round (the mean's, or x_{t+1,0}'s) sends one chunk.  Per class,
        with that class's rounds:

          * ops: ``rounds`` model-payload ops per dtype group, and every
            group op at or under ``METRIC_BYTES`` (a small f32 group's
            chunk) counted as a metric op instead, beside the
            ``METRIC_REDUCTIONS`` of a global phase;
          * bytes: the reference's ``rounds * (PAYLOAD_SLACK * payload +
            1 KiB)``, the 1 KiB floor absorbing the metric ops (the
            (tau, W_local) f32 losses, the seven f32 stat sums), which are
            assumed to stay under it (tau * W_local <= 256)."""
        numels = layout.group_numels
        shard = [-(-n // (SLAB_LANES * world)) * SLAB_LANES * dt.itemsize
                 for n, dt in zip(numels, layout.dtypes)]
        sends = {"reduce": [n_workers * b for b in shard], "gather": shard}
        raw = phase_collective_budget(phase, n_param_leaves=len(numels),
                                      payload_bytes=sum(sends["reduce"]))
        # the port's reduction round ends in a gather whichever phase runs it
        rounds = {"reduce": raw["reduce_rounds"],
                  "gather": max(raw["gather_rounds"], raw["reduce_rounds"])}
        ops, nbytes, small = {}, {}, 0
        for c in ("reduce", "gather"):
            ops[c] = rounds[c] * len(numels)
            nbytes[c] = rounds[c] * (int(PAYLOAD_SLACK * sum(sends[c])) + METRIC_BYTES)
            small += rounds[c] * sum(b <= METRIC_BYTES for b in sends[c])
        return cls(
            phase=phase,
            max_reduce_ops=ops["reduce"],
            max_gather_ops=ops["gather"],
            max_metric_ops=(METRIC_REDUCTIONS if rounds["reduce"] else 0) + small,
            max_reduce_bytes=nbytes["reduce"],
            max_gather_bytes=nbytes["gather"],
            model_group=model_group,
            model_ops=model_ops,
            zero_group=zero_group,
            zero_ops=zero_ops,
        )


def reckoned_model_ops(cfg, layout, phase: str, n_local: int, tau: int, b_micro: int, seq: int,
              accum: int = 1) -> dict:
    """``{kind: (calls, bytes)}`` of the model group's collectives in one
    outer step of ``phase`` on a model-parallel rank of ``layout``
    (``distributed.tensor_parallel.rank_layout``): every local step's
    forward and backward of each of its ``n_local`` workers' ``accum``
    microbatches of ``(b_micro, seq)``, reckoned from the placements layer
    by layer (``tensor_parallel.microbatch_collectives``), and in a global
    phase the all-reduce of the seven f32 stat sums."""
    from repro_torch.obs.metrics import N_STAT_SUMS

    out = _reckoned_ops(cfg, layout, "model", n_local, tau, b_micro, seq, accum)
    if phase != "local":
        calls, nbytes = out.get("all-reduce", (0, 0))
        out["all-reduce"] = (calls + 1, nbytes + N_STAT_SUMS * 4)
    return out


def reckoned_zero_ops(cfg, layout, phase: str, n_local: int, tau: int, b_micro: int, seq: int,
                      accum: int = 1) -> dict:
    """``{kind: (calls, bytes)}`` of an FSDP rank's zero-group collectives in
    one outer step of ``phase`` (``layout``: its zero blocks,
    ``tensor_parallel.topology_layout``): the local phase's
    (``tensor_parallel.local_phase_collectives``); a global phase without
    faults adds none (the stat sums add over the ``(worker, zero)`` ranks)."""
    return _reckoned_ops(cfg, layout, "zero", n_local, tau, b_micro, seq, accum)


def _reckoned_ops(cfg, layout, axis: str, n_local, tau, b_micro, seq, accum) -> dict:
    from repro_torch.distributed import tensor_parallel as TP

    out: dict = {}
    for name, rec in TP.local_phase_collectives(cfg, layout, n_local, tau, b_micro, seq,
                                                accum).items():
        base, _, group = name.partition("@")
        if group != axis:
            continue
        kind = KIND_CLASS[base]
        calls, nbytes = out.get(kind, (0, 0))
        out[kind] = (calls + rec["calls"], nbytes + rec["bytes"])
    return out


@dataclasses.dataclass
class AuditReport:
    name: str
    budget: CollectiveBudget
    ops: list
    violations: list
    config: str = ""
    degenerate: bool = False
    details: dict = dataclasses.field(default_factory=dict)
    model_ops: list = dataclasses.field(default_factory=list)   # the model group's
    zero_ops: list = dataclasses.field(default_factory=list)    # the zero group's

    @property
    def passed(self) -> bool:
        return not self.violations

    @property
    def counts(self) -> dict:
        c: dict = {}
        for op in self.ops:
            c[op.kind] = c.get(op.kind, 0) + 1
        return c

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "config": self.config,
            "phase": self.budget.phase,
            "passed": self.passed,
            "degenerate": self.degenerate,
            "counts": self.counts,
            "reduce_bytes": sum(o.bytes for o in self.ops
                                if o.kind in self.budget.reduce_class),
            "gather_bytes": sum(o.bytes for o in self.ops
                                if o.kind in self.budget.gather_class),
            "metric_ops": sum(o.bytes <= METRIC_BYTES for o in self.ops),
            "outside_comm": [o.site for o in self.ops if not _via_comm(o)],
            "budget": dataclasses.asdict(self.budget),
            "violations": list(self.violations),
            "ops": [dataclasses.asdict(o) for o in self.ops],
            "model_group_ops": {k: list(v) for k, v in ops_by_kind(self.model_ops).items()},
            "zero_group_ops": {k: list(v) for k, v in ops_by_kind(self.zero_ops).items()},
            **self.details,
        }


def _via_comm(op: CollectiveOp) -> bool:
    return op.site.startswith(COMM_FILE + ":")


def audit_ops(ops: Sequence[CollectiveOp], budget: CollectiveBudget,
              name: str = "step") -> AuditReport:
    """Check recorded ops against a budget (the reference's ``audit_text``)."""
    viol = []
    apart = {}
    for axis, group, want in (("model", budget.model_group, budget.model_ops),
                              ("zero", budget.zero_group, budget.zero_ops)):
        if not group:
            continue
        apart[axis] = [o for o in ops if o.group == group]
        ops = [o for o in ops if o.group != group]
        seen = ops_by_kind(apart[axis])
        if seen != want:
            viol.append(f"{axis}-group collectives (calls, bytes) per kind {seen} differ from "
                        f"the {want} reckoned from the placements")
    allowed = set(budget.reduce_class) | set(budget.gather_class)
    for o in ops:
        if o.kind not in allowed:
            viol.append(f"forbidden collective {o.kind} {list(o.shapes)} at {o.site}")
    metric = [o for o in ops if o.bytes <= METRIC_BYTES]
    reduce_ops = [o for o in ops if o.kind in budget.reduce_class]
    gather_ops = [o for o in ops if o.kind in budget.gather_class]
    n_reduce = sum(o.bytes > METRIC_BYTES for o in reduce_ops)
    n_gather = sum(o.bytes > METRIC_BYTES for o in gather_ops)
    if n_reduce > budget.max_reduce_ops:
        rounds = ("single logical round per dtype group" if budget.max_reduce_ops
                  else "zero rounds")
        viol.append(
            f"{n_reduce} reduction ops ({'/'.join(budget.reduce_class)}) exceed the budget "
            f"of {budget.max_reduce_ops} — a stray reduction beyond the phase's {rounds}")
    if n_gather > budget.max_gather_ops:
        viol.append(f"{n_gather} gather ops exceed the budget of {budget.max_gather_ops}")
    if len(metric) > budget.max_metric_ops:
        viol.append(f"{len(metric)} metric ops (<= {METRIC_BYTES} B) exceed the budget of "
                    f"{budget.max_metric_ops}")
    rbytes = sum(o.bytes for o in reduce_ops)
    gbytes = sum(o.bytes for o in gather_ops)
    if rbytes > budget.max_reduce_bytes:
        viol.append(f"reduction payload {rbytes} B exceeds the budget of "
                    f"{budget.max_reduce_bytes} B (what a rank sends x slack)")
    if gbytes > budget.max_gather_bytes:
        viol.append(f"gather payload {gbytes} B exceeds the budget of "
                    f"{budget.max_gather_bytes} B")
    return AuditReport(name=name, budget=budget, ops=list(ops), violations=viol,
                       model_ops=apart.get("model", []), zero_ops=apart.get("zero", []))


def ops_by_kind(ops: Sequence[CollectiveOp]) -> dict:
    """``{kind: (calls, bytes)}`` of recorded ops."""
    out: dict = {}
    for o in ops:
        calls, nbytes = out.get(o.kind, (0, 0))
        out[o.kind] = (calls + 1, nbytes + o.bytes)
    return out


def stats_by_kind(delta: dict) -> dict:
    """``{kind: (calls, bytes)}`` of a ``CommStats`` delta
    (``obs.ledger.stats_delta``), ``comm.py``'s names mapped to the kinds."""
    out: dict = {}
    for name, rec in delta.items():
        kind = KIND_CLASS[name.split("@")[0]]   # either group: "<name>@model"
        calls, nbytes = out.get(kind, (0, 0))
        out[kind] = (calls + rec["calls"], nbytes + rec["bytes"])
    return out


def audit_call(fn, args: Sequence, budget: CollectiveBudget, name: str = "step",
               stats=None) -> AuditReport:
    """Run ``fn(*args)`` once under a :class:`CollectiveRecorder` and audit
    what it issued (the reference's ``audit_jitted``).  With ``stats`` (the
    rank's ``CommStats``) the recorder's calls and bytes per kind of the
    ops issued from ``comm.py`` must equal what ``CommStats`` counted over
    the call."""
    before = stats.as_dict() if stats is not None else None
    with CollectiveRecorder() as rec:
        fn(*args)
    report = audit_ops(rec.ops, budget, name=name)
    if stats is not None:
        # both groups: CommStats counts the model group's too
        seen = ops_by_kind([o for o in rec.ops if _via_comm(o)])
        counted = stats_by_kind(stats_delta(before, stats.as_dict()))
        if seen != counted:
            report.violations.append(
                f"the recorder saw (calls, bytes) {seen} from {COMM_FILE}, CommStats counted "
                f"{counted}")
    return report


# ---------------------------------------------------------------------------
# The standard audit matrix
# ---------------------------------------------------------------------------

_AS_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _same_bits(a, b) -> bool:
    from repro_torch.groups import parts

    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x.view(_AS_INT[x.element_size()]),
                               y.view(_AS_INT[y.element_size()]))
               for x, y in zip(parts(a), parts(b), strict=True))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _line_up(device: torch.device, group) -> None:
    """The device idle and every rank here, so that a timed step does not
    wait for another rank's earlier work."""
    _sync(device)
    if group is not None:
        dist.barrier(group)


def audit_rank(rank: int, world: int, cfgs: Sequence, n_workers: int, tau: int, device: str,
               self_test: bool, b_micro: int, seq: int) -> list:
    """This rank's audit of every variant of each config of ``cfgs``
    (``world`` 1: this process, no group): ``[(name, AuditReport with its
    details)]``, config after config.  Each variant runs twice from the same
    state, unrecorded and then under the recorder, and the two must leave
    x0, m and the workers' params the same bits.  The details: the kernel
    launches of the recorded run, the seconds of each run (ended by a
    device sync) and whether the bits agree."""
    out = []
    for cfg in cfgs:
        out += _audit_config(world, cfg, n_workers, tau, torch.device(device), self_test,
                             b_micro, seq)
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _audit_config(world: int, cfg, n_workers: int, tau: int, dev: torch.device,
                  self_test: bool, b_micro: int, seq: int) -> list:
    from repro_torch import kernels as K
    from repro_torch.analysis import sanitize as SAN
    from repro_torch.core import (DSMConfig, constant, dsm_init, get_base_optimizer,
                                  make_dsm_step, make_local_phase)
    from repro_torch.distributed import mesh
    from repro_torch.groups import parts
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainSettings, build_algorithm

    group = dist.group.WORLD if dist.is_initialized() else None
    lay = T.layout(cfg)
    x0 = T.init_params(torch.Generator(dev).manual_seed(3), cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (n_workers, tau, 1, b_micro, seq),
                           generator=torch.Generator().manual_seed(3)).to(dev)
    base = get_base_optimizer("adamw")
    sched = constant(2e-2)

    def loss(p, mb):
        return T.loss_fn(p, mb, cfg, remat=False)

    def dsm(topo, **flags):
        step = make_dsm_step(loss, base, DSMConfig(tau=tau, **flags), sched, lay, topo)
        return step, lambda: dsm_init(x0, base, n_workers, topo,
                                      flags.get("zero_sharded", False))

    def variants():
        """(name, phase, topo, step, make_state, batch) of each variant."""
        yield ("dense", "local", None, *dsm(None), {"tokens": tokens})
        topo = mesh.topology(n_workers, group)
        yield ("device_parallel", "global_dense", topo,
               *dsm(topo, device_parallel_local=True), rows)
        topo = mesh.topology(n_workers, group)
        yield ("zero_sharded", "global_zero", topo,
               *dsm(topo, zero_sharded=True, device_parallel_local=True), rows)
        topo = mesh.topology(n_workers, group)
        local = make_local_phase(loss, base, lay)
        yield ("local_phase", "local", topo, lambda st, b: local(st, b, 2e-2),
               lambda: dsm_init(x0, base, n_workers, topo, False), rows)
        # the trainer's step (build_algorithm, metric pack and all) must fit
        # the same global_zero budget as the bare ZeRO step
        topo = mesh.topology(n_workers, group)
        s = TrainSettings(algorithm="dsm", n_workers=n_workers, tau=tau, steps=4,
                          zero_sharded=True, device_parallel_local=True)
        init, step, _, _ = build_algorithm(loss, s, lay, topo)
        yield ("trainer_instrumented_zero", "global_zero", topo,
               lambda st, b: step(st, b, None), lambda: init(x0, n_workers), rows)
        if self_test:
            # one extra all-reduce of every group's x0 after the
            # device-parallel step, straight through torch.distributed:
            # CommStats never sees it, the budget must
            topo = mesh.topology(n_workers, group)
            dp_step, make = dsm(topo, device_parallel_local=True)

            def planted(st, b, topo=topo, dp_step=dp_step):
                out = dp_step(st, b)
                if topo.group is not None:
                    for x in parts(st.x0):
                        buf = x.cpu() if topo.backend == "gloo" and x.is_cuda else x.clone()
                        dist.all_reduce(buf, group=topo.group)
                return out

            yield ("self_test_planted_all_reduce", "global_dense", topo, planted, make, rows)

    # the first calls' one-time costs (gloo's first collectives, the
    # recorder's first dispatch) before the timed runs: one ZeRO outer step
    # unrecorded, one local phase recorded
    topo = mesh.topology(n_workers, group)
    rows = {"tokens": tokens[topo.worker_slice]}
    step, make = dsm(topo, zero_sharded=True, device_parallel_local=True)
    warm = make()
    step(warm, rows)
    with CollectiveRecorder():
        make_local_phase(loss, base, lay)(warm, rows, 2e-2)
    del warm
    out = []
    for name, phase, topo, step, make_state, batch in variants():
        budget = CollectiveBudget.for_phase(phase, lay, world, n_workers)
        plain, recorded = make_state(), make_state()
        _line_up(dev, group)
        t0 = time.perf_counter()
        step(plain, batch)
        _sync(dev)
        plain_s = time.perf_counter() - t0
        K.reset_launch_counts()
        # the planted all-reduce stages through the host itself
        guard = SAN.no_implicit_host_sync(dev, enabled=not name.startswith("self_test"))
        _line_up(dev, group)
        t0 = time.perf_counter()
        with guard:
            report = audit_call(step, (recorded, batch), budget, name,
                                None if topo is None else topo.stats)
        _sync(dev)
        recorded_s = time.perf_counter() - t0
        same = all(_same_bits(getattr(recorded, k), getattr(plain, k))
                   for k in ("x0", "m", "params"))
        if not same:
            report.violations.append("the recorded step differs from the unrecorded one in "
                                     "its bits (x0, m or params)")
        report.config = cfg.name
        report.degenerate = world < 2
        report.details = {"launches": K.launch_counts(), "plain_s": plain_s,
                          "recorded_s": recorded_s, "bit_equal": same}
        out.append((name, report))
        del plain, recorded
    return out


def standard_audit(n_workers: int = 4, tau: int = 2, ranks: int = 4, device: str = "cuda",
                   self_test: bool = False, cfg=None, b_micro: int = 2, seq: int = 32,
                   timeout_s: float = 600.0, work_dir: Optional[str] = None) -> list:
    """Audit the dense, device-parallel and ZeRO-sharded outer steps, the
    bare local phase and the trainer's step of ``cfg`` (default nano; a
    list: each config in turn) over ``ranks`` gloo processes, all variants
    in one start of the ranks (``distributed.spawn.run_ranks``);
    ``self_test`` appends the planted all-reduce, which MUST fail.  Returns
    rank 0's reports, each holding the other ranks' violations (prefixed
    ``rank r:``) and every rank's details (lists, one entry per rank).

    ``ranks`` 1 runs in this process with no group: every collective is the
    identity, the reference's degenerate mesh, and each report says so."""
    from repro_torch.configs.nano import NANO
    from repro_torch.distributed import spawn
    from repro_torch.train.trainer import resolve_device

    cfgs = cfg if isinstance(cfg, (list, tuple)) else [cfg or NANO]
    dev = str(resolve_device(device))
    args = (cfgs, n_workers, tau, dev, self_test, b_micro, seq)
    if ranks == 1:
        per_rank = [audit_rank(0, 1, *args)]
    else:
        per_rank = spawn.run_ranks(audit_rank, ranks, args, timeout_s=timeout_s,
                                   group_timeout_s=120, work_dir=work_dir)
    reports = []
    for i, (name, report) in enumerate(per_rank[0]):
        others = [r[i][1] for r in per_rank]
        report.violations += [f"rank {r}: {v}" for r, o in enumerate(others) if r
                              for v in o.violations]
        report.details = {k: [o.details[k] for o in others] for k in report.details}
        reports.append(report)
    return reports
