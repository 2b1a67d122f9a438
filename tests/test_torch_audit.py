"""The port's collective audit (``repro_torch.analysis.collective_audit``):
the budget model against the reference's ``benchmarks/comm.py``, the
recorder against ``comm.py``'s own ``CommStats`` on gloo CPU ranks, and
``python -m repro_torch.analysis audit`` over four CPU ranks with the
assertions of the reference's ``test_audit_cli_8dev_matrix_and_self_test``."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks.comm import phase_collective_budget as ref_budget
from repro_torch.analysis import sanitize as SAN
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.collective_audit import (METRIC_BYTES, CollectiveBudget,
                                                   CollectiveOp, CollectiveRecorder, audit_ops,
                                                   ops_by_kind, stats_by_kind)
from repro_torch.configs import load_arch
from repro_torch.configs.nano import NANO
from repro_torch.distributed import spawn
from repro_torch.distributed import zero as Z
from repro_torch.models import transformer as T
from repro_torch.obs.comm_model import PHASES, phase_collective_budget

import torch_ranks

ROOT = Path(__file__).resolve().parents[1]
GRANITE_BF16 = dataclasses.replace(load_arch("granite_moe_3b_a800m").SMOKE,
                                   param_dtype="bfloat16")


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("leaves,payload,metric", [(1, 0, 2), (7, 280_576, 2),
                                                   (40, 123_882_240 * 4, 3)])
def test_budget_model_is_the_reference_s(phase, leaves, payload, metric):
    kw = dict(n_param_leaves=leaves, payload_bytes=payload, n_metric_reductions=metric)
    assert phase_collective_budget(phase, **kw) == ref_budget(phase, **kw)
    with pytest.raises(ValueError, match="phase must be one of"):
        phase_collective_budget("global", **kw)


def test_for_phase_lowers_a_round_group_by_group():
    """Two dtype groups over four ranks: a round allows one payload op per
    group and class, the bytes of what a rank sends times 1.5 plus 1 KiB;
    granite's f32 router chunk (2 rows of 128 f32 = 1 KiB) counts as a
    metric op.  global_dense has the port's gather round too."""
    lay = T.layout(GRANITE_BF16)
    assert len(lay.group_numels) == 2
    chunks = [Z.chunk_size(n, 4) for n in lay.group_numels]
    sizes = [dt.itemsize for dt in lay.dtypes]
    scatter = sum(4 * c * s for c, s in zip(chunks, sizes))
    gather = sum(c * s for c, s in zip(chunks, sizes))
    assert chunks[1] * sizes[1] <= METRIC_BYTES < chunks[0] * sizes[0]
    for phase in ("global_dense", "global_zero"):
        b = CollectiveBudget.for_phase(phase, lay, world=4, n_workers=4)
        assert (b.max_reduce_ops, b.max_gather_ops, b.max_metric_ops) == (2, 2, 3)
        assert b.max_reduce_bytes == int(1.5 * scatter) + 1024
        assert b.max_gather_bytes == int(1.5 * gather) + 1024
    b = CollectiveBudget.for_phase("local", lay, world=4, n_workers=4)
    assert (b.max_reduce_ops, b.max_gather_ops, b.max_metric_ops, b.max_reduce_bytes,
            b.max_gather_bytes) == (0, 0, 0, 0, 0)


def _op(kind, nbytes, op="allreduce_"):
    return CollectiveOp(kind, op, (f"uint8[{nbytes}]",), nbytes, "test.py:1")


def test_audit_ops_violations():
    b = CollectiveBudget.for_phase("global_dense", T.layout(NANO), world=4, n_workers=4)
    big = b.max_reduce_bytes // 2
    ok = audit_ops([_op("reduce-scatter", big), _op("all-gather", 8), _op("all-gather", 2048)],
                   b)
    assert ok.passed and ok.counts == {"reduce-scatter": 1, "all-gather": 2}
    bad = audit_ops([_op("reduce-scatter", big), _op("all-reduce", big + 1024),
                     _op("barrier", 1, "barrier"), _op("all-gather", 8), _op("all-gather", 8)],
                    b)
    assert not bad.passed
    assert any("forbidden collective barrier" in v for v in bad.violations)
    assert any("2 reduction ops" in v and "exceed" in v for v in bad.violations)
    assert any("reduction payload" in v and "exceeds" in v for v in bad.violations)
    assert any("3 metric ops" in v for v in bad.violations)
    assert json.loads(json.dumps(bad.to_json()))["outside_comm"] == ["test.py:1"] * 5


def test_recorder_nests_with_checkpoint_and_the_sanitizer():
    """The recorder changes no bit of a remat forward and backward (under
    torch.utils.checkpoint's own dispatch mode for ``"dots"``) and nests in
    ``no_implicit_host_sync``; it records no collective there."""
    x0 = T.init_params(torch.Generator().manual_seed(0), NANO)
    batch = {"tokens": torch.randint(0, NANO.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(1))}

    def grads(record: bool, policy: str):
        p = x0.clone().requires_grad_(True)
        views = T.layout(NANO).views(p)
        rec = CollectiveRecorder()
        with SAN.no_implicit_host_sync(), rec if record else SAN.no_implicit_host_sync():
            loss = T.loss_fn(views, batch, NANO, remat=True, remat_policy=policy)
            loss.backward()
        return loss.detach(), p.grad, rec.ops

    for policy in ("full", "dots"):
        plain, recorded = grads(False, policy), grads(True, policy)
        assert torch.equal(plain[0], recorded[0]) and torch.equal(plain[1], recorded[1])
        assert recorded[2] == []


def test_recorder_sees_every_comm_collective_with_commstats_bytes(tmp_path):
    """Two gloo CPU ranks: each of comm.py's collectives is one recorded op
    of its kind, issued from comm.py, with CommStats' calls and bytes; the
    raw torch.distributed calls are recorded with their kinds, the ones
    outside both classes as themselves."""
    res = spawn.run_ranks(torch_ranks.recorded_collectives_rank, 2, (2,), timeout_s=120,
                          group_timeout_s=60, work_dir=str(tmp_path))
    for rank, r in enumerate(res):
        ops = r["ops"]
        assert [o.kind for o in ops] == ["all-gather", "reduce-scatter", "all-gather",
                                         "all-reduce", "all-reduce", "gather", "all-reduce"]
        assert all(o.site.startswith("repro_torch/distributed/comm.py:") for o in ops)
        assert ops_by_kind(ops) == stats_by_kind(r["stats"])
        assert ops[3].shapes == ("float32[7]",) and ops[3].bytes == 28
        raw = [o.kind for o in r["raw"]]
        assert raw == ["barrier", "broadcast", "all-gather", "reduce-scatter",
                       "send" if rank == 0 else "recv"]
        assert all("torch_ranks.py:" in o.site for o in r["raw"])


def test_planted_barrier_in_the_local_phase_is_forbidden(tmp_path):
    res = spawn.run_ranks(torch_ranks.planted_barrier_rank, 2, (2,), timeout_s=120,
                          group_timeout_s=60, work_dir=str(tmp_path))
    for r in res:
        assert not r["passed"]
        assert r["counts"] == {"barrier": 2}       # one per local step (tau 2)
        assert any("forbidden collective barrier" in v for v in r["violations"])
        assert r["outside_comm"] and all("torch_ranks.py:" in site
                                         for site in r["outside_comm"])


def test_oversized_chunk_fails_on_bytes(tmp_path):
    """A lowering that sends twice what the layout says a rank sends fails
    on bytes alone, whether the copy of scatter_rows pads its chunks or the
    sharding's own chunk size grows: the ceilings come from the layout, not
    from distributed.zero."""
    res = spawn.run_ranks(torch_ranks.oversized_chunk_rank, 2, (2, 2), timeout_s=120,
                          group_timeout_s=60, work_dir=str(tmp_path))
    for r in res:
        for plant in ("padded_scatter_rows", "inflated_chunk_size"):
            report = r[plant]
            assert not report["passed"], plant
            assert any("reduction payload" in v and "exceeds" in v
                       for v in report["violations"]), (plant, report["violations"])
            assert not any("ops" in v or "CommStats" in v for v in report["violations"]), plant
        assert any("gather payload" in v and "exceeds" in v
                   for v in r["inflated_chunk_size"]["violations"])


def test_audit_cli_4_cpu_ranks_matrix_and_self_test():
    """`python -m repro_torch.analysis audit --device cpu --json --self-test`
    over four gloo ranks: dense / device-parallel / ZeRO-sharded / trainer
    budgets pass, the local phase records ZERO collectives, ZeRO gathers,
    every recorded step is bit-equal to the same step unrecorded, and the
    planted all-reduce (outside comm.py, unseen by CommStats) is caught on
    both its op count and its bytes (reported failed, overall exit 0)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "audit", "--device", "cpu", "--json",
         "--self-test"], capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    payload = json.loads(proc.stdout)
    assert payload["n_ranks"] == 4 and payload["device"] == "cpu"
    assert not payload["degenerate"]
    assert payload["passed"]
    by_name = {r["name"]: r for r in payload["reports"]}
    for name in ("dense", "device_parallel", "zero_sharded", "trainer_instrumented_zero"):
        assert by_name[name]["passed"], by_name[name]
    assert by_name["dense"]["counts"] == {}
    assert by_name["local_phase"]["counts"] == {}, by_name["local_phase"]
    assert by_name["zero_sharded"]["counts"].get("all-gather", 0) > 0
    for r in payload["reports"]:
        assert r["bit_equal"] == [True] * 4, r["name"]
        assert len(r["launches"]) == 4
    planted = by_name["self_test_planted_all_reduce"]
    assert planted["passed"] is False
    assert any("reduction ops" in v and "exceed" in v for v in planted["violations"])
    assert any("payload" in v and "exceed" in v for v in planted["violations"])
    assert planted["outside_comm"] and all(
        s.startswith("repro_torch/analysis/collective_audit.py:") for s in planted["outside_comm"])
    assert not any("CommStats" in v for v in planted["violations"])


def test_audit_world_of_one_is_degenerate(capsys):
    assert main(["audit", "--device", "cpu", "--ranks", "1"]) == 1
    assert "degenerate" in capsys.readouterr().out
    assert main(["audit", "--device", "cpu", "--ranks", "1", "--allow-degenerate",
                 "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["degenerate"] and all(r["degenerate"] and r["counts"] == {}
                                         for r in payload["reports"])


def test_model_axis_audit():
    """Four gloo ranks of (worker 2, zero 1, model 2), minitron_4b SMOKE:
    every recorded op carries its group; the model group's ops of the outer
    step equal, per kind, the count reckoned from the placements, and the
    (worker, zero) ranks' ops fit the one-round budget over the rank's
    blocks; an all-reduce of the rank's x0 blocks over its (worker, zero)
    ranks planted inside the local phase is caught on count and bytes,
    while the local phase's model-group ops still match."""
    _model_axis_audit(load_arch("minitron_4b").SMOKE)


def test_model_axis_audit_moe():
    """:func:`test_model_axis_audit` on granite_moe SMOKE: its MoE layers
    split over the model group (the router's logits gathered, the experts'
    outputs all-reduced) count as the placements' reckoning."""
    _model_axis_audit(load_arch("granite_moe_3b_a800m").SMOKE)


def test_model_axis_audit_recurrent():
    """:func:`test_model_axis_audit` on recurrentgemma SMOKE: its RG-LRU
    layers split by channels over the model group (the conv output
    gathered, its gradient reduce-scattered, the output all-reduced) count
    as the placements' reckoning."""
    _model_axis_audit(load_arch("recurrentgemma_2b").SMOKE)


def _model_axis_audit(cfg) -> None:
    ranks = spawn.run_ranks(torch_ranks.tp_audit_rank, 4, (cfg, 2, 2, 2), timeout_s=300)
    for r in ranks:
        step = r["outer_step"]
        assert step["passed"], step["violations"]
        assert step["model_group_ops"]["all-reduce"][0] > 0
        assert step["model_group_ops"]["all-gather"][0] > 0
        groups = {o["group"] for o in step["ops"]}
        assert len(groups) == 1 and "" not in groups
        planted = r["planted_local_phase"]
        assert not planted["passed"]
        assert any("reduction ops" in v and "exceed" in v for v in planted["violations"])
        assert any("payload" in v and f"{r['planted_bytes']} B" in v
                   for v in planted["violations"])
        assert not any("model-group" in v for v in planted["violations"])


def test_fsdp_audit():
    """Four gloo ranks of (worker 2, zero 2, model 1) under FSDP,
    minitron_4b SMOKE, B_micro 2 over zero: the zero group's ops of the
    outer step (each layer's gathers and reduce-scatters, the losses'
    all-reduce) equal the reckoning per kind, and the rest (the worker
    peers' round, the stat sums' all-reduce) fit the one-round budget over
    the rank's zero blocks; an extra all-gather over the zero group planted
    in the local phase is caught on the zero group's count alone."""
    cfg = load_arch("minitron_4b").SMOKE
    ranks = spawn.run_ranks(torch_ranks.fsdp_audit_rank, 4, (cfg, 2, 1, 2), timeout_s=300)
    for r in ranks:
        step = r["outer_step"]
        assert step["passed"], step["violations"]
        assert step["zero_group_ops"]["all-gather"][0] > 0
        assert step["zero_group_ops"]["reduce-scatter"][0] > 0
        planted = r["planted_local_phase"]
        assert not planted["passed"]
        assert [v for v in planted["violations"] if "zero-group" in v] == planted["violations"]
