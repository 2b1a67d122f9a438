"""Training over several ranks (``run_training(..., group=...)`` with
``zero_sharded`` / ``device_parallel_local``) against the port's dense run
of the same settings, on the CPU: 1 or 4 ``gloo`` processes at nano size,
from the same init and the same batches.

Every path must equal the dense run bit for bit, history and final state:
each rank runs its workers' forward and backward exactly as the dense
process runs them, and the scattered mean takes the dense path's f32 mean
over the columns it owns.  One anchor run is held against the reference's
dense ``run_training`` within the 2e-3 of ``test_torch_dsm.py``; the
reference's own device-parallel and ZeRO paths do not run on this tree
(``shard_map`` without ``check_rep``, ROADMAP.md).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks.tables import NANO as J_NANO
from repro.models import transformer as JT
from repro.train import trainer as JTR
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs.nano import NANO
from repro_torch.distributed import spawn
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.robustness.faults import FaultPlan, FaultSpec
from repro_torch.train.trainer import TrainSettings, run_training

import torch_ranks

ROOT = Path(__file__).resolve().parents[1]
KW = dict(tau=2, steps=3, b_micro=2, seq=32, eval_every=3, eval_batch=4)
BOTH = dict(zero_sharded=True, device_parallel_local=True)
DP = dict(device_parallel_local=True)
# per round: (dropped, stale, corrupt) workers; round 3 drops all of them
FAULT_ROUNDS = [((), (), ()), ((1,), (), ()), ((), (0,), (1,)), ((0, 1, 2, 3), (), ()),
                ((0,), (), (1,)), ((), (), ())]
SPIKE = dict(guard_spike_factor=0.9, checkpoint_every=1, guard_patience=2,
             guard_max_rollbacks=4)
PATHS = {
    "dsm-zero-dp": BOTH,
    "dsm-zero": dict(zero_sharded=True),
    "dsm-dp": DP,
    "signed_lookahead": dict(algorithm="signed_lookahead", **BOTH),
    "slowmo": dict(algorithm="slowmo", global_lr=1.0, **DP),
    "signed_slowmo": dict(algorithm="signed_slowmo", global_lr=0.005, **DP),
    "lookahead": dict(algorithm="lookahead", global_lr=1.0, **DP),
    "global_adamw": dict(algorithm="global_adamw", global_lr=1.0, **DP),
    "local_avg": dict(algorithm="local_avg", **DP),
    "perstep": dict(algorithm="perstep", **DP),           # every rank runs it whole
    "dsm-rand_pm": dict(sign_mode="rand_pm", **BOTH),
    "dsm-faults-guards": dict(steps=len(FAULT_ROUNDS), mask_nonfinite=True,
                              guard_nonfinite=True, **BOTH),
    "dsm-dp-faults-spike-rollback": dict(steps=len(FAULT_ROUNDS), mask_nonfinite=True,
                                         guard_nonfinite=True, **SPIKE, **DP),
}
GRIDS = [(4, 4), (2, 4), (4, 1)]        # (W, R)
FLAGS = ("zero_sharded", "device_parallel_local")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as every rank has: the dense run then sums in the
    ranks' order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(n_workers):
    plan = FaultPlan(n_workers, len(FAULT_ROUNDS), FaultSpec())
    for t, masks in enumerate(FAULT_ROUNDS):
        for arr, workers in zip((plan.drop, plan.stale, plan.corrupt), masks):
            arr[t, [w for w in workers if w < n_workers]] = True
    return plan


def _settings(path, n_workers, ckpt_dir=None, dense=False):
    kw = {**KW, **PATHS[path], "n_workers": n_workers}
    if "faults" in path:
        kw["faults"] = _plan(n_workers)
    if "rollback" in path:
        kw["checkpoint_dir"] = str(ckpt_dir)
    if dense:
        kw.update(dict.fromkeys(FLAGS, False))
    return TrainSettings(**kw)


def _x0():
    return T.init_params(torch.Generator().manual_seed(0), NANO)


@pytest.fixture(scope="module")
def ranks_runs(tmp_path_factory):
    """Every path on every grid: one run of R processes per grid, which then
    audits the device-parallel local phase and outer step (under the key
    ``"audit"``, one report pair per rank)."""
    out = {}
    for n_workers, world in GRIDS:
        d = tmp_path_factory.mktemp(f"W{n_workers}R{world}")
        settings = [_settings(p, n_workers, d / p) for p in PATHS]
        res = spawn.run_ranks(torch_ranks.train_and_audit_rank, world,
                              (NANO, settings, "cpu", _x0()), timeout_s=300,
                              group_timeout_s=60, work_dir=str(d))
        out[(n_workers, world)] = {p: [r[i] for r in res] for i, p in enumerate(PATHS)}
        out[(n_workers, world)]["audit"] = [r[-1] for r in res]
    return out


@pytest.fixture(scope="module")
def dense_runs(tmp_path_factory):
    cache = {}

    def get(path, n_workers):
        if (path, n_workers) not in cache:
            d = tmp_path_factory.mktemp(f"dense-{path}")
            res = run_training(NANO, _settings(path, n_workers, d, dense=True), device="cpu",
                               params=_x0())
            res["state"] = torch_ranks.flat_state(res["state"])
            cache[(path, n_workers)] = res
        return cache[(path, n_workers)]

    return get


def _assert_states_equal(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if isinstance(v, torch.Tensor):
            assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
            assert torch.equal(ours[k], v), k
        else:
            assert ours[k] == v, k


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"W{g[0]}-R{g[1]}")
def test_ranks_equal_the_dense_run_bit_for_bit(ranks_runs, dense_runs, grid, path):
    n_workers, world = grid
    ranks = ranks_runs[grid][path]
    dense = dense_runs(path, n_workers)
    for r in ranks:
        assert r["history"] == dense["history"]
        assert r["eval_losses"] == dense["eval_losses"]
        assert (r["skipped_rounds"], r["rollbacks"]) == (dense["skipped_rounds"],
                                                         dense["rollbacks"])
    _assert_states_equal(ranks[0]["state"], dense["state"])
    if "spike" in path:
        assert dense["skipped_rounds"] > 0 and dense["rollbacks"] > 0


@pytest.mark.parametrize("path,per_round", [
    ("dsm-zero-dp", {"gather_workers": 1, "scatter_rows": 1, "all_reduce_sum": 1,
                     "all_gather_shards": 1}),
    ("dsm-dp", {"gather_workers": 1, "scatter_rows": 1, "all_gather_shards": 1}),
    ("slowmo", {"gather_workers": 1, "scatter_rows": 1, "all_gather_shards": 1}),
    ("perstep", {}),
])
def test_collectives_per_round(ranks_runs, path, per_round):
    """ZeRO: one gather of the losses, one scatter of the worker chunks, ONE
    all-reduce of the (7,) stat sums and one all-gather of x_{t+1,0} per
    round; the replicated global step gathers the mean instead of reducing
    the sums; the local phase adds none."""
    for r in ranks_runs[(4, 4)][path]:
        got = {k: v["calls"] for k, v in r["comm"].items()}
        assert all(v["seconds"] >= 0 for v in r["comm"].values())     # timed on request
        assert got == {k: n * KW["steps"] for k, n in per_round.items()}
        if "all_reduce_sum" in got:
            assert r["comm"]["all_reduce_sum"]["bytes"] == KW["steps"] * 7 * 4


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"W{g[0]}-R{g[1]}")
def test_device_parallel_local_phase_audits_zero_collectives(ranks_runs, grid):
    """The reference's in-test audit (tests/test_device_parallel.py): the
    device-parallel local phase records ZERO collectives against the
    ``local`` budget, while one outer step does communicate, within the
    ``global_dense`` budget, the recorder agreeing with CommStats."""
    for audit in ranks_runs[grid]["audit"]:
        local, outer = audit["local_phase"], audit["outer_step"]
        assert local["passed"] and local["counts"] == {}, local
        assert outer["passed"], outer["violations"]
        assert outer["counts"] == {"all-gather": 2, "reduce-scatter": 1}
        assert outer["outside_comm"] == []


def test_anchor_run_matches_the_reference_dense_history(tmp_path):
    """Four ranks, ZeRO and the device-parallel local phase, against the
    reference's dense run_training from its own init and batches: the train
    losses and the final eval within 2e-3 relative
    (test_torch_dsm.py::test_run_training_matches_reference_history)."""
    kw = dict(n_workers=4, tau=4, steps=4, b_micro=2, seq=64, peak_lr=5e-3, global_lr=0.3,
              eval_every=2, eval_batch=8)
    jres = JTR.run_training(J_NANO, JTR.TrainSettings(**kw), corpus=None)
    jparams = JT.init_params(jax.random.PRNGKey(0), J_NANO)
    x0 = convert.from_jax_numpy(jax.tree.map(np.asarray, jparams), NANO, 1)[0]
    res = spawn.run_ranks(torch_ranks.train_rank, 4,
                          (NANO, [TrainSettings(**kw, **BOTH)], "cpu", x0), timeout_s=120,
                          group_timeout_s=60, work_dir=str(tmp_path))
    for r in res:
        np.testing.assert_allclose(r[0]["history"], jres["history"], rtol=2e-3)
        np.testing.assert_allclose([e for _, e in r[0]["eval_losses"]],
                                   [e for _, e in jres["eval_losses"]], rtol=2e-3)


# ---------------------------------------------------------------------------
# Checkpoints: the dense layout whatever the world, kill and resume
# ---------------------------------------------------------------------------

CK_KW = dict(KW, steps=4, checkpoint_every=2, checkpoint_keep=5, mask_nonfinite=True,
             guard_nonfinite=True)


def _copy_checkpoint(src: Path, step: int, dst: Path) -> Path:
    dst.mkdir()
    for suffix in (".npz", ".json"):
        shutil.copy(CK.step_path(str(src), step) + suffix, dst)
    return dst


def _ranks(world, settings, tmp_path):
    return spawn.run_ranks(torch_ranks.train_rank, world, (NANO, settings, "cpu", _x0()),
                           timeout_s=120, group_timeout_s=60, work_dir=str(tmp_path))


def test_zero_checkpoint_is_the_dense_checkpoint_and_resumes_bit_exact(tmp_path):
    """Four ZeRO ranks (W=4) write each checkpoint in the dense layout: the
    arrays equal a dense run's leaf by leaf.  Killed after the step-2
    checkpoint, the run resumes bit-exact under four ranks, and under one
    dense process (ZeRO R=4 -> dense)."""
    zs = TrainSettings(n_workers=4, checkpoint_dir=str(tmp_path / "zero"), **CK_KW, **BOTH)
    full = _ranks(4, [zs], tmp_path)[0][0]
    dense = run_training(NANO, TrainSettings(n_workers=4, checkpoint_dir=str(tmp_path / "dense"),
                                             **CK_KW), device="cpu", params=_x0())
    for step in (0, 2, 4):
        ours = CK.load_meta(CK.step_path(str(tmp_path / "zero"), step))
        theirs = CK.load_meta(CK.step_path(str(tmp_path / "dense"), step))
        assert ours["keys"] == theirs["keys"] and ours["extra"] == theirs["extra"]
        with np.load(CK.step_path(str(tmp_path / "zero"), step) + ".npz") as a, \
                np.load(CK.step_path(str(tmp_path / "dense"), step) + ".npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])

    killed = _copy_checkpoint(tmp_path / "zero", 2, tmp_path / "killed")
    resumed = _ranks(4, [TrainSettings(n_workers=4, checkpoint_dir=str(killed), resume=True,
                                       **CK_KW, **BOTH)], tmp_path)[0][0]
    assert len(resumed["outer_step_s"]) == 2
    assert resumed["history"] == full["history"] == dense["history"]
    _assert_states_equal(resumed["state"], full["state"])

    as_dense = run_training(NANO, TrainSettings(
        n_workers=4, checkpoint_dir=str(_copy_checkpoint(tmp_path / "zero", 2, tmp_path / "d")),
        resume=True, **CK_KW), device="cpu", params=_x0())
    assert as_dense["history"] == dense["history"]
    _assert_states_equal(torch_ranks.flat_state(as_dense["state"]),
                         torch_ranks.flat_state(dense["state"]))


def test_dense_checkpoint_resumes_on_two_ranks(tmp_path):
    """A dense run's step-2 checkpoint (W=2) resumed on two ZeRO ranks
    equals the uninterrupted dense run (dense -> R=2)."""
    dense = run_training(NANO, TrainSettings(n_workers=2, checkpoint_dir=str(tmp_path / "dense"),
                                             **CK_KW), device="cpu", params=_x0())
    killed = _copy_checkpoint(tmp_path / "dense", 2, tmp_path / "killed")
    res = _ranks(2, [TrainSettings(n_workers=2, checkpoint_dir=str(killed), resume=True,
                                   **CK_KW, **BOTH)], tmp_path)
    for r in res:
        assert r[0]["history"] == dense["history"]
    _assert_states_equal(res[0][0]["state"], torch_ranks.flat_state(dense["state"]))


# ---------------------------------------------------------------------------
# The launcher under torch.distributed.run
# ---------------------------------------------------------------------------

def test_launcher_runs_two_gloo_ranks_like_one_process():
    args = ["--device", "cpu", "--steps", "2", "--n-workers", "2", "--tau", "2", "--seq", "32",
            "--b-micro", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", *args, "--dist-backend", "gloo", "--zero-sharded",
         "--device-parallel-local"], env=env, capture_output=True, text=True, timeout=120)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
                         capture_output=True, text=True, timeout=120)
    assert one.returncode == 0, one.stderr[-3000:]
    lines = [ln for ln in ranks.stdout.splitlines() if ln.startswith(("step", "final"))]
    assert lines == [ln for ln in one.stdout.splitlines() if ln.startswith(("step", "final"))]
    assert len(lines) == 3      # rank 0 alone prints


def test_launcher_flags():
    from repro_torch.launch import train as launch

    args = launch.build_parser().parse_args([])
    assert (args.dist_backend, args.zero_sharded, args.device_parallel_local) == ("nccl", False,
                                                                                  False)
    args = launch.build_parser().parse_args(["--dist-backend", "gloo", "--zero-sharded",
                                             "--device-parallel-local"])
    assert (args.dist_backend, args.zero_sharded, args.device_parallel_local) == ("gloo", True,
                                                                                  True)
    assert launch.init_ranks(args) == (None, "cuda")     # no torch.distributed.run: one process
