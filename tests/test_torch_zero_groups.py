"""Mixed-dtype models over ranks: the ZeRO-sharded and device-parallel paths
(``repro_torch.distributed.zero``) group by group, against the port's
dense path, on the CPU.

The models are granite_moe, recurrentgemma and mamba2 SMOKE with bf16
parameters: two dtype groups each, the bf16 blocks and an f32 group (8
rows of granite's routers; one row of recurrentgemma's ``lam``; one row of
mamba2's ``A_log``, ``D``, ``dt_bias``), so two of them have a group that
the tiny-group rule (``zero.whole``) keeps whole on both ranks.  Two gloo
processes (``spawn.run_ranks``, one worker each) run every algorithm of
``TOPOLOGY_ALGORITHMS`` under ``zero_sharded`` + ``device_parallel_local``
or ``device_parallel_local`` alone, DSM with ``sign_mode="rand_pm"``, and
DSM under faults with guards and a checkpoint every round, which one
process then resumes.  Each must equal the dense run of the same settings
bit for bit: the history and every group of the final state (x0, m,
params, the AdamW moments).

The reference's pieces that run on jax 0.9.0 hold the unit cases: its
scattered worker mean (``zero.py:137``), its jnp sharded step
(``sharded_global_sign_momentum_step(use_kernel=False)``) and
``tree_stat_sums``, on a two-leaf tree (one bf16 leaf, one f32 leaf) on its
one-device mesh.  Its sharded training step has no live run here: the
device-parallel local phase (``core/dsm.py:353``), the kernel slab step
(``zero.py:239``) and the sharded stat sums (``zero.py:339``) go through
``shard_map(..., check_rep=False)``, which raises TypeError (ROADMAP.md
§3).  So the training runs over ranks are held against the port's dense
path, which ``test_torch_groups.py``, ``test_torch_moe.py`` and
``test_torch_recurrent.py`` hold against the JAX package's dense path for
these archs.
"""

import dataclasses
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.mesh as JMESH
from repro.core import dsm as JD
from repro.distributed import zero as JZ
from repro.obs import metrics as JM
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import load_arch
from repro_torch.core import dsm as D
from repro_torch.distributed import mesh, spawn
from repro_torch.distributed import zero as Z
from repro_torch.groups import Groups
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as OM
from repro_torch.obs import sinks as OS
from repro_torch.robustness.faults import FaultPlan, FaultSpec
from repro_torch.train.trainer import TOPOLOGY_ALGORITHMS, TrainSettings, run_training

import torch_ranks

ARCHS = ("granite_moe_3b_a800m", "recurrentgemma_2b", "mamba2_780m")
W = 2
KW = dict(n_workers=W, tau=2, steps=2, b_micro=1, seq=32, eval_every=2, eval_batch=2,
          peak_lr=1e-3, warmup=1)
BOTH = dict(zero_sharded=True, device_parallel_local=True)
DP = dict(device_parallel_local=True)
# per round: (dropped, stale, corrupt) workers; round 3 drops both
FAULT_ROUNDS = [((), (), ()), ((1,), (), ()), ((), (0,), (1,)), ((0, 1), (), ()),
                ((), (), ())]
RESUME_AT = 2
PATHS = {
    "dsm-zero-dp": BOTH,
    "dsm-dp": DP,
    "signed_lookahead": dict(algorithm="signed_lookahead", **BOTH),
    "slowmo": dict(algorithm="slowmo", global_lr=1.0, **DP),
    "signed_slowmo": dict(algorithm="signed_slowmo", global_lr=0.005, **DP),
    "lookahead": dict(algorithm="lookahead", global_lr=1.0, **DP),
    "global_adamw": dict(algorithm="global_adamw", global_lr=1.0, **DP),
    "local_avg": dict(algorithm="local_avg", **DP),
    "dsm-rand_pm": dict(sign_mode="rand_pm", **BOTH),
    "dsm-faults-guards": dict(steps=len(FAULT_ROUNDS), eval_every=len(FAULT_ROUNDS),
                              mask_nonfinite=True, guard_nonfinite=True, checkpoint_every=1,
                              checkpoint_keep=len(FAULT_ROUNDS) + 1, **BOTH),
}
FLAGS = ("zero_sharded", "device_parallel_local")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as every rank has: the dense run then sums in the
    ranks' order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return dataclasses.replace(load_arch(arch).SMOKE, param_dtype="bfloat16",
                               name=f"{arch}_smoke_bf16_params")


def _plan():
    plan = FaultPlan(W, len(FAULT_ROUNDS), FaultSpec())
    for t, masks in enumerate(FAULT_ROUNDS):
        for arr, workers in zip((plan.drop, plan.stale, plan.corrupt), masks):
            arr[t, list(workers)] = True
    return plan


def _settings(path, ckpt_dir=None, dense=False, **extra):
    kw = {**KW, **PATHS[path], **extra}
    if "faults" in path:
        kw.update(faults=_plan(), checkpoint_dir=str(ckpt_dir))
    if dense:
        kw.update(dict.fromkeys(FLAGS, False))
    return TrainSettings(**kw)


def _x0(cfg):
    return T.init_params(torch.Generator().manual_seed(0), cfg)


def test_every_model_has_two_groups_and_the_paths_cover_the_topology_algorithms():
    """The premise of this file: bf16 blocks and an f32 group, two of them
    kept whole on two ranks; every algorithm that splits its workers."""
    whole = []
    for arch in ARCHS:
        lay = T.layout(_cfg(arch))
        assert lay.dtypes == (torch.bfloat16, torch.float32)
        whole.append([Z.whole(n, W) for n in lay.group_numels])
    assert whole == [[False, False], [False, True], [False, True]]
    covered = {PATHS[p].get("algorithm", "dsm") for p in PATHS}
    assert covered == set(TOPOLOGY_ALGORITHMS)


@pytest.fixture(scope="module")
def ranks_runs(tmp_path_factory):
    """Every path of every arch: one run of two processes per arch."""
    out = {}
    for arch in ARCHS:
        d = tmp_path_factory.mktemp(f"ranks-{arch}")
        settings = [_settings(p, d / p) for p in PATHS]
        res = spawn.run_ranks(torch_ranks.train_rank, W,
                              (_cfg(arch), settings, "cpu", _x0(_cfg(arch))),
                              timeout_s=300, group_timeout_s=60, work_dir=str(d))
        out[arch] = ({p: [r[i] for r in res] for i, p in enumerate(PATHS)}, d)
    return out


@pytest.fixture(scope="module")
def dense_runs(tmp_path_factory):
    cache = {}

    def get(arch, path):
        if (arch, path) not in cache:
            d = tmp_path_factory.mktemp(f"dense-{arch}-{path}")
            cfg = _cfg(arch)
            res = run_training(cfg, _settings(path, d / path, dense=True), device="cpu",
                               params=_x0(cfg))
            res["state"] = torch_ranks.flat_state(res["state"])
            cache[(arch, path)] = (res, d / path)
        return cache[(arch, path)]

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
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_equal_the_dense_run_bit_for_bit(ranks_runs, dense_runs, arch, path):
    """Two ranks against the port's dense run of the same settings (the
    reference's sharded training step has no live run on jax 0.9.0): every rank's
    history, evals and skipped rounds, and rank 0's state gathered to the
    dense layout, each group's tensor named apart (``x0.0``, ``x0.1``)."""
    ranks = ranks_runs[arch][0][path]
    dense, _ = dense_runs(arch, path)
    for r in ranks:
        assert r["history"] == dense["history"]
        assert r["eval_losses"] == dense["eval_losses"]
        assert (r["skipped_rounds"], r["rollbacks"]) == (dense["skipped_rounds"],
                                                         dense["rollbacks"])
    state = ranks[0]["state"]
    assert {k for k in state if k.startswith("x0.")} == {"x0.0", "x0.1"}
    _assert_states_equal(state, dense["state"])
    assert all(np.isfinite(dense["history"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_faulted_ranks_checkpoint_resumes_in_one_process(ranks_runs, dense_runs, tmp_path,
                                                        arch):
    """The two ranks' checkpoints are the port's dense run's, array for
    array and sidecar for sidecar (the reference's npz + json; its sharded
    training step has no live run on jax 0.9.0); the one at step 2, resumed by one
    process (world 2 -> 1, the degenerate grid), ends bit-equal to the dense
    run."""
    path = "dsm-faults-guards"
    cfg = _cfg(arch)
    ranks_dir = ranks_runs[arch][1] / path
    dense, dense_dir = dense_runs(arch, path)
    for step in range(len(FAULT_ROUNDS) + 1):
        ours, theirs = CK.step_path(str(ranks_dir), step), CK.step_path(str(dense_dir), step)
        with np.load(ours + ".npz") as a, np.load(theirs + ".npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for f in b.files:
                assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), (step, f)
        assert json.loads(open(ours + ".json").read()) == json.loads(
            open(theirs + ".json").read())
    for suffix in (".npz", ".json"):
        shutil.copy(CK.step_path(str(ranks_dir), RESUME_AT) + suffix, tmp_path)
    s = _settings(path, tmp_path, resume=True)
    res = run_training(cfg, s, device="cpu", params=_x0(cfg))
    assert res["history"] == dense["history"]
    _assert_states_equal(torch_ranks.flat_state(res["state"]), dense["state"])


# ---------------------------------------------------------------------------
# Unit cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,shards,kept_whole", [
    (128, 2, True), (128, 4, True),           # one row on 2 and on 4 shards
    (48, 2, True),                            # mamba2 SMOKE's f32 group
    (1024, 2, False), (1024, 4, False), (1024, 16, True),   # granite SMOKE's 8 rows
    (5 * 128, 4, True),                       # 5 rows on 4: the last shard empty
    (6_912, 4, False), (368_640, 4, False),   # mamba2 FULL's, granite FULL's f32 groups
    (1, 1, False)])
def test_shard_bounds_per_group_and_the_tiny_group_rule(n, shards, kept_whole):
    """A group is sharded on 128-element rows when every rank gets a
    non-empty shard, else kept whole on every rank (bounds (0, n)), and
    ``shard_bounds`` refuses it."""
    assert Z.whole(n, shards) == kept_whole
    bounds = [Z.my_bounds(n, mesh.Topology(n_workers=shards, worker=shards, zero=1, rank=r))
              for r in range(shards)]
    if kept_whole:
        assert bounds == [(0, n)] * shards
        with pytest.raises(ValueError, match="too few"):
            Z.shard_bounds(n, shards)
        return
    assert bounds == Z.shard_bounds(n, shards)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a % 128 == 0 and a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    if n == 368_640:
        assert [b - a for a, b in bounds] == [92_160] * 4     # 720 rows per rank


@pytest.mark.parametrize("sharded", [True, False], ids=["zero", "replicated"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_round_trip_on_groups(tmp_path, arch, sharded):
    """``dense_host`` -> ``load_local_part`` -> ``gather_state`` on a
    two-group DSM + AdamW state over two ranks: each rank holds its worker's
    rows and its shard of each group of x0 and m (a whole group whole), and
    the state gathered to rank 0 equals the dense one bit for bit (the
    reference's sharded training step has no live run on jax 0.9.0)."""
    cfg = _cfg(arch)
    res = spawn.run_ranks(torch_ranks.groups_state_rank, W, (cfg, W, sharded), timeout_s=120,
                          group_timeout_s=60, work_dir=str(tmp_path))
    dense = res[0]["dense"]
    _assert_states_equal(res[0]["gathered"], dense)
    numels = T.layout(cfg).group_numels
    for r, out in enumerate(res):
        for g, n in enumerate(numels):
            a, b = out["bounds"][g] if sharded else (0, n)
            for field in ("x0", "m"):
                assert torch.equal(out["mine"][f"{field}.{g}"], dense[f"{field}.{g}"][a:b])
            assert torch.equal(out["mine"][f"params.{g}"], dense[f"params.{g}"][r:r + 1])
            assert torch.equal(out["mine"][f"base_state.v.{g}"],
                               dense[f"base_state.v.{g}"][r:r + 1])
        assert (out["mine"]["t"], out["mine"]["inner"]) == (3, 36)


N_BF16 = 5003
STEP_GRIDS = [(2, 2), (4, 4)]            # (W, R)
STEP_KINDS = [(100, "sign"), (1100, "sign"), (100, "rand_pm"), (1100, "rand_zero")]


def _groups_case(n_workers, n_f32, sign_mode):
    rng = np.random.default_rng([n_workers, n_f32, len(sign_mode)])
    case = {"params": [], "x0": [], "m": [], "dtype": ["bfloat16", "float32"],
            "gamma": 0.01, "cfg": dict(global_lr=0.3, sign_mode=sign_mode), "seed": 3}
    for n in (N_BF16, n_f32):
        x0 = rng.standard_normal(n).astype(np.float32)
        case["x0"].append(x0)
        case["params"].append(
            (x0[None] - 0.003 * rng.standard_normal((n_workers, n))).astype(np.float32))
        case["m"].append(rng.standard_normal(n).astype(np.float32))
    return case


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    out = {}
    for n_workers, world in STEP_GRIDS:
        cases = [_groups_case(n_workers, *k) for k in STEP_KINDS]
        res = spawn.run_ranks(torch_ranks.groups_step_rank, world, (cases,), timeout_s=120,
                              group_timeout_s=60, work_dir=str(tmp_path_factory.mktemp("s")))
        out[(n_workers, world)] = (cases, res)
    return out


def _dense(case):
    dts = [getattr(torch, d) for d in case["dtype"]]
    params = Groups(torch.from_numpy(p).to(dt) for p, dt in zip(case["params"], dts))
    x_tau = D.worker_mean(params)
    # copies: the step updates them in place
    x0 = Groups(torch.tensor(x).to(dt) for x, dt in zip(case["x0"], dts))
    m = Groups(torch.from_numpy(x.copy()) for x in case["m"])
    stat = OM.stat_sums(x0, m, x_tau, case["gamma"], 0.95)
    D.global_sign_momentum_step(x0, m, x_tau, case["gamma"], D.DSMConfig(**case["cfg"]),
                                rng=torch.Generator().manual_seed(case["seed"]))
    return x_tau, stat, x0, m


KIND_IDS = {"ids": lambda k: f"f32_{STEP_KINDS[k][0]}-{STEP_KINDS[k][1]}"}
GRID_IDS = {"ids": lambda g: f"W{g[0]}-R{g[1]}"}


def _tree(arrays, dtypes):
    """The reference's pytree of a case's groups: leaf ``a`` the bf16 group,
    ``b`` the f32 one (leaf order = group order)."""
    return {k: jnp.asarray(a).astype(getattr(jnp, d))
            for k, a, d in zip("ab", arrays, dtypes, strict=True)}


def _bits_equal(ours: torch.Tensor, theirs):
    a, b = ours.float().numpy(), np.asarray(theirs, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("grid", STEP_GRIDS, **GRID_IDS)
@pytest.mark.parametrize("kind", range(len(STEP_KINDS)), **KIND_IDS)
def test_groups_scattered_mean_is_the_reference_mean_bit_for_bit(step_runs, grid, kind):
    """A bf16 group of 5003 and an f32 group of 100 (kept whole) or 1100 (9
    rows: sharded on 2 ranks, whole on 4): the shards of each group's mean,
    concatenated, and the replicated mean equal the reference's
    ``_scattered_worker_mean`` on the two-leaf tree (its one-device mesh)
    and the port's dense mean, bit for bit.  Each rank scatters each group
    once per mean: 2 + 2 calls."""
    cases, res = step_runs[grid]
    case = cases[kind]
    x_tau = _dense(case)[0]
    theirs = JZ._scattered_worker_mean(_tree(case["params"], case["dtype"]),
                                       JMESH.host_training_mesh(grid[0]))
    world = grid[1]
    for g, leaf in enumerate("ab"):
        n = case["x0"][g].shape[0]
        if Z.whole(n, world):
            assert all(r[kind]["bounds"][g] == (0, n) for r in res)
            shards = res[0][kind]["x_tau"][g]
            assert all(torch.equal(r[kind]["x_tau"][g], shards) for r in res)
        else:
            shards = torch.cat([r[kind]["x_tau"][g] for r in res])
        _bits_equal(shards, theirs[leaf])
        assert torch.equal(shards, x_tau[g])
        for r in res:
            _bits_equal(r[kind]["x_tau_full"][g], theirs[leaf])
            assert torch.equal(r[kind]["x_tau_full"][g], x_tau[g])
    for r in res:
        assert r[kind]["comm"]["scatter_rows"]["calls"] == 2 * 2       # the mean, twice


@pytest.mark.parametrize("grid", STEP_GRIDS, **GRID_IDS)
@pytest.mark.parametrize("kind", range(len(STEP_KINDS)), **KIND_IDS)
def test_groups_sharded_step_is_the_reference_step_bit_for_bit(step_runs, grid, kind):
    """x0 / m of each group after the sharded step, gathered: the
    deterministic sign against the reference's
    ``sharded_global_sign_momentum_step(use_kernel=False)`` on the two-leaf
    tree (its one-device mesh), every sign mode against the port's dense
    step (the randomized signs draw each group's uniforms in group order
    from the torch generator, so the reference's jax draws are not the
    same bits), bit for bit."""
    cases, res = step_runs[grid]
    case = cases[kind]
    _, _, x0, m = _dense(case)
    theirs = None
    if case["cfg"]["sign_mode"] == "sign":
        theirs = JZ.sharded_global_sign_momentum_step(
            _tree(case["x0"], case["dtype"]), _tree(case["m"], ["float32"] * 2),
            _tree(case["params"], case["dtype"]), jnp.float32(case["gamma"]),
            JD.DSMConfig(use_kernel=False, **case["cfg"]), JMESH.host_training_mesh(grid[0]))
    for r in res:
        out = r[kind]
        for g, leaf in enumerate("ab"):
            assert out["x0"][g].dtype == x0[g].dtype and torch.equal(out["x0"][g], x0[g])
            assert torch.equal(out["m"][g], m[g])
            if theirs is not None:
                _bits_equal(out["x0"][g], theirs[0][leaf])
                _bits_equal(out["m"][g], theirs[1][leaf])


@pytest.mark.parametrize("grid", STEP_GRIDS, **GRID_IDS)
@pytest.mark.parametrize("kind", range(len(STEP_KINDS)), **KIND_IDS)
def test_groups_sharded_stat_sums_match_tree_stat_sums(step_runs, grid, kind):
    """One all-reduce of each rank's group sums, added in group order with a
    whole group counted once: within 1e-6 relative of the reference's
    ``tree_stat_sums`` over the whole two-leaf tree and of the port's dense
    ``stat_sums`` (another summation order), the sign-agreement count
    exactly; every rank holds the same vector."""
    cases, res = step_runs[grid]
    case = cases[kind]
    x_tau, stat = _dense(case)[:2]
    theirs = np.asarray(JM.tree_stat_sums(
        _tree(case["x0"], case["dtype"]), _tree(case["m"], ["float32"] * 2),
        _tree([t.float().numpy() for t in x_tau], case["dtype"]),
        jnp.float32(case["gamma"]), 0.95))
    for r in res:
        ours = r[kind]["stat"].numpy()
        np.testing.assert_allclose(ours, theirs, rtol=1e-6)
        np.testing.assert_allclose(ours, stat.numpy(), rtol=1e-6)
        assert ours[3] == theirs[3] == stat[3]
        np.testing.assert_array_equal(ours, res[0][kind]["stat"].numpy())
        assert r[kind]["comm"]["all_reduce_sum"]["calls"] == 1


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_comm_ledger_of_a_two_group_round_equals_comm_stats(tmp_path, arch):
    """One ZeRO round of a two-group model over two ranks with a run
    directory: the ledger's observed bytes are rank 0's CommStats and the
    hand count (each group's chunks to every owner and its chunk into the
    all-gather, in its dtype, whether it is sharded or kept whole; the
    losses; the stat sums); the prediction adds each group's elements at
    4 B.  The reference's sharded training step has no live run on jax
    0.9.0 to compare with."""
    cfg = _cfg(arch)
    lay = T.layout(cfg)
    s = TrainSettings(**{**KW, **BOTH, "steps": 1, "eval_every": 1,
                         "run_dir": str(tmp_path / "run")})
    ranks = spawn.run_ranks(torch_ranks.train_rank, W, (cfg, [s], "cpu", _x0(cfg)),
                            timeout_s=300, group_timeout_s=60, work_dir=str(tmp_path))
    _, events, _ = OS.read_run(str(tmp_path / "run"))
    (led,) = [e for e in events if e["kind"] == "comm_ledger"]
    comm = ranks[0][0]["comm"]
    assert led["observed"]["by_kind"] == {k: {"calls": v["calls"], "bytes": v["bytes"]}
                                          for k, v in comm.items()}
    chunks = [(Z.chunk_size(n, W), dt.itemsize) for n, dt in zip(lay.group_numels, lay.dtypes)]
    want_reduce = sum(W * c * b for c, b in chunks) + OM.N_STAT_SUMS * 4
    want_gather = sum(c * b for c, b in chunks) + s.tau * 4
    assert led["observed"]["reduce_bytes"] == want_reduce
    assert led["observed"]["gather_bytes"] == want_gather
    assert sum(v["bytes"] for v in comm.values()) == want_reduce + want_gather
    assert comm["scatter_rows"]["calls"] == comm["all_gather_shards"]["calls"] == 2
    assert led["predicted"]["payload_bytes"] == 4 * lay.numel
