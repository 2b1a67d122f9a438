"""The port's rank grid, collectives and ZeRO-sharded global step
(``repro_torch.distributed``) against the JAX package's
(``repro.launch.mesh``, ``repro.distributed.zero``) and against the port's
dense path, on the CPU.

The multi-rank cases run 2 or 4 processes over ``gloo``
(``spawn.run_ranks``, file rendezvous, 60 s group timeout).  The reference
runs its pieces on its one-device mesh (worker = zero = 1): its kernel path
and its sharded stat sums cannot run on this tree (``shard_map`` without
``check_rep``, ROADMAP.md), so the stat sums are held against
``tree_stat_sums``.  The worker means and the global step are compared bit
for bit: each rank takes the same f32 mean over its columns that the dense
path takes over all of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.mesh as JMESH
from repro.core import dsm as JD
from repro.core.base_opt import sgd as jsgd
from repro.distributed import zero as JZ
from repro.obs import metrics as JM
from repro_torch.core import dsm as D
from repro_torch.distributed import mesh, spawn
from repro_torch.distributed import zero as Z

import torch_ranks

N = 5003                   # not a multiple of 128: the last shard is shorter
GAMMA = 0.01
CFG = dict(global_lr=0.3)
GRIDS = [(2, 2), (4, 4), (2, 4)]     # (W, R): one worker per rank; zero = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The rank grid: the reference's host_training_mesh over R ranks
# ---------------------------------------------------------------------------

def _reference_grid(monkeypatch, n_workers, world):
    monkeypatch.setattr(jax, "devices", lambda: [object() for _ in range(world)])
    monkeypatch.setattr(JMESH, "Mesh", lambda grid, axes: dict(zip(axes, grid.shape)))
    return JMESH.host_training_mesh(n_workers)


@pytest.mark.parametrize("n_workers,world", [(4, 4), (2, 4), (4, 1), (1, 4), (2, 8), (8, 8),
                                             (1, 1)])
def test_grid_matches_host_training_mesh(monkeypatch, n_workers, world):
    dims = _reference_grid(monkeypatch, n_workers, world)
    assert mesh.grid(n_workers, world) == (dims["worker"], dims["zero"])
    assert dims["model"] == 1


@pytest.mark.parametrize("n_workers,world", [(4, 2), (3, 4), (3, 8)])
def test_grid_raises_the_reference_message(monkeypatch, n_workers, world):
    with pytest.raises(ValueError) as theirs:
        _reference_grid(monkeypatch, n_workers, world)
    with pytest.raises(ValueError) as ours:
        mesh.grid(n_workers, world)
    assert str(ours.value) == str(theirs.value)
    assert "does not divide" in str(ours.value)


def test_rank_holds_its_worker_group_and_owns_its_chunk():
    """Rank r = w * Z + z: worker group w's workers, shard r (the
    reference's chunk order, zero.py:225-226)."""
    for r, (w, z) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        t = mesh.Topology(n_workers=4, worker=2, zero=2, rank=r)
        assert (t.world, t.worker_index, t.zero_index, t.local_workers) == (4, w, z, 2)
        assert t.worker_slice == slice(2 * w, 2 * w + 2)
        assert Z.my_bounds(N, t) == Z.shard_bounds(N, 4)[r]
    one = mesh.topology(4)           # no group: the one-device degenerate grid
    assert (one.world, one.worker, one.local_workers, one.worker_slice) == (1, 1, 4, slice(0, 4))


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_shard_bounds_cover_n_with_128_aligned_starts(shards):
    n = 1_000_003
    bounds = Z.shard_bounds(n, shards)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a % 128 == 0 and a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    # the reference's slab: rows of 128 padded to a multiple of R, rows / R per rank
    rows = JZ._to_slab(jnp.zeros(n, jnp.float32), shards).shape[0]
    assert all(b - a == rows // shards * 128 for a, b in bounds[:-1])
    assert bounds[-1][1] - bounds[-1][0] <= rows // shards * 128


def test_shard_bounds_refuse_an_empty_shard():
    with pytest.raises(ValueError, match="too few"):
        Z.shard_bounds(300, 4)


# ---------------------------------------------------------------------------
# The global step's pieces over 2 or 4 ranks
# ---------------------------------------------------------------------------

def _case(n_workers, dtype, weighted, sign_mode="sign", seed=0):
    rng = np.random.default_rng([n_workers, weighted, len(dtype), len(sign_mode)])
    x0 = rng.standard_normal(N).astype(np.float32)
    params = (x0[None] - 0.003 * rng.standard_normal((n_workers, N))).astype(np.float32)
    weights = None
    if weighted:            # worker 1 dropped and NaN: masked before the product
        params[1, 17] = np.nan
        weights = np.ones(n_workers, np.float32)
        weights[1] = 0.0
    return {"params": params, "x0": x0, "m": rng.standard_normal(N).astype(np.float32),
            "dtype": dtype, "weights": weights, "gamma": GAMMA,
            "cfg": dict(CFG, sign_mode=sign_mode), "seed": seed}


KINDS = [("float32", False, "sign"), ("float32", True, "sign"), ("bfloat16", False, "sign"),
         ("bfloat16", True, "sign"), ("float32", False, "rand_pm"),
         ("bfloat16", True, "rand_zero")]


@pytest.fixture(scope="module")
def ranks_run(tmp_path_factory):
    """Every KINDS case on every grid: one run of R processes per grid."""
    out = {}
    for n_workers, world in GRIDS:
        cases = [_case(n_workers, *k) for k in KINDS]
        res = spawn.run_ranks(torch_ranks.global_step_rank, world, (cases,), timeout_s=120,
                              group_timeout_s=60, work_dir=str(tmp_path_factory.mktemp("r")))
        out[(n_workers, world)] = (cases, res)
    return out


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _dense_mean(c):
    p = torch.from_numpy(c["params"]).to(getattr(torch, c["dtype"]))
    if c["weights"] is None:
        return D.worker_mean(p)
    return D.masked_worker_mean(p, torch.from_numpy(c["weights"]))


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"W{g[0]}-R{g[1]}")
@pytest.mark.parametrize("kind", range(4), ids=lambda k: "-".join(map(str, KINDS[k][:2])))
def test_scattered_mean_is_the_dense_mean_bit_for_bit(ranks_run, grid, kind):
    """The ranks' shards, concatenated, and the replicated mean equal the
    reference's _scattered_worker_mean and the port's dense mean."""
    cases, res = ranks_run[grid]
    c = cases[kind]
    shards = [r[kind]["x_tau"] for r in res]
    assert [r[kind]["bounds"] for r in res] == Z.shard_bounds(N, grid[1])
    mesh1 = JMESH.host_training_mesh(c["params"].shape[0])
    theirs = JZ._scattered_worker_mean(
        {"a": _jax(c["params"], c["dtype"])}, mesh1,
        None if c["weights"] is None else jnp.asarray(c["weights"]))["a"]
    dense = _dense_mean(c)
    _bits_equal(_f32(torch.cat(shards)), theirs)
    _bits_equal(_f32(torch.cat(shards)), _f32(dense))
    for r in res:
        _bits_equal(_f32(r[kind]["x_tau_full"]), _f32(dense))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"W{g[0]}-R{g[1]}")
@pytest.mark.parametrize("kind", range(4), ids=lambda k: "-".join(map(str, KINDS[k][:2])))
def test_sharded_step_is_the_dense_step_bit_for_bit(ranks_run, grid, kind):
    """x0 / m after the sharded step (gathered) against the reference's
    sharded_global_sign_momentum_step(use_kernel=False) on its one-device
    mesh, and against the port's dense step."""
    cases, res = ranks_run[grid]
    c = cases[kind]
    mesh1 = JMESH.host_training_mesh(c["params"].shape[0])
    jx, jm = JZ.sharded_global_sign_momentum_step(
        {"a": _jax(c["x0"], c["dtype"])}, {"a": jnp.asarray(c["m"])},
        {"a": _jax(c["params"], c["dtype"])}, jnp.float32(GAMMA),
        JD.DSMConfig(use_kernel=False, **c["cfg"]), mesh1,
        weights=None if c["weights"] is None else jnp.asarray(c["weights"]))
    dt = getattr(torch, c["dtype"])
    x0, m = torch.tensor(c["x0"]).to(dt), torch.tensor(c["m"])     # copies: updated in place
    D.global_sign_momentum_step(x0, m, _dense_mean(c), GAMMA, D.DSMConfig(**c["cfg"]))
    for r in res:
        _bits_equal(_f32(r[kind]["x0"]), jx["a"])
        _bits_equal(r[kind]["m"].numpy(), jm["a"])
        _bits_equal(_f32(r[kind]["x0"]), _f32(x0))
        _bits_equal(r[kind]["m"].numpy(), m.numpy())


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"W{g[0]}-R{g[1]}")
@pytest.mark.parametrize("kind", [4, 5], ids=lambda k: "-".join(map(str, KINDS[k][::2])))
def test_randomized_sharded_step_draws_the_dense_uniforms(ranks_run, grid, kind):
    """Each rank draws the full (N,) uniforms from the run's seed and takes
    its slice: bit-equal to the dense step from a generator of that seed."""
    cases, res = ranks_run[grid]
    c = cases[kind]
    dt = getattr(torch, c["dtype"])
    x0, m = torch.tensor(c["x0"]).to(dt), torch.tensor(c["m"])     # copies: updated in place
    D.global_sign_momentum_step(x0, m, _dense_mean(c), GAMMA, D.DSMConfig(**c["cfg"]),
                                rng=torch.Generator().manual_seed(c["seed"]))
    for r in res:
        _bits_equal(_f32(r[kind]["x0"]), _f32(x0))
        _bits_equal(r[kind]["m"].numpy(), m.numpy())


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"W{g[0]}-R{g[1]}")
@pytest.mark.parametrize("kind", range(4), ids=lambda k: "-".join(map(str, KINDS[k][:2])))
def test_sharded_stat_sums_match_tree_stat_sums(ranks_run, grid, kind):
    """One all-reduce of the per-shard sums: within 1e-6 relative of the
    reference's sums over the whole buffers (another summation order); the
    sign-agreement count is exact.  Every rank holds the same vector."""
    cases, res = ranks_run[grid]
    c = cases[kind]
    x_tau = _dense_mean(c)
    theirs = np.asarray(JM.tree_stat_sums(
        {"a": _jax(c["x0"], c["dtype"])}, {"a": jnp.asarray(c["m"])},
        {"a": _jax(_f32(x_tau), c["dtype"])},
        jnp.float32(GAMMA), 0.95))
    for r in res:
        ours = r[kind]["stat"].numpy()
        np.testing.assert_allclose(ours, theirs, rtol=1e-6)
        assert ours[3] == theirs[3]
        np.testing.assert_array_equal(ours, res[0][kind]["stat"].numpy())


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"W{g[0]}-R{g[1]}")
def test_collectives_gather_in_worker_order(tmp_path, grid):
    n_workers, world = grid
    res = spawn.run_ranks(torch_ranks.collectives_rank, world, (n_workers,), timeout_s=60,
                          group_timeout_s=60, work_dir=str(tmp_path))
    worker, zero = mesh.grid(n_workers, world)
    want = torch.tensor([[10.0 * w + k for w in range(worker)] for k in range(3)])
    for r, out in enumerate(res):
        assert torch.equal(out["losses"], want)
        assert out["sum"].item() == world * (world + 1) / 2 and out["min"].item() == 1
        assert out["grid"] == (worker, zero, r // zero, r % zero, r // zero, r // zero + 1)
        assert set(out["stats"]) == {"all_reduce_sum", "all_reduce_min", "gather_to_root",
                                     "gather_workers"}
        assert out["stats"]["gather_workers"]["bytes"] == 3 * 4
        # untimed by default: no seconds, so no device syncs around the calls
        assert all("seconds" not in v for v in out["stats"].values())
    assert torch.equal(res[0]["root"], torch.arange(world, dtype=torch.bfloat16)[:, None]
                       .expand(world, 2))
    assert all(out["root"] is None for out in res[1:])


def test_zero_and_device_parallel_options_are_ported():
    """The two options construct, and the device-parallel local phase needs
    a topology, as the reference's needs a mesh with a 'worker' axis."""
    from repro_torch.core.base_opt import adamw
    from repro_torch.core.schedules import constant
    from repro_torch.configs.nano import NANO
    from repro_torch.models import transformer as T

    for cfg in (D.DSMConfig(zero_sharded=True), D.DSMConfig(device_parallel_local=True)):
        assert D.make_dsm_step(None, adamw(), cfg, constant(1e-3), T.layout(NANO),
                               mesh.topology(4)) is not None
    with pytest.raises(ValueError, match="worker"):
        D.make_dsm_step(None, adamw(), D.DSMConfig(device_parallel_local=True), constant(1e-3),
                        T.layout(NANO))
    with pytest.raises(ValueError, match="worker"):
        JD.make_local_phase(lambda p, b: 0.0, jsgd(), device_parallel=True, mesh=None)


def test_metric_pack_over_ranks_matches_the_dense_pack(tmp_path):
    """Three outer steps (a dense round, a faulted one, one with every worker
    dropped) on four ZeRO ranks: the pack's loss slots, gamma and
    survivor_frac equal the dense pack exactly; the slots built from the
    all-reduced stat sums agree within 1e-6 relative (another summation
    order), the sign-agreement fraction exactly."""
    from repro_torch.obs.metrics import IDX

    w = 4
    rounds = [None, ([True, False, True, True], [False, False, True, False],
                     [False, False, False, True]), ([False] * w, [False] * w, [False] * w)]
    flags = dict(zero_sharded=True, device_parallel_local=True)
    ranks = spawn.run_ranks(torch_ranks.outer_steps_rank, 4, (w, flags, rounds), timeout_s=60,
                            group_timeout_s=60, work_dir=str(tmp_path))
    dense = torch_ranks.outer_steps_rank(0, 0, w, {}, rounds)
    exact = ["loss", "last_loss", "gamma", "worker_spread", "survivor_frac", "guard_ok",
             "sign_agree"]
    for packs in ranks:
        for ours, theirs in zip(packs, dense):
            for name in exact:
                assert ours[IDX[name]].item() == theirs[IDX[name]].item(), name
            np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=1e-6)
    assert [p[IDX["survivor_frac"]].item() for p in dense] == [1.0, 0.5, 0.0]
