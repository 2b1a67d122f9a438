"""x0 and m over ``("zero",)`` only under FSDP: the reference dry-run's
``--no-zero-global-buffers`` placement, on gloo ranks on the CPU
(``tests/torch_ranks.py``), all f32 at SMOKE widths.

An FSDP rank (``mesh.topology(..., fsdp=True)``) holds its zero block of
its workers' params and base state.  By default its x0 and m are its chunk
of that block over its worker peers (the reference's ``(worker, zero)``);
with ``DSMConfig.zero_sharded`` off every worker peer holds the whole zero
block, the worker mean is the replicated one over the peers, the stat sums
add over the zero group and the model group, the DSM kernel runs on the
whole block and nothing is gathered after it.

  * minitron_4b SMOKE over (worker 2, zero 2, model 1) (B_micro 2 over
    zero) and (1, 2, 2), two DSM rounds (AdamW, tau 2, gamma 1e-3, eta 0.5,
    the device-parallel local phase) with ``sign`` and ``rand_pm``, each
    with and without ``zero_sharded``, in one start of 4 ranks: the losses,
    x_tau, x0, m and the workers' params after each round bit for bit those
    of the chunked placement; the worker peers' copies of x0 and m the same
    bits, each rank's x0 its whole zero block; each rank's collectives
    ``tensor_parallel.round_collectives(..., zero_sharded=False)`` to the
    byte; its state bytes ``dryrun.reckon_train(..., zero_global_buffers=
    False)``'s.
  * Faults over (2, 2, 1) (a stale worker, then a NaN-poisoned one): both
    rounds bit for bit the chunked placement's.
  * SlowMo on the same grids, two rounds: its global update on the whole
    zero block from the peers' replicated mean, the first round's mean the
    DSM run's bits, each round's x0 and momentum the update's on the block
    bit for bit, the peers' copies the same bits, the collectives a
    baseline round's reckoning.
  * ``dryrun.reckon_pod(..., zero_global_buffers=False)``: the reckoned
    rank's state bytes, to the byte, the reference's ``("zero",)`` placement
    of x0 and m (``repro.distributed.sharding.param_pspecs(x0, model=M,
    zero=Z, zero_axes=("zero",))``, as its dry-run's ``_state_shardings``
    calls it) beside its worker params and base state; ``--mesh single
    --no-zero-global-buffers`` writes train records that say so.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import load_arch as j_load_arch
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro_torch.configs import INPUT_SHAPES, load_arch, specs
from repro_torch.core import baselines as BL
from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.comm import scaled_sum
from repro_torch.distributed.spawn import run_ranks
from repro_torch.groups import parts
from repro_torch.launch import dryrun as DR
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

B, S, TAU, GAMMA, ETA, ROUNDS, SEED = 2, 32, 2, 1e-3, 0.5, 2, 23
WORLD = 4
# grid name -> (W, model); FSDP over the rows' zero ranks
GRIDS = {"2x2x1": (2, 1), "1x2x2": (1, 2)}
SIGNS = ("sign", "rand_pm")
SLOWMO = dict(beta=0.5, alpha=1.0)
# per round (survivors, stale, corrupt) of the W = 2 workers: worker 1
# stale (it delivers x0), then worker 0 NaN-poisoned (masked out)
FAULTS = [([True, True], [False, True], [False, False]),
          ([True, True], [False, False], [True, False])]
CASES = [(g, mode, sharded) for g in GRIDS for mode in SIGNS for sharded in (False, True)]
SIGN_CASES = [(g, mode) for g in GRIDS for mode in SIGNS]
SIGN_IDS = [f"{g}-{m}" for g, m in SIGN_CASES]


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    TR.set_matmul_precision()


def _cfg():
    return load_arch("minitron_4b").SMOKE


def _case(grid: str, **run) -> dict:
    W, model = GRIDS[grid]
    cfg = _cfg()
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (W, TAU, 1, B, S)).astype(np.int64)}
               for _ in range(ROUNDS)]
    return dict(cfg=cfg, n_workers=W, model=model, fsdp=True, replicate=(),
                row=T.init_params(torch.Generator().manual_seed(0), cfg), batches=batches,
                gamma=GAMMA, **run)


@pytest.fixture(scope="module")
def runs() -> dict:
    """``{(grid, mode, zero_sharded) or (grid, "slowmo"): each rank's
    result}``: one start of the 4 ranks for every case."""
    keys, cases = [], []
    for grid, mode, sharded in CASES:
        keys.append((grid, mode, sharded))
        cases.append(_case(grid, flags=dict(sign_mode=mode, zero_sharded=sharded,
                                            device_parallel_local=True), seed=SEED))
    for grid in GRIDS:
        keys.append((grid, "slowmo"))
        cases.append(_case(grid, method="slowmo", kw=SLOWMO))
    for sharded in (False, True):
        keys.append(("2x2x1", "faults", sharded))
        cases.append(_case("2x2x1", flags=dict(zero_sharded=sharded,
                                               device_parallel_local=True),
                           seed=None, faults=FAULTS))
    res = run_ranks(torch_ranks.algorithms_rank, WORLD, (cases,), timeout_s=600)
    return {k: [r[i] for r in res] for i, k in enumerate(keys)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _same(a, b) -> bool:
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(parts(a), parts(b), strict=True))


def _layout(grid: str, r: dict):
    W, model = GRIDS[grid]
    zero = MESH.grid(W, WORLD, model)[1]
    return TP.rank_layout(_cfg(), model, r["index"], zero=zero, zero_index=r["zero_index"])


def _peers(ranks: list) -> dict:
    """``{(zero index, model index): [the worker peers' results]}``."""
    out: dict = {}
    for r in ranks:
        out.setdefault((r["zero_index"], r["index"]), []).append(r)
    return out


@pytest.mark.parametrize("grid,mode", SIGN_CASES, ids=SIGN_IDS)
def test_zero_only_buffers_equal_the_chunked_placement(runs, grid, mode):
    """Every round's losses, x_tau, x0, m and params on every rank are the
    chunked placement's bits (x0 / m gathered over the peers there)."""
    ours, chunked = runs[(grid, mode, False)], runs[(grid, mode, True)]
    for a, b in zip(ours, chunked, strict=True):
        assert a["rank"] == b["rank"]
        for k in range(ROUNDS):
            assert torch.equal(a["losses"][k], b["losses"][k])
            for name in ("x_tau", "x0", "m", "params"):
                assert _same(a[name][k], b[name][k]), (a["rank"], k, name)


@pytest.mark.parametrize("grid,mode", SIGN_CASES, ids=SIGN_IDS)
def test_worker_peers_hold_the_same_whole_zero_block(runs, grid, mode):
    ranks = runs[(grid, mode, False)]
    W, model = GRIDS[grid]
    worker = MESH.grid(W, WORLD, model)[0]
    for group in _peers(ranks).values():
        assert len(group) == worker
        lay = _layout(grid, group[0])
        for r in group:
            assert [x.numel() for x in parts(r["x0"][-1])] == list(lay.group_numels)
            for k in range(ROUNDS):
                assert _same(r["x0"][k], group[0]["x0"][k]) and _same(r["m"][k],
                                                                      group[0]["m"][k])


@pytest.mark.parametrize("grid,mode", SIGN_CASES, ids=SIGN_IDS)
def test_zero_only_collectives_and_state_equal_the_reckoning(runs, grid, mode):
    """Each rank's collectives of the two rounds are ``round_collectives``'
    with ``zero_sharded`` off, to the byte: the scatter and the all-gather
    of the whole mean over the peers, the stat sums over the zero and the
    model groups, no all-gather of x_{t+1,0}; its state bytes are the dry-run's
    reckoning of the same rank."""
    W, model = GRIDS[grid]
    worker, zero = MESH.grid(W, WORLD, model)
    for r in runs[(grid, mode, False)]:
        one = TP.round_collectives(_cfg(), _layout(grid, r), W, worker, zero, TAU, B, S,
                                   zero_sharded=False)
        assert r["comm"] == scaled_sum((ROUNDS, one)), r["rank"]
        assert "all_reduce_sum" not in one and "all_reduce_sum@zero" in one
        if r["rank"] == 0:
            rec = DR.reckon_train(_cfg(), n_workers=W, tau=TAU, b_micro=B, seq=S, world=WORLD,
                                  model=model, fsdp=True, zero_global_buffers=False)
            assert r["state_bytes"] == rec["memory"]["state_bytes"]
            assert not rec["zero_global_buffers"]


def test_faults_read_the_whole_zero_block(runs):
    """A stale worker delivers the rank's whole zero block of x0
    (``apply_faults`` reads it whole) and a NaN-poisoned one is masked: both
    rounds bit for bit the chunked placement's, one survivor less in the
    second."""
    ours, chunked = runs[("2x2x1", "faults", False)], runs[("2x2x1", "faults", True)]
    for a, b in zip(ours, chunked, strict=True):
        for k in range(ROUNDS):
            assert torch.equal(a["survivors"][k], b["survivors"][k])
            for name in ("x_tau", "x0", "m", "params"):
                assert _same(a[name][k], b[name][k]), (a["rank"], k, name)
        assert [float(x) for x in a["survivors"]] == [2.0, 1.0]
        assert all(torch.isfinite(t).all() for t in parts(a["x0"][-1]))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_slowmo_updates_the_whole_zero_block(runs, grid):
    ranks = runs[(grid, "slowmo")]
    dsm = runs[(grid, "sign", False)]
    _, update = BL.slowmo_update(**SLOWMO)
    W, model = GRIDS[grid]
    worker, zero = MESH.grid(W, WORLD, model)
    row = T.init_params(torch.Generator().manual_seed(0), _cfg())
    for r, d in zip(ranks, dsm, strict=True):
        lay = _layout(grid, r)
        # the same local phase from the same draw: round 1's mean is DSM's
        assert _same(r["x_tau"][0], d["x_tau"][0])
        x0 = convert.shard_flat(row, T.layout(_cfg()), lay)
        u = torch.zeros_like(x0)
        for k in range(ROUNDS):
            update(x0, u, r["x_tau"][k], float(np.float32(GAMMA)), k)
            assert _same(r["x0"][k], x0) and _same(r["aux"][k][0], u), (r["rank"], k)
        one = TP.round_collectives(_cfg(), lay, W, worker, zero, TAU, B, S, dsm=False)
        assert r["comm"] == scaled_sum((ROUNDS, one))
    for group in _peers(ranks).values():
        assert all(_same(r["x0"][-1], group[0]["x0"][-1]) for r in group)


# ---------------------------------------------------------------------------
# The dry-run: x0 and m over ("zero",) on the pod meshes
# ---------------------------------------------------------------------------

def _reference_elements(shapes, specs_tree, sizes: dict) -> int:
    """Elements per rank of a tree of leaves under the reference's pspecs."""
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)),
            strict=True):
        cut = 1
        for entry in spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                cut *= sizes.get(ax, 1)
        total += int(np.prod(leaf.shape)) // cut
    return total


@pytest.mark.parametrize("arch,multi", [("minitron_4b_smoke", False),
                                        ("granite_34b_smoke", True)])
def test_zero_only_state_bytes_are_the_reference_placement(arch, multi):
    """The reckoned rank's state under ``--no-zero-global-buffers``, to the
    byte: its worker params, gradients and AdamW moments under the
    reference's ``param_pspecs(..., zero=Z, worker_axis=True)`` per local
    worker, the kept initial x0, x0 and m under ``param_pspecs(x0,
    model=M, zero=Z, zero_axes=("zero",))``, and its round's tokens; the
    same state with x0 and m cut over the worker peers is smaller."""
    from repro_torch.launch.train import resolve_arch

    cfg, topo = resolve_arch(arch)
    jcfg = j_load_arch(arch.removesuffix("_smoke")).SMOKE
    W = topo.n_workers_multi if multi else topo.n_workers_single
    dims = MESH.mesh_dims(MESH.training_mesh(MESH.make_production_mesh(multi_pod=multi), W))
    rep = () if topo.attn_tp else DR.ATTN_NAMES
    x0 = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    x0_specs = JSH.param_pspecs(x0, model=dims["model"], zero=dims["zero"],
                                zero_axes=("zero",), replicate_names=rep)
    rows = jax.tree.map(lambda a: jax.ShapeDtypeStruct((W,) + a.shape, a.dtype), x0)
    w_specs = JSH.param_pspecs(rows, model=dims["model"], zero=dims["zero"], worker_axis=True,
                               replicate_names=rep)
    p = jax.tree.leaves(x0)[0].dtype.itemsize
    worker = _reference_elements(rows, w_specs, dims)
    block = _reference_elements(x0, x0_specs, dims)
    rec = DR.reckon_pod(arch, "train_4k", multi, zero_global_buffers=False)
    batch = specs.train_batch_specs(cfg, topo, INPUT_SHAPES["train_4k"], W)["tokens"]
    w_local = W // dims["worker"]
    tokens = w_local * int(np.prod(batch.shape[1:])) * 8
    want = (worker * (2 * p + 8)          # params and gradients, two f32 moments
            + block * p                   # the kept initial x0
            + block * (p + 4)             # x0 and m over ("zero",)
            + tokens)
    assert not rec["zero_global_buffers"] and rec["fsdp"]
    assert rec["memory"]["state_bytes"] == rec["state_bytes_per_rank"] == want
    chunked = DR.reckon_pod(arch, "train_4k", multi)
    assert chunked["zero_global_buffers"]
    assert chunked["memory"]["state_bytes"] < rec["memory"]["state_bytes"]


def test_dryrun_flag_writes_zero_only_train_records(tmp_path):
    """``--mesh single --no-zero-global-buffers`` reckons the train shapes
    with x0 and m over zero only (``zero_global_buffers`` false, no
    all-gather of x_{t+1,0}), the serving shapes as without it; on ``--mesh
    card`` the flag changes nothing."""
    argv = ["--arch", "gpt2_small_smoke", "--shape", "train_4k,decode_32k", "--outdir",
            str(tmp_path)]
    recs = DR.main(argv + ["--mesh", "single", "--no-zero-global-buffers"])
    train = next(r for r in recs if r["shape"] == "train_4k")
    assert train["status"] == "ok" and not train["zero_global_buffers"]
    saved = json.loads((tmp_path / "gpt2_small_smoke.train_4k.singlepod.json").read_text())
    assert saved["zero_global_buffers"] is False
    default = DR.reckon_pod("gpt2_small_smoke", "train_4k", False)
    assert default["zero_global_buffers"]
    # x0 and m whole over the (worker, zero) ranks: the mean gathered whole,
    # nothing gathered after the step
    assert train["comm"]["all_gather_shards"]["calls"] == 1
    assert default["comm"]["all_gather_shards"]["calls"] == 1
    assert "all_reduce_sum" not in train["comm"] and "all_reduce_sum" in default["comm"]
    decode = next(r for r in recs if r["shape"] == "decode_32k")
    assert decode == dict(DR.reckon_pod("gpt2_small_smoke", "decode_32k", False),
                          arch=decode["arch"], shape=decode["shape"], status="ok",
                          seconds=decode["seconds"])
    card = DR.main(["--arch", "gpt2_small_smoke", "--shape", "train_4k", "--outdir",
                    str(tmp_path), "--no-zero-global-buffers"])
    plain = DR.reckon("gpt2_small_smoke", "train_4k")
    assert {k: card[0][k] for k in ("memory", "flops")} == {k: plain[k] for k in ("memory",
                                                                                 "flops")}
    assert card[0]["zero_global_buffers"] is False
