"""The randomized signs of DSM (paper §3.1, eqs. 9/10) on the model axis and
under FSDP, on gloo ranks on the CPU (``tests/torch_ranks.py``), all f32 at
SMOKE widths, held against the port's dense step.

Grids ``(worker, zero, model)``: minitron_4b over (2, 1, 2) and (1, 1, 4);
gemma3_1b with ``attn_seq_shard`` and the reference's ``TOPO.attn_tp =
False`` (wq / wk / wv / wo whole on every model rank) over (2, 1, 2) and
(1, 1, 4); minitron_4b over (1, 1, 3), where its heads and most leaves do
not divide; minitron_4b under FSDP over (2, 2, 1) (B_micro 2: the rows split
over zero) and (1, 2, 2) (W = 1); granite_moe_3b_a800m with bf16 params
(two dtype groups: the f32 routers apart) over (2, 1, 2).  Each grid runs one DSM round (AdamW, tau
2, gamma 1e-3, eta 0.5) with ``rand_pm`` and the ZeRO-sharded global step,
and with ``rand_zero`` and the replicated one; every rank seeds its
generator alike.

  * **Bit equality.** A rank's x0 and m after the round are, at each of its
    elements, the dense step's bit for bit: the dense step
    (``global_sign_momentum_step`` on the whole ``(N,)`` buffers, drawing
    from a generator seeded alike) from x0 and m before the round and the
    dense x_tau that holds the rank's own x_tau at its elements (the other
    ranks' elsewhere).  Every copy of a leaf held whole on several ranks is
    the same bits on every rank.
  * **Not vacuous.** Over 10% of a rank's x0 differs from the deterministic
    step's from the same x_tau.
  * **Collectives.** Each rank's ``CommStats`` equals
    ``tensor_parallel.round_collectives`` to the byte.

``test_torch_algorithms_ranks_baselines.py`` holds the five local-step
baselines on the same grids against the JAX package's builders.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import load_arch
from repro_torch.core import dsm as D
from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.spawn import run_ranks
from repro_torch.groups import each, parts
from repro_torch.launch.dryrun import ATTN_NAMES
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

B, S, TAU, GAMMA, ETA = 2, 32, 2, 1e-3, 0.5
SEED = 23
# grid name -> (arch, fields replaced, leaves held whole, W, world, model, fsdp)
GRIDS = {
    "minitron-2x1x2": ("minitron_4b", {}, (), 2, 4, 2, False),
    "minitron-1x1x4": ("minitron_4b", {}, (), 2, 4, 4, False),
    "gemma3-sp-attn_whole-2x1x2": ("gemma3_1b", {"attn_seq_shard": True}, ATTN_NAMES, 2, 4, 2,
                                   False),
    "gemma3-sp-attn_whole-1x1x4": ("gemma3_1b", {"attn_seq_shard": True}, ATTN_NAMES, 2, 4, 4,
                                   False),
    "minitron-fsdp-2x2x1": ("minitron_4b", {}, (), 2, 4, 1, True),
    "minitron-fsdp-1x2x2": ("minitron_4b", {}, (), 1, 4, 2, True),
    "minitron-1x1x3": ("minitron_4b", {}, (), 2, 3, 3, False),
    # two dtype groups: the bf16 params and the f32 routers
    "granite_moe-bf16-2x1x2": ("granite_moe_3b_a800m", {"param_dtype": "bfloat16"}, (), 2, 4,
                               2, False),
}
MODES = {"rand_pm": {"zero_sharded": True}, "rand_zero": {"zero_sharded": False}}
CASES = [(g, m) for g in GRIDS for m in MODES]


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    TR.set_matmul_precision()


def grid_config(grid: str):
    arch, fields = GRIDS[grid][:2]
    return dataclasses.replace(load_arch(arch).SMOKE, **fields)


def grid_batches(grid: str, seed: int = 5) -> list:
    """One round's batch dict of the grid's W workers (numpy leaves)."""
    cfg, W = grid_config(grid), GRIDS[grid][3]
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (W, TAU, 1, B, S)).astype(np.int64)}]


def grid_row(grid: str) -> torch.Tensor:
    return T.init_params(torch.Generator().manual_seed(0), grid_config(grid))


def grid_case(grid: str, **run) -> dict:
    """An ``algorithms_rank`` case of the grid: ``run`` adds ``flags`` and
    ``seed`` (DSM) or ``method`` and ``kw`` (a baseline), and may replace
    the init ``row``."""
    _, _, rep, W, _, model, fsdp = GRIDS[grid]
    return {**dict(cfg=grid_config(grid), n_workers=W, model=model, fsdp=fsdp, replicate=rep,
                   row=grid_row(grid), batches=grid_batches(grid), gamma=GAMMA), **run}


def run_grids(make_case) -> dict:
    """``{(grid, key): each rank's result}`` of ``make_case(grid) -> {key:
    case}``: one start of the ranks per world size."""
    out = {}
    for world in sorted({g[4] for g in GRIDS.values()}):
        keys, cases = [], []
        for grid in (g for g, spec in GRIDS.items() if spec[4] == world):
            for key, case in make_case(grid).items():
                keys.append((grid, key))
                cases.append(case)
        if not cases:
            continue
        res = run_ranks(torch_ranks.algorithms_rank, world, (cases,), timeout_s=600)
        out.update({k: [r[i] for r in res] for i, k in enumerate(keys)})
    return out


def rank_layout(grid: str, r: dict):
    """The layout of rank ``r`` (its model and zero indices) of the grid."""
    _, _, rep, W, world, model, fsdp = GRIDS[grid]
    zero = MESH.grid(W, world, model)[1] if fsdp else 1
    return TP.rank_layout(grid_config(grid), model, r["index"], replicate_names=rep,
                          zero=zero, zero_index=r["zero_index"] if fsdp else 0)


def expected_round(grid: str, r: dict, dsm: bool, zero_sharded: bool = True) -> dict:
    """``tensor_parallel.round_collectives`` of rank ``r``'s one round."""
    _, _, _, W, world, model, _ = GRIDS[grid]
    worker, zero = MESH.grid(W, world, model)
    return TP.round_collectives(grid_config(grid), rank_layout(grid, r), W, worker, zero, TAU,
                                B, S, zero_sharded=zero_sharded, dsm=dsm)


@pytest.fixture(scope="module")
def rand_runs() -> dict:
    return run_grids(lambda grid: {
        mode: grid_case(grid, flags=dict(MODES[mode], sign_mode=mode, device_parallel_local=True),
                        seed=SEED)
        for mode in MODES})


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bits of an f32 or bf16 tensor, widened to int32."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16).int()


@pytest.mark.parametrize("grid,mode", CASES, ids=[f"{g}-{m}" for g, m in CASES])
def test_randomized_step_over_ranks_is_the_dense_step(rand_runs, grid, mode):
    ranks = rand_runs[(grid, mode)]
    cfg = grid_config(grid)
    lay = T.layout(cfg)
    lays = [rank_layout(grid, r) for r in ranks]
    row = grid_row(grid)
    dcfg = D.DSMConfig(tau=TAU, global_lr=ETA, sign_mode=mode)
    x_tau = convert.gather_flat([r["x_tau"][0] for r in ranks], lay, lays)
    # per group, the bits every rank holds at each dense element (-1: none
    # yet; a NaN pattern, which no x0 holds)
    copies = [torch.full((n,), -1, dtype=torch.int32) for n in lay.group_numels]
    for r, rl in zip(ranks, lays):
        where = rl.dense_index()
        assert [n for n, _ in where] == list(lay.group_numels)
        idx = [w.long() for _, w in where]
        assert [i.numel() for i in idx] == list(rl.group_numels)
        # the dense step from the dense x_tau holding this rank's own
        xt = each(torch.clone, x_tau)
        for t, i, mine in zip(parts(xt), idx, parts(r["x_tau"][0])):
            t[i] = mine
        x0 = each(torch.clone, row)
        m = each(lambda t: torch.zeros_like(t, dtype=torch.float32), row)
        D.global_sign_momentum_step(x0, m, xt, GAMMA, dcfg, torch.Generator().manual_seed(SEED))
        # the deterministic step from the same x_tau
        xs = each(torch.clone, row)
        D.global_sign_momentum_step(xs, each(torch.zeros_like, m), xt, GAMMA,
                                    D.DSMConfig(tau=TAU, global_lr=ETA))
        for g, i in enumerate(idx):
            ours_x, ours_m = parts(r["x0"][0])[g], parts(r["m"][0])[g]
            assert torch.equal(_bits(ours_x), _bits(parts(x0)[g][i])), (r["rank"], g, "x0")
            assert torch.equal(_bits(ours_m), _bits(parts(m)[g][i])), (r["rank"], g, "m")
            # every copy of an element on every rank is the same bits
            held = copies[g][i]
            assert torch.equal(torch.where(held == -1, _bits(ours_x), held), _bits(ours_x))
            copies[g][i] = _bits(ours_x)
        # the draws are not vacuous: the deterministic step moves otherwise
        x0_rank = parts(x0)[0][idx[0]]
        assert float((parts(xs)[0][idx[0]] != x0_rank).float().mean()) > 0.1
        assert r["comm"] == expected_round(grid, r, True, MODES[mode]["zero_sharded"]), r["rank"]


def test_layout_map_is_the_blocks_and_the_shards():
    """``FlatLayout.dense_index`` takes what ``convert.shard_flat`` cuts,
    and its chunks the worker peers' ZeRO shards of the rank's buffer; a
    dense layout maps to slices of the dense groups."""
    cfg = grid_config("gemma3-sp-attn_whole-1x1x4")
    dense = T.layout(cfg)
    row = T.init_params(torch.Generator().manual_seed(1), cfg)
    for m in range(4):
        rl = TP.rank_layout(cfg, 2, m % 2, replicate_names=ATTN_NAMES, zero=2,
                            zero_index=m // 2)
        ((n, where),) = rl.dense_index()
        assert n == dense.numel and where.dtype == torch.int32
        assert torch.equal(row[where.long()], convert.shard_flat(row, dense, rl))
        chunk = (5, 1000)
        ((_, part),) = rl.dense_index([chunk])
        assert torch.equal(part, where[chunk[0]:chunk[1]])
    assert dense.dense_index([(3, 9)]) == ((dense.numel, slice(3, 9)),)
    assert rl.dense() == dense


def test_draws_on_a_rank_are_the_dense_draw():
    """``core.dsm.layout_uniforms`` draws each group whole and takes the
    rank's elements: the draws at a rank's indices are the dense draw's."""
    cfg = grid_config("minitron-2x1x2")
    rl = TP.rank_layout(cfg, 2, 1)
    ((n, where),) = rl.dense_index()
    (ours,) = D.layout_uniforms(torch.Generator().manual_seed(3), rl.dense_index(), "cpu")
    whole = torch.rand((n,), generator=torch.Generator().manual_seed(3))
    assert torch.equal(ours, whole[where.long()])
    assert [u.numel() for u in parts(ours)] == [rl.numel]
