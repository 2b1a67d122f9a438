"""FSDP over ``zero`` (training) and ``data`` (serving) against the JAX
package and the port's own paths without it, on gloo ranks on the CPU
(``tests/torch_ranks.py``), all f32 at SMOKE widths.

  * **Against JAX.** On (worker 1, zero 2, model 1) and (worker 1, zero 2,
    model 2), one microbatch through ``core.dsm.worker_grads`` on each
    rank's zero blocks: the worker's loss (the mean of its zero ranks') and
    every leaf's gradient (the ranks' blocks put back together) against the
    JAX package's ``loss_fn`` and ``jax.grad`` on the whole microbatch, with
    ``test_model_axis_loss_and_grads_match_jax``'s tolerances: loss rtol
    1e-6, each gradient leaf within 3e-5 of its largest magnitude.  nano,
    minitron_4b (GQA), deepseek_67b (untied head), gemma3_1b (``swa``),
    granite_moe (its MoE layers' leaves gathered over zero per layer, its
    aux loss over the whole microbatch) and llava (``patch_proj`` gathered
    over zero, column-parallel over model) with ``B_micro`` = 2 on zero,
    nano with the batch whole over zero (1 row), minitron_4b and
    granite_moe under remat, and the recurrent and encoder-decoder families
    (mamba2, recurrentgemma, whisper; each layer's leaves gathered over zero
    inside the layer, mamba2 under remat too).  Each rank's
    ``CommStats`` equals ``tensor_parallel.microbatch_collectives``' to the
    byte, per group.
  * **The DSM step** (AdamW, tau 2, gamma 1e-3, eta 0.5, ZeRO-sharded
    global step, device-parallel local phase, two rounds) of minitron_4b
    with W = 2 over (worker 2, zero 2, model 1) on 4 ranks and (2, 2, 2) on
    8: x_tau, x0 and m against the dense run within the bounds of
    ``test_dsm_step_over_worker_and_model_ranks``, carried to the second
    round (:func:`round_bounds`); the global step from the dense x_tau, x0
    and m, cut to each rank's zero block, is the dense step's bit for bit;
    ``CommStats`` per group is the reckoning's to the byte.
  * **Exact where the rows are whole.** With ``B_micro`` = 1 (the batch
    whole over zero, the ``"slice"`` backward) the FSDP run's losses, x_tau,
    x0 and m are the same grid's without FSDP (PR 23's path) bit for bit.
  * **Faults.** A NaN in one zero rank's block of a worker masks that
    worker on every rank.
  * **Serving** over (data 2, model 2) with the data entries cut: prefill
    and decode logits and greedy tokens bit-equal to the replicated-data
    run; ``CommStats`` per group (``@data`` too) ``serve_collectives``'.
  * **The placements**: for every arch id and each pod mesh, the zero dims
    of a rank's layout are the reference's ``param_pspecs(...,
    worker_axis=True)``'s less the worker dim, for the params and for the
    base state; the serving layout's data dims the serving placement's.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_arch as j_load_arch
from repro.configs import specs as JSPECS
from repro.core import base_opt as JBO
from repro.core import dsm as JD
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, load_arch
from repro_torch.core import dsm as D
from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed import zero as Z
from repro_torch.distributed.comm import scaled_sum
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch import dryrun as DR
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR
from test_torch_tensor_parallel import _adam_bound, _batch, _configs, _torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

S = 32
ZERO = 2
# (arch, model ranks, B_micro, remat)
GRAD_CASES = [(a, m, 2, False) for m in (1, 2) for a in ("nano", "minitron_4b", "deepseek_67b",
                                                          "gemma3_1b", "granite_moe_3b_a800m",
                                                          "llava_next_34b")]
GRAD_CASES += [("nano", m, 1, False) for m in (1, 2)] + [("minitron_4b", 2, 2, True),
                                                         ("granite_moe_3b_a800m", 2, 2, True)]
# the recurrent and encoder-decoder families, each layer's leaves gathered
# over zero inside the layer
GRAD_CASES += [(a, m, 2, False) for m in (1, 2) for a in ("mamba2_780m", "recurrentgemma_2b",
                                                          "whisper_large_v3")]
GRAD_CASES += [("mamba2_780m", 2, 2, True)]
TAU, GAMMA, ETA, ROUNDS, W = 2, 1e-3, 0.5, 2, 2
ZERO_FLAGS = {"zero_sharded": True, "device_parallel_local": True}


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    TR.set_matmul_precision()


def rank_layouts(cfg, model: int, ranks: list, zero: int = ZERO) -> list:
    """Each rank's layout by its ``(index, zero_index)`` (model, zero)."""
    return [TP.rank_layout(cfg, model, r["index"], zero=zero, zero_index=r["zero_index"])
            for r in ranks]


# ---------------------------------------------------------------------------
# One microbatch against jax.grad
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grads_runs() -> dict:
    """``{case: (jax loss, jax grads, cfg, each rank's result)}``: one start
    of the ranks per grid."""
    ref = {}
    for arch, b in sorted({(a, b) for a, _, b, _ in GRAD_CASES}):
        jcfg, cfg = _configs(arch)
        jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
        batch = _batch(cfg, 1, (b,), S)
        jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, jb=batch, jc=jcfg: JT.loss_fn(
            p, {k: jnp.asarray(v) for k, v in jb.items()}, jc, remat=False)))(jp)
        row = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
        ref[(arch, b)] = (float(jloss), dict(convert.flatten_tree(
            jax.tree.map(np.asarray, jgrads), is_leaf=lambda x: isinstance(x, np.ndarray))),
            cfg, row, _torch(batch))
    out = {}
    for M in (1, 2):
        cases = [c for c in GRAD_CASES if c[1] == M]
        args = [(ref[(a, b)][2], ref[(a, b)][3], ref[(a, b)][4], remat) for a, _, b, remat in cases]
        res = run_ranks(torch_ranks.fsdp_grads_rank, ZERO * M, (M, args), timeout_s=300)
        out.update({c: ref[(c[0], c[2])][:3] + ([r[i] for r in res],)
                    for i, c in enumerate(cases)})
    return out


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[f"{a}-model{m}-b{b}{'-remat' if r else ''}"
                              for a, m, b, r in GRAD_CASES])
def test_fsdp_loss_and_grads_match_jax(grads_runs, case):
    arch, M, b, remat = case
    jloss, theirs, cfg, ranks = grads_runs[case]
    for r in ranks:
        r["index"] = r["model_index"]
    lay = T.layout(cfg)
    lays = rank_layouts(cfg, M, ranks)
    split = TP.zero_split(lays[0], b)
    assert split == (b % ZERO == 0)
    by_model = {m: [r["loss"].item() for r in ranks if r["index"] == m] for m in range(M)}
    for losses in by_model.values():
        np.testing.assert_allclose(np.mean(losses), jloss, rtol=1e-6)
        if not split:
            assert len(set(losses)) == 1
    ours = convert.to_numpy(convert.gather_flat([r["grads"] for r in ranks], lay, lays), cfg)
    assert sorted(ours) == sorted(theirs)
    for name, g in theirs.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(ours[name], g, rtol=0, atol=3e-5 * scale, err_msg=name)
    for r, rl in zip(ranks, lays):
        assert r["comm"] == TP.microbatch_collectives(cfg, rl, b, S, remat), r["comm"]
    # the rank holds its zero block: about a Z-th of its model block
    assert lays[0].numel < 0.6 * TP.rank_layout(cfg, M, 0).numel
    if cfg.n_experts:
        # the MoE aux statistics; each layer's leaves gathered in the layer
        assert "all_reduce_sum@zero" in ranks[0]["comm"]
        n_leaves = sum(name.startswith("decoder.") for name in lay.names)
        assert ranks[0]["comm"]["all_gather@zero"]["calls"] >= n_leaves * cfg.n_layers // 2


# ---------------------------------------------------------------------------
# The DSM step over (worker 2, zero 2, model M)
# ---------------------------------------------------------------------------

def _step_batches(cfg, b_micro: int, seed: int) -> list:
    out = []
    for k in range(ROUNDS):
        b = _batch(cfg, seed + k, (W, TAU, 1, b_micro), S)
        b["tokens"] = b["tokens"].astype(np.int64)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def step_runs() -> dict:
    """``{M: (cfg, row, dense run, [FSDP B_micro 2, FSDP B_micro 1, no FSDP
    B_micro 1, FSDP with a NaN (M = 1)] per rank)}``: one start of 4 M ranks
    per grid."""
    cfg = load_arch("minitron_4b").SMOKE
    row = T.init_params(torch.Generator().manual_seed(0), cfg)
    split, whole = _step_batches(cfg, 2, 5), _step_batches(cfg, 1, 7)
    dense = torch_ranks.dsm_case(None, cfg, W, {}, row, split, GAMMA)
    out = {}
    for M in (1, 2):
        base = dict(cfg=cfg, n_workers=W, model=M, flags=ZERO_FLAGS, row=row, gamma=GAMMA)
        cases = [dict(base, fsdp=True, batches=split), dict(base, fsdp=True, batches=whole),
                 dict(base, fsdp=False, batches=whole)]
        if M == 1:
            # rank 1 is worker group 0's zero rank 1
            cases.append(dict(base, fsdp=True, batches=split[:1], nan_rank=1,
                              flags={**ZERO_FLAGS, "mask_nonfinite": True}))
        res = run_ranks(torch_ranks.fsdp_dsm_rank, 4 * M, (cases,), timeout_s=300)
        out[M] = (cfg, row, dense, [[r[i] for r in res] for i in range(len(cases))])
    return out


def round_bounds() -> list:
    """Per round, the largest gaps (absolute) of x_tau, x0 after the round
    and m against the dense run, from PR 23's one-round bounds carried on:
    x_tau's gap is x0's before the round plus 2 gamma B_t per local step
    (AdamW's direction moves by at most twice its bound where the two runs'
    gradients differ); x0's grows by eta gamma lam times itself plus 2 eta
    gamma (a flipped sign); m's by beta2 times itself plus (1 - beta2) /
    gamma times the x0 (before) and x_tau gaps."""
    cut = D.DSMConfig(tau=TAU, global_lr=ETA)
    x0, m, out = 0.0, 0.0, []
    for k in range(ROUNDS):
        xt = x0 + 2 * GAMMA * sum(_adam_bound(t) for t in range(k * TAU + 1, (k + 1) * TAU + 1))
        m = cut.beta2 * m + (1 - cut.beta2) * (x0 + xt) / GAMMA
        x0 = x0 * (1 + ETA * GAMMA * cut.weight_decay) + 2 * ETA * GAMMA
        out.append({"x_tau": xt, "x0": x0, "m": m})
    return out


@pytest.mark.parametrize("M", [1, 2])
def test_fsdp_dsm_step_against_dense(step_runs, M):
    cfg, row, dense, runs = step_runs[M]
    ranks = runs[0]
    lay = T.layout(cfg)
    lays = rank_layouts(cfg, M, ranks)
    cut = D.DSMConfig(tau=TAU, global_lr=ETA)
    for k, b in enumerate(round_bounds()):
        for r in ranks:
            np.testing.assert_allclose(r["losses"][k].item(), dense["losses"][k].item(),
                                       rtol=1e-5)
        got = {n: convert.gather_flat([r[n][k] for r in ranks], lay, lays)
               for n in ("x_tau", "x0", "m")}
        for n in ("x_tau", "x0", "m"):
            gap = float((got[n] - dense[n][k]).abs().max())
            assert gap <= b[n] + 1e-6 * float(dense[n][k].abs().max()), (k, n, gap, b[n])
        if k == 0:
            assert int(((got["x0"] - dense["x0"][0]).abs() > 0).sum()) <= lay.numel // 1000
        # the global step from the dense x_tau, x0 and m on each rank's zero block
        x0_before = row if k == 0 else dense["x0"][k - 1]
        m_before = torch.zeros_like(row) if k == 0 else dense["m"][k - 1]
        for rl in lays:
            x0b, mb = convert.shard_flat(x0_before, lay, rl), convert.shard_flat(m_before, lay, rl)
            D.global_sign_momentum_step(x0b, mb, convert.shard_flat(dense["x_tau"][k], lay, rl),
                                        GAMMA, cut)
            for ours, theirs in ((x0b, dense["x0"][k]), (mb, dense["m"][k])):
                want = convert.shard_flat(theirs, lay, rl)
                assert torch.equal(ours.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("M", [1, 2])
def test_fsdp_collectives_equal_the_reckoning(step_runs, M):
    """Per round: the local phase's (the zero group's gathers and
    reduce-scatters per layer and microbatch, the losses' all-reduce, the
    model group's), the stat sums' all-reduce over the model group, and PR
    23's four calls of the dp round, now over the worker peers (the stat
    sums' over the (worker, zero) ranks)."""
    cfg, _, _, runs = step_runs[M]
    ranks = runs[0]
    for r, rl in zip(ranks, rank_layouts(cfg, M, ranks)):
        (n,) = rl.group_numels
        chunk = Z.chunk_size(n, W)            # the worker peers' chunk
        dp = {"gather_workers": TAU * 1 * 4, "scatter_rows": 1 * W * chunk * 4,
              "all_reduce_sum": 7 * 4, "all_gather_shards": chunk * 4}
        glob = {k: {"calls": 1, "bytes": v} for k, v in dp.items()}
        if M > 1:
            glob["all_reduce_sum@model"] = {"calls": 1, "bytes": 7 * 4}
        local = TP.local_phase_collectives(cfg, rl, 1, TAU, 2, S)
        assert "all_reduce_sum@zero" in local and "reduce_scatter@zero" in local
        assert r["comm"] == scaled_sum((ROUNDS, local), (ROUNDS, glob))


@pytest.mark.parametrize("M", [1, 2])
def test_fsdp_whole_rows_bit_equal_to_no_fsdp(step_runs, M):
    """B_micro = 1 does not split over zero: every zero rank computes the
    whole microbatch on its gathered blocks and keeps its slice of the
    gradient, so the round is PR 23's, bit for bit."""
    cfg, _, _, runs = step_runs[M]
    fsdp, plain = runs[1], runs[2]
    lay = T.layout(cfg)
    f_lays = rank_layouts(cfg, M, fsdp)
    p_lays = [TP.rank_layout(cfg, M, r["index"]) for r in plain]
    for k in range(ROUNDS):
        assert {r["losses"][k].item() for r in fsdp} == {r["losses"][k].item() for r in plain}
        for n in ("x_tau", "x0", "m"):
            a = convert.gather_flat([r[n][k] for r in fsdp], lay, f_lays)
            b = convert.gather_flat([r[n][k] for r in plain if r["zero_index"] == 0], lay,
                                    [rl for rl, r in zip(p_lays, plain) if r["zero_index"] == 0])
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (k, n)
    assert all("reduce_scatter@zero" not in r["comm"] for r in fsdp)


def test_fsdp_nan_in_one_zero_block_masks_the_worker_everywhere(step_runs):
    """A NaN set in zero rank 1's block of worker 0 (after its local phase):
    the worker's mask is the minimum over its zero group, so every rank
    masks worker 0 alone, and x0 stays finite."""
    ranks = step_runs[1][3][3]
    assert [r["survivors"][0].item() for r in ranks] == [W - 1] * len(ranks)
    assert all(bool(torch.isfinite(r["x0"][0]).all()) for r in ranks)
    assert all(r["comm"]["all_reduce_min@zero"]["calls"] == 1 for r in ranks)


# ---------------------------------------------------------------------------
# Serving over (data 2, model 2) with the data entries cut
# ---------------------------------------------------------------------------

SERVE_ARCHS = ("nano", "minitron_4b")
SB, S_PROMPT, N_DEC, NEW = 4, 19, 2, 3


@pytest.fixture(scope="module")
def served() -> dict:
    """``{(arch, fsdp): [each rank's serve_rank result]}``, one start of 4
    ranks."""
    keys, cases = [], []
    for arch in SERVE_ARCHS:
        cfg = _configs(arch)[1]
        row = T.init_params(torch.Generator().manual_seed(4), cfg)
        rng = np.random.default_rng(5)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (SB, S_PROMPT)))}
        dec = torch.from_numpy(rng.integers(0, cfg.vocab_size, (N_DEC, SB)))
        for fsdp in (False, True):
            keys.append((arch, fsdp))
            cases.append({"cfg": cfg, "model": 2, "row": row, "batch": batch, "dec_tokens": dec,
                          "new": NEW, "temperature": 0.0, "fsdp": fsdp})
    res = run_ranks(torch_ranks.serve_rank, 4, (cases,), timeout_s=300)
    return {k: [r[i] for r in res] for i, k in enumerate(keys)}


def _same(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32) if a.is_floating_point()
                                              else a, b.view(torch.int32)
                                              if b.is_floating_point() else b)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_fsdp_serving_bit_equal_to_replicated_data(served, arch):
    cfg = _configs(arch)[1]
    for ours, theirs in zip(served[(arch, True)], served[(arch, False)]):
        assert _same(ours["prefill"]["logits"], theirs["prefill"]["logits"])
        for a, b in zip(ours["decode"]["logits"], theirs["decode"]["logits"], strict=True):
            assert _same(a, b)
        assert torch.equal(ours["generate"]["tokens"], theirs["generate"]["tokens"])
        # the collectives: serve_collectives on the rank's FSDP layout
        lay = TP.rank_layout(cfg, 2, ours["model_index"], zero=2,
                             zero_index=ours["data_index"], zero_axes=("data",))
        b = ours["rows"][1] - ours["rows"][0]
        resolve, prefill, decode, pick = (TP.serve_collectives(cfg, lay, b, S_PROMPT, k)
                                          for k in ("serving_params", "prefill", "decode",
                                                    "pick"))
        assert ours["prefill"]["comm"] == scaled_sum((1, resolve), (1, prefill))
        assert ours["decode"]["comm"] == scaled_sum((N_DEC, decode))
        gathered = {"all_gather@data": {"calls": 1, "bytes": b * NEW * 8}}
        assert ours["generate"]["comm"] == scaled_sum((1, resolve), (1, prefill),
                                                      (NEW - 1, decode), (NEW, pick),
                                                      (1, gathered))
        assert decode["all_gather@data"]["calls"] > 0
        assert lay.numel < TP.rank_layout(cfg, 2, 0).numel


# ---------------------------------------------------------------------------
# The placements, every arch id
# ---------------------------------------------------------------------------

def _zero_dims_of(specs: dict, axis: str, lead: int) -> dict:
    """``{dotted path: its dim on axis, less lead}`` of a reference
    PartitionSpec tree."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        name = ".".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)
        d = next((i for i, e in enumerate(spec) if e == axis
                  or (isinstance(e, tuple) and axis in e)), None)
        out[name] = None if d is None else d - lead
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_placements_are_the_references(arch):
    """For each pod mesh: the rank layout's zero dims are the reference's
    ``param_pspecs(state.params, model=16, zero=Z, worker_axis=True)``'s
    less the worker dim, and so are its base state's (each moment's);
    the serving layout's data dims are ``param_pspecs(params, model=16,
    zero=D, zero_axes=("data",))``'s."""
    mod = j_load_arch(arch)
    jcfg, jtopo = mod.FULL, mod.TOPO
    cfg = load_arch(arch).FULL
    rep = () if jtopo.attn_tp else DR.ATTN_NAMES
    aps = JSPECS.abstract_params(jcfg)
    base = JBO.get_base_optimizer(jtopo.base_opt)
    for multi in (False, True):
        W = jtopo.n_workers_multi if multi else jtopo.n_workers_single
        dims = MESH.mesh_dims(MESH.training_mesh(MESH.make_production_mesh(multi_pod=multi), W))
        zero, model = dims["zero"], dims["model"]
        state = jax.eval_shape(lambda p: JD.dsm_init(p, base, W), aps)
        ours = dict(zip(T.layout(cfg).names, TP.rank_layout(
            cfg, model, 0, replicate_names=rep, zero=zero).zero_dims)) if zero > 1 else None
        want = _zero_dims_of(JSH.param_pspecs(state.params, model=model, zero=zero,
                                              worker_axis=True, replicate_names=rep), "zero", 1)
        if zero > 1:
            assert ours == want, (arch, multi)
        else:
            assert set(want.values()) == {None}
        moments = JSH.param_pspecs(state.base_state, model=model, zero=zero, worker_axis=True,
                                   replicate_names=rep)
        for key in ("m", "v"):
            if hasattr(moments, key):
                assert _zero_dims_of(getattr(moments, key), "zero", 1) == want, (arch, key)
        data = MESH.mesh_dims(MESH.serving_mesh(MESH.make_production_mesh(multi_pod=multi)))
        serve = _zero_dims_of(JSH.param_pspecs(aps, model=model, zero=data["data"],
                                               zero_axes=("data",)), "data", 0)
        lay = TP.rank_layout(cfg, model, 0, zero=data["data"], zero_axes=("data",))
        assert dict(zip(lay.names, lay.zero_dims)) == serve, (arch, multi)
        assert lay.numel < TP.rank_layout(cfg, model, 0).numel
