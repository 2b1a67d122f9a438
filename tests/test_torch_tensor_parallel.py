"""The model axis against the JAX package and the port's dense path, on
gloo ranks on the CPU (``tests/torch_ranks.py``), all f32 at SMOKE widths.

  * On 2 and 4 model ranks, the model-axis ``loss_fn`` and its gradient
    (each rank's blocks gathered back to the dense leaves) are held against
    the JAX package's ``loss_fn`` and ``jax.grad`` on the same numpy params,
    with the tolerances of ``test_torch_model.py``: loss rtol 1e-6, each
    gradient leaf within 3e-5 of that leaf's largest magnitude.  The dense
    configs compute Megatron-split: nano (GPT-2 shape, tied), minitron_4b
    (GQA; at 4 ranks a rank's block of wk / wv cuts a head), granite_34b
    (MQA: the one KV head cut), deepseek_67b (untied ``lm_head``) and
    gemma3_1b (``swa``).  So do the MoE FFNs and the VLM: granite_moe (40
    experts cut to 4 at SMOKE, top-2: the router on E), llama4 (an
    ``attn:dense`` / ``attn:moe`` pattern, top-1, shared experts) and llava
    (``patch_proj`` column-parallel, the patch prefix gathered), and the
    variants built with ``dataclasses.replace`` on both sides
    (``VARIANTS``): the ``ksum`` combine, ``moe_impl="dense"`` and 6
    experts, which at 4 ranks put the router on d.  ``ssm``, ``rglru`` and
    ``encdec`` split too (``test_torch_tensor_parallel_families.py``, 2
    and 4 ranks).  Each rank's
    ``CommStats`` equals the count that ``tensor_parallel.
    microbatch_collectives`` reckons from the placements, layer by layer.
  * One DSM outer step (AdamW, tau 2, gamma 1e-3, eta 0.5, ZeRO-sharded
    global step, device-parallel local phase) of minitron_4b SMOKE over
    (worker 2, zero 1, model 2) against the port's dense step from the same
    params and batches.  From the dense x_tau, x0 and m, cut to each rank's
    blocks, the global step is the dense step's blocks bit for bit.  The
    local phase's x_tau is within the AdamW bound below of the dense one;
    x0 differs only where sign(u) flipped, by 2 * eta * gamma, at no more
    than N / 1000 coordinates (as ``test_torch_archs.py``), and m by
    (1 - beta2) times the x_tau gap over gamma.  The model group's
    collectives are ``microbatch_collectives`` per local step and worker
    plus the stat sums' all-reduce; the (worker, zero) ranks' are one round.

The AdamW bound: on step t the direction m_hat / (sqrt(v_hat) + eps) is at
most B_t = sqrt(sum_i w_i^2 / u_i) in magnitude (Cauchy-Schwarz over the
bias-corrected weights w_i of the first moment and u_i of the second), so
two runs whose gradients differ anywhere can differ by at most 2 * gamma *
B_t per step (plus gamma * wd times the gap, negligible at tau 2).
"""

import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.tables import NANO as J_NANO
from repro.configs import load_arch as j_load_arch
from repro.models import transformer as JT
from repro_torch.configs import load_arch
from repro_torch.configs.nano import NANO
from repro_torch.core import base_opt as BO
from repro_torch.core import baselines as BL
from repro_torch.core import dsm as D
from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.spawn import run_ranks
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

DENSE = ("nano", "minitron_4b", "granite_34b", "deepseek_67b", "gemma3_1b")
CASES = [(a, m) for m in (2, 4) for a in DENSE]
# the MoE FFNs and the VLM, and MoE variants: name -> (arch, replaced fields)
MOE_VLM = ("granite_moe_3b_a800m", "llama4_maverick_400b_a17b", "llava_next_34b")
VARIANTS = {"granite_moe_ksum": ("granite_moe_3b_a800m", {"moe_combine": "ksum"}),
            "granite_moe_dense": ("granite_moe_3b_a800m", {"moe_impl": "dense"}),
            "granite_moe_6e": ("granite_moe_3b_a800m", {"n_experts": 6}),
            "llama4_ksum": ("llama4_maverick_400b_a17b", {"moe_combine": "ksum"})}
SPLIT_CASES = [(a, m) for m in (2, 4) for a in MOE_VLM + tuple(VARIANTS)]
B, S = 2, 32
TAU, GAMMA, ETA = 2, 1e-3, 0.5


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    TR.set_matmul_precision()


def _configs(arch):
    if arch == "nano":
        return J_NANO, NANO
    if arch in VARIANTS:
        base, fields = VARIANTS[arch]
        return tuple(dataclasses.replace(c, **fields) for c in _configs(base))
    return j_load_arch(arch).SMOKE, load_arch(arch).SMOKE


def _batch(cfg, seed, lead, n_text):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, lead + (n_text,)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(lead + (cfg.n_patches, cfg.d_model),
                                               dtype=np.float32)
    elif cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(lead + (cfg.enc_len, cfg.d_model),
                                              dtype=np.float32)
    return batch


def _torch(batch: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def run_cases(cases: list) -> dict:
    """``{case: (jax loss, jax grads, cfg, rank results)}`` of ``(arch, M)``
    or ``(arch, M, remat)`` cases: one start of M ranks for all the cases at
    M (the JAX reference once per arch)."""
    out, ref = {}, {}
    for M in sorted({c[1] for c in cases}):
        group = [c for c in cases if c[1] == M]
        runs = []
        for case in group:
            arch = case[0]
            jcfg, cfg = _configs(arch)
            batch = _batch(cfg, 1, (B,), S)
            if arch not in ref:
                jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
                jloss, jgrads = jax.jit(jax.value_and_grad(
                    lambda p, jb=batch, jc=jcfg: JT.loss_fn(
                        p, {k: jnp.asarray(v) for k, v in jb.items()}, jc, remat=False)))(jp)
                row = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
                ref[arch] = (float(jloss), dict(convert.flatten_tree(
                    jax.tree.map(np.asarray, jgrads),
                    is_leaf=lambda x: isinstance(x, np.ndarray))), cfg, row)
            runs.append((cfg, ref[arch][3], [_torch(batch)]) + tuple(case[2:]))
        res = run_ranks(torch_ranks.tp_losses_rank, M, (runs,), timeout_s=300)
        out.update({c: ref[c[0]][:3] + ([r[i] for r in res],) for i, c in enumerate(group)})
    return out


def whole_gather_bytes(lay) -> int:
    """The bytes a rank of ``lay`` sends to gather every leaf once, layer by
    layer: the model gathered whole up front."""
    r = TP._Reckoning(lay)
    for name in lay.names:
        r.gather(name)
    return r.out["all_gather@model"]["bytes"]


def check_case(run: tuple, M: int, remat: bool = False, rel=lambda name: 3e-5) -> dict:
    """Loss and gathered gradients against the JAX package's (each leaf
    within ``rel(name)`` of its largest magnitude); ``CommStats`` against
    the placement's count.  Returns the gathered gradients by leaf."""
    jloss, theirs, cfg, ranks = run
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0].item(), jloss, rtol=1e-6)
    lay = T.layout(cfg)
    lays = [TP.rank_layout(cfg, M, m) for m in range(M)]
    assert [r["index"] for r in ranks] == list(range(M))
    grad = convert.gather_flat([r["grads"][0] for r in ranks], lay, lays)
    ours = convert.to_numpy(grad, cfg)
    assert sorted(ours) == sorted(theirs)
    for name, g in theirs.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(ours[name], g, rtol=0, atol=rel(name) * scale, err_msg=name)
    want = TP.microbatch_collectives(cfg, lays[0], B, S, remat)
    assert all(r["comm"] == want for r in ranks), (ranks[0]["comm"], want)
    return ours


@pytest.fixture(scope="module")
def model_axis_runs():
    return run_cases(CASES)


@pytest.mark.parametrize("arch,M", CASES, ids=[f"{a}-{m}ranks" for a, m in CASES])
def test_model_axis_loss_and_grads_match_jax(model_axis_runs, arch, M):
    check_case(model_axis_runs[(arch, M)], M)


@pytest.fixture(scope="module")
def split_runs():
    return run_cases(SPLIT_CASES)


@pytest.mark.parametrize("arch,M", SPLIT_CASES, ids=[f"{a}-{m}ranks" for a, m in SPLIT_CASES])
def test_moe_and_vlm_split_match_jax(split_runs, arch, M):
    check_case(split_runs[(arch, M)], M)
    cfg = split_runs[(arch, M)][2]
    # the rank's blocks: the router by experts (by rows where E / M is not
    # whole), every expert's d_ff slice, the patch projection's columns;
    # it gathers a fraction of what gathering every leaf would
    lay = TP.rank_layout(cfg, M, 0)
    comm = TP.microbatch_collectives(cfg, lay, B, S)
    assert comm["all_gather@model"]["bytes"] < 0.1 * whole_gather_bytes(lay)
    dims = TP.model_dims(cfg, M)
    if cfg.n_experts:
        pre = f"decoder.blocks.p{len(cfg.pattern) - 1}.moe."
        assert dims[pre + "router"] == (2 if cfg.n_experts % M == 0 else 1)
        assert dims[pre + "we1"] == 3 and dims[pre + "we2"] == 2
    else:
        assert dims["patch_proj"] == 1


def test_moe_and_vlm_never_gather_up_front(monkeypatch):
    """No config on a model rank gathers its leaves up front: the MoE and
    VLM configs, and the recurrent and encoder-decoder families, which did
    until the model axis split them.  ``transformer._gathered`` is gone,
    and ``serving_params`` replaces only the norm scales (gathered once and
    held whole)."""
    monkeypatch.setattr(TP, "gather", lambda t, *a, **k: t.clone())    # no group here
    assert not hasattr(T, "_gathered") and not hasattr(T, "_resolve")
    for arch in MOE_VLM + ("mamba2_780m", "recurrentgemma_2b", "whisper_large_v3"):
        cfg = load_arch(arch).SMOKE
        lay = TP.rank_layout(cfg, 2, 0)
        params = convert.ShardedParams(lay, lay.views(lay.empty()))
        out = T.serving_params(params, cfg)
        assert out.resolved
        replaced = {n for n in params if out[n] is not params[n]}
        assert replaced and all(n.endswith(T.NORM_SCALES) for n in replaced), (arch, replaced)


def test_a_split_config_splits():
    """minitron_4b SMOKE at 4 ranks: whole query heads, d_ff and vocab rows
    on each rank; wk / wv (2 KV heads of 32 over 4 ranks) cut a head, so
    they are gathered (their gradient reduce-scattered).  Serving a rank's
    params refuses only a head split that cuts KV groups (6 query heads on
    3 KV heads over 2 ranks), before it reads the batch; serving itself is
    held in ``test_torch_serve_model_axis.py``."""
    cfg = load_arch("minitron_4b").SMOKE
    comm = TP.microbatch_collectives(cfg, TP.rank_layout(cfg, 4, 0), B, S)
    assert comm["reduce_scatter@model"]["calls"] == 2 * cfg.n_layers
    assert "reduce_scatter@model" not in TP.microbatch_collectives(
        cfg, TP.rank_layout(cfg, 2, 0), B, S)
    cut = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3, name="kv_cut")
    with pytest.raises(NotImplementedError):
        T.prefill(convert.ShardedParams(TP.rank_layout(cut, 2, 0)), {}, cut)


def _adam_bound(t: int, b1: float = 0.9, b2: float = 0.95) -> float:
    """Largest |m_hat / sqrt(v_hat)| on AdamW step t (1-indexed)."""
    w = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    u = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return math.sqrt(sum(a * a / c for a, c in zip(w, u)))


def test_dsm_step_over_worker_and_model_ranks():
    arch = "minitron_4b"
    cfg = load_arch(arch).SMOKE
    W, M = 2, 2
    row = T.init_params(torch.Generator().manual_seed(0), cfg)
    batches = [_batch(cfg, 5, (W, TAU, 1, B), S)]
    for b in batches:
        b["tokens"] = b["tokens"].astype(np.int64)
    flags = {"zero_sharded": True, "device_parallel_local": True}
    dense = torch_ranks.tp_dsm_rank(0, 0, cfg, W, 1, {}, row, batches, GAMMA)
    ranks = run_ranks(torch_ranks.tp_dsm_rank, 4, (cfg, W, M, flags, row, batches, GAMMA),
                      timeout_s=300)
    lay = T.layout(cfg)
    lays = [TP.rank_layout(cfg, M, m) for m in range(M)]
    by_model = {r["index"]: r for r in ranks}
    assert sorted(by_model) == [0, 1]

    # the global step from the dense x_tau, x0 and m, cut to each rank's blocks
    cut = D.DSMConfig(tau=TAU, global_lr=ETA)
    for m, rl in enumerate(lays):
        x0 = convert.shard_flat(row, lay, rl)
        mom = torch.zeros_like(x0)
        D.global_sign_momentum_step(x0, mom, convert.shard_flat(dense["x_tau"][0], lay, rl),
                                    GAMMA, cut)
        assert torch.equal(x0.view(torch.int32),
                           convert.shard_flat(dense["x0"][0], lay, rl).view(torch.int32))
        assert torch.equal(mom.view(torch.int32),
                           convert.shard_flat(dense["m"][0], lay, rl).view(torch.int32))

    # the local phase and the step against the dense run
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0].item(), dense["losses"][0].item(), rtol=1e-5)
    x_tau = convert.gather_flat([by_model[m]["x_tau"][0] for m in range(M)], lay, lays)
    gap = (x_tau - dense["x_tau"][0]).abs()
    bound = 2 * GAMMA * sum(_adam_bound(t) for t in range(1, TAU + 1))
    assert float(gap.max()) <= bound + 1e-6 * float(dense["x_tau"][0].abs().max())
    x0 = convert.gather_flat([by_model[m]["x0"][0] for m in range(M)], lay, lays)
    moved = (x0 - dense["x0"][0]).abs()
    assert int((moved > 0).sum()) <= lay.numel // 1000
    assert float(moved.max()) <= 2 * ETA * GAMMA * (1 + 1e-5)
    m_ = convert.gather_flat([by_model[m]["m"][0] for m in range(M)], lay, lays)
    beta2 = cut.beta2
    want = (1 - beta2) * (dense["x_tau"][0] - x_tau) / GAMMA
    np.testing.assert_allclose((m_ - dense["m"][0]).numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(dense["m"][0].abs().max()))

    # the collectives: per local step and worker the placement's count, then
    # one stat all-reduce over the model group; one round over (worker, zero)
    micro = TP.microbatch_collectives(cfg, lays[0], B, S)
    for r in ranks:
        model_ops = {k: v for k, v in r["comm"].items() if k.endswith("@model")}
        want = {k: {"calls": v["calls"] * TAU, "bytes": v["bytes"] * TAU}
                for k, v in micro.items()}
        want["all_reduce_sum@model"]["calls"] += 1
        want["all_reduce_sum@model"]["bytes"] += 7 * 4
        assert model_ops == want
        dp = {k: v["calls"] for k, v in r["comm"].items() if not k.endswith("@model")}
        assert dp == {"gather_workers": 1, "scatter_rows": 1, "all_reduce_sum": 1,
                      "all_gather_shards": 1}


def test_model_axis_refuses_what_it_cannot_serve():
    cfg = load_arch("minitron_4b").SMOKE
    topo = MESH.Topology(n_workers=1, worker=1, zero=1, rank=0, group=object(), model=2,
                         model_group=object())
    lay = TP.topology_layout(cfg, topo)
    base = BO.adamw()
    # the randomized signs and the baselines build over a model axis
    # (test_torch_algorithms_ranks*.py run them)
    assert callable(D.make_dsm_step(lambda p, mb: p, base, D.DSMConfig(sign_mode="rand_pm"),
                                    lambda t: 1e-3, lay, topo))
    with pytest.raises(ValueError, match="rank's layout"):
        D.make_dsm_step(lambda p, mb: p, base, D.DSMConfig(), lambda t: 1e-3, T.layout(cfg),
                        topo)
    init, step = BL.slowmo(lambda p, mb: p, base, 2, lambda t: 1e-3, lay, topo=topo)
    assert callable(init) and callable(step)
    with pytest.raises(ValueError, match="rank's layout"):
        BL.slowmo(lambda p, mb: p, base, 2, lambda t: 1e-3, T.layout(cfg), topo=topo)
