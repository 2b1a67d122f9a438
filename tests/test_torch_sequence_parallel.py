"""Sequence parallelism on the model axis (``cfg.attn_seq_shard``) against
the JAX package and the port's own model axis without it, on gloo ranks on
the CPU (``tests/torch_ranks.py``), all f32 at SMOKE widths.

The JAX package runs as its own tests run it on the CPU, with
``attn_seq_shard=True`` inside a one-device ``("model",)`` mesh (jax 0.9.0
accepts the reference's sharding constraints there; they move layout, not
values).  A model rank of M holds its ``(B, S / M, d)`` block of the
residual stream between blocks (``tensor_parallel.seq_shard``):

  * **Against JAX, 2 and 4 ranks.** The loss (rtol 1e-6) and every
    gradient leaf (within 3e-5 of the leaf's largest magnitude; layer 0's
    Mamba-2 ``ssm.norm.scale`` at 4 ranks within ``GRAD_ATOL["ssm"]``, as
    ``test_torch_tensor_parallel_families.py`` holds it) of minitron_4b
    (attention by heads: Megatron-SP), gemma3_1b with ``attn_tp`` on and
    off (off: ``wq`` / ``wk`` / ``wv`` / ``wo`` whole on every rank, the
    block's queries over every rank's keys and values, the ``swa`` window
    across the blocks' edges), granite_moe (the router on E, the (T K, d)
    all-reduce before the combine, the combined output cut to the block),
    mamba2 (by heads), recurrentgemma (by channels, its ``swa`` layer over
    gathered leaves), llava (the patch prefix joined, then cut) and whisper
    (the encoder over its block of the frames, the output gathered for the
    cross-attention); at 2 ranks minitron, granite_moe, mamba2 and whisper
    under remat too; at 3 ranks (S = 30) minitron (8 heads: every head over
    the leaves' blocks gathered) and mamba2 (4 heads: the whole mixer over
    the gathered sequence).
  * **Against the port without the flag**, the same leaves within 3e-5 of
    each leaf's largest magnitude, the loss rtol 1e-6.
  * **The layout.** Every block's output is the rank's block (an encoder's
    of its frames); with S % M != 0 (S = 30 at 4 ranks) the sequence stays
    whole, the collectives those without the flag.
  * **Collectives.** Each rank's ``CommStats`` equals
    ``tensor_parallel.microbatch_collectives`` to the byte, with and
    without remat: the all-reduces of the row-parallel outputs become
    reduce-scatters.
  * **The DSM step** (AdamW, tau 2, gamma 1e-3, eta 0.5, ZeRO, the
    device-parallel local phase) of minitron_4b over (worker 2, zero 1,
    model 2) and under FSDP over (1, 2, 2), one round each against the
    dense step: the global step from the dense x_tau, x0 and m on each
    rank's blocks bit for bit; x_tau, x0 and m within the AdamW bound of
    ``test_torch_tensor_parallel.py`` and its consequences; the model and
    zero groups' collectives ``local_phase_collectives``' to the byte.
  * **Prefill** over (data 1, model 2 / 4): the logits and the rank's cache
    against the JAX package's ``prefill`` (``test_torch_serve.py``'s
    tolerances), the cache the one the rank holds without the flag, the
    collectives ``serve_collectives``'.  A sequence split over data
    (``tensor_parallel.serve_split``) with the flag runs (on meta here;
    ``test_torch_serve_sequence_split_sp.py`` holds it on gloo ranks).
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.core import dsm as D
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.comm import scaled_sum
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch.dryrun import ATTN_NAMES
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR
from test_torch_recurrent import GRAD_ATOL
from test_torch_serve import LOGIT_TOL, _leaves
from test_torch_serve_model_axis import _cache_tol, _rank_slice, _scaled
from test_torch_tensor_parallel import _adam_bound, _batch, _configs, _torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

B, S, S_UNDIVIDED = 2, 32, 30
# case name -> (arch, leaves held whole on every model rank)
NAMES = {"minitron_4b": ("minitron_4b", ()), "gemma3_1b": ("gemma3_1b", ()),
         "gemma3_1b-attn_tp_off": ("gemma3_1b", ATTN_NAMES),
         "granite_moe_3b_a800m": ("granite_moe_3b_a800m", ()),
         "mamba2_780m": ("mamba2_780m", ()), "recurrentgemma_2b": ("recurrentgemma_2b", ()),
         "llava_next_34b": ("llava_next_34b", ()), "whisper_large_v3": ("whisper_large_v3", ())}
REMAT = ("minitron_4b", "granite_moe_3b_a800m", "mamba2_780m", "whisper_large_v3")
# (name, M, remat, S)
CASES = ([(n, m, False, S) for m in (2, 4) for n in NAMES]
         + [(n, 2, True, S) for n in REMAT]
         + [(n, 3, False, S_UNDIVIDED) for n in ("minitron_4b", "mamba2_780m")]
         + [("minitron_4b", 4, False, S_UNDIVIDED)])
IDS = [f"{n}-{m}ranks-S{s}{'-remat' if r else ''}" for n, m, r, s in CASES]
# the one (case, leaf) shown to need more than 3e-5 against the reference
LOOSE = {("mamba2_780m", 4): {"decoder.blocks.p0.ssm.norm.scale"}}
TAU, GAMMA, ETA = 2, 1e-3, 0.5
PREFILL = ("minitron_4b", "gemma3_1b-attn_tp_off", "mamba2_780m", "llava_next_34b",
           "whisper_large_v3")
PREFILL_CASES = [(n, m) for m in (2, 4) for n in PREFILL]
S_PROMPT, NEW = 20, 2


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    TR.set_matmul_precision()


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("model",))


def sp_configs(name: str) -> tuple:
    """(the JAX config, the port's, the leaves held whole) with the flag."""
    arch, rep = NAMES[name]
    return tuple(dataclasses.replace(c, attn_seq_shard=True) for c in _configs(arch)) + (rep,)


@functools.cache
def reference(arch: str, seq: int) -> tuple:
    """The JAX package's loss and gradient leaves under the flag, and the
    dense ``(N,)`` row of its params."""
    jcfg, cfg, _ = sp_configs(arch)
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(cfg, 1, (B,), seq).items()}
    with _mesh():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: JT.loss_fn(p, jb, jcfg, remat=False)))(jp)
    row = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
    return float(loss), dict(convert.flatten_tree(
        jax.tree.map(np.asarray, grads), is_leaf=lambda x: isinstance(x, np.ndarray))), row


@pytest.fixture(scope="module")
def sp_runs() -> dict:
    """``{case: each rank's sp_losses_rank result}``: one start of the ranks
    per world size."""
    out = {}
    for M in sorted({c[1] for c in CASES}):
        group = [c for c in CASES if c[1] == M]
        payload = []
        for name, _, remat, seq in group:
            _, cfg, rep = sp_configs(name)
            payload.append({"cfg": cfg, "row": reference(NAMES[name][0], seq)[2],
                            "batch": _torch(_batch(cfg, 1, (B,), seq)), "remat": remat,
                            "replicate": rep})
        res = run_ranks(torch_ranks.sp_losses_rank, M, (payload,), timeout_s=300)
        out.update({c: [r[i] for r in res] for i, c in enumerate(group)})
    return out


def _layouts(cfg, M: int, rep: tuple) -> list:
    return [TP.rank_layout(cfg, M, m, replicate_names=rep) for m in range(M)]


def _gathered(ranks: list, key, cfg, M: int, rep: tuple) -> dict:
    lay = T.layout(cfg)
    return convert.to_numpy(convert.gather_flat([key(r) for r in ranks], lay,
                                                _layouts(cfg, M, rep)), cfg)


@pytest.mark.parametrize("name,M,remat,seq", CASES, ids=IDS)
def test_sp_loss_and_grads_match_jax(sp_runs, name, M, remat, seq):
    jloss, theirs, _ = reference(NAMES[name][0], seq)
    _, cfg, rep = sp_configs(name)
    ranks = sp_runs[(name, M, remat, seq)]
    assert [r["index"] for r in ranks] == list(range(M))
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0].item(), jloss, rtol=1e-6)
    ours = _gathered(ranks, lambda r: r["grads"][0], cfg, M, rep)
    assert sorted(ours) == sorted(theirs)
    loose = LOOSE.get((NAMES[name][0], M), set())
    for leaf, g in theirs.items():
        rel = GRAD_ATOL["ssm"] if leaf in loose else 3e-5
        np.testing.assert_allclose(ours[leaf], g, rtol=0, atol=rel * float(np.abs(g).max()),
                                   err_msg=leaf)


@pytest.mark.parametrize("name,M,remat,seq", CASES, ids=IDS)
def test_sp_matches_the_model_axis_without_it(sp_runs, name, M, remat, seq):
    _, cfg, rep = sp_configs(name)
    ranks = sp_runs[(name, M, remat, seq)]
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0].item(), r["plain"]["losses"][0].item(),
                                   rtol=1e-6)
    ours = _gathered(ranks, lambda r: r["grads"][0], cfg, M, rep)
    plain = _gathered(ranks, lambda r: r["plain"]["grads"][0], cfg, M, rep)
    for leaf, g in plain.items():
        np.testing.assert_allclose(ours[leaf], g, rtol=0,
                                   atol=3e-5 * float(np.abs(g).max()), err_msg=leaf)


@pytest.mark.parametrize("name,M,remat,seq", CASES, ids=IDS)
def test_sp_residual_is_the_rank_block(sp_runs, name, M, remat, seq):
    """Every block's output (the residual between blocks) is the rank's
    ``(B, S / M, d)`` block of the decoder's n_prefix + S positions (an
    encoder block's of its frames); where S does not divide, it is whole."""
    _, cfg, _ = sp_configs(name)
    n = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
    dec = (B, n // M if n % M == 0 else n, cfg.d_model)
    want = [dec] * cfg.n_layers
    if cfg.family == "encdec":
        want = [(B, cfg.enc_len // M, cfg.d_model)] * cfg.enc_layers + want
    for r in sp_runs[(name, M, remat, seq)]:
        # under remat each checkpointed body runs again in the backward
        assert r["shapes"][:len(want)] == want
        assert set(r["shapes"]) == set(want)


@pytest.mark.parametrize("name,M,remat,seq", CASES, ids=IDS)
def test_sp_collectives_equal_the_reckoning(sp_runs, name, M, remat, seq):
    _, cfg, rep = sp_configs(name)
    lay = _layouts(cfg, M, rep)[0]
    want = TP.microbatch_collectives(cfg, lay, B, seq, remat)
    plain = TP.microbatch_collectives(dataclasses.replace(cfg, attn_seq_shard=False), lay, B,
                                      seq, remat)
    assert all(r["comm"] == want for r in sp_runs[(name, M, remat, seq)]), (
        sp_runs[(name, M, remat, seq)][0]["comm"], want)
    n = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
    assert (want == plain) == bool(n % M)


def test_seq_shard_rule():
    """The sequence splits only with the flag, on a model-parallel layout,
    where it divides; rank m holds ``[m S / M, (m + 1) S / M)``."""
    cfg = _configs("minitron_4b")[1]
    sp_cfg = dataclasses.replace(cfg, attn_seq_shard=True)
    lay = TP.rank_layout(cfg, 4, 2)
    assert TP.seq_shard(cfg, lay, 32) is None
    assert TP.seq_shard(sp_cfg, T.layout(cfg), 32) is None
    assert TP.seq_shard(sp_cfg, lay, 30) is None
    sp = TP.seq_shard(sp_cfg, lay, 32)
    assert (sp.start, sp.stop, sp.n, sp.world, sp.index) == (16, 24, 8, 4, 2)


def test_serve_split_with_sp_is_refused():
    """A prefill whose sequence lies over data (``serve_split``) with the
    flag on a model rank, which raised until the combination was ported,
    now runs: on meta (``dryrun.reckon_serve``, one sequence over (data 2,
    model 2), its positions and its cache's slots over data) it returns the
    rank's logits and cache, its collectives the reckoning's, reduce-scattered
    over the model group (``test_torch_serve_sequence_split_sp.py`` holds
    it against the JAX package on gloo ranks)."""
    from repro_torch.launch import dryrun as DR

    cfg = sp_configs("minitron_4b")[1]
    for n0, new in ((8, 0), (8, 2)):
        rec = DR.reckon_serve(cfg, "generate" if new else "prefill", 1, n0, 2, 2, new=new)
        assert rec["seq_over_data"] and rec["cache_slots_over_data"]
        assert "reduce_scatter@model" in rec["comm"] and "all_gather@data" in rec["comm"]
    seq, _ = TP.serve_split(1, 8, 0, cfg, 2, 0)
    lay = TP.rank_layout(cfg, 2, 0)
    assert DR.reckon_serve(cfg, "prefill", 1, 8, 2, 2)["comm"] == scaled_sum(
        (1, TP.serve_collectives(cfg, lay, 1, 8, "serving_params")),
        (1, TP.serve_collectives(cfg, lay, 1, 8, "prefill", chunk=seq)))


# ---------------------------------------------------------------------------
# The DSM step, with and without FSDP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_runs() -> dict:
    """minitron_4b SMOKE with the flag: ``{(W, fsdp): (batches, dense run,
    each rank's run)}``, one start of 4 ranks for (2, 1, 2) and, under
    FSDP, (1, 2, 2)."""
    cfg = sp_configs("minitron_4b")[1]
    row = T.init_params(torch.Generator().manual_seed(0), cfg)
    flags = {"zero_sharded": True, "device_parallel_local": True}
    runs, cases = {}, []
    for W, fsdp in ((2, False), (1, True)):
        b = _batch(cfg, 5, (W, TAU, 1, B), S)
        b["tokens"] = b["tokens"].astype(np.int64)
        runs[(W, fsdp)] = ([b], torch_ranks.dsm_case(None, cfg, W, {}, row, [b], GAMMA))
        cases.append(dict(cfg=cfg, n_workers=W, model=2, fsdp=fsdp, flags=flags, row=row,
                          batches=[b], gamma=GAMMA))
    res = run_ranks(torch_ranks.fsdp_dsm_rank, 4, (cases,), timeout_s=300)
    return cfg, row, {k: v + ([r[i] for r in res],) for i, (k, v) in enumerate(runs.items())}


STEP_GRIDS = [(2, False), (1, True)]
STEP_IDS = ["2x1x2", "1x2x2-fsdp"]


def _step_layouts(cfg, fsdp: bool, ranks: list) -> list:
    return [TP.rank_layout(cfg, 2, r["index"], zero=2 if fsdp else 1,
                           zero_index=r["zero_index"] if fsdp else 0) for r in ranks]


@pytest.mark.parametrize("W,fsdp", STEP_GRIDS, ids=STEP_IDS)
def test_sp_dsm_step_against_dense(step_runs, W, fsdp):
    cfg, row, runs = step_runs
    _, dense, ranks = runs[(W, fsdp)]
    lay = T.layout(cfg)
    # one rank per (model, zero) block: x_tau, x0 and m are whole over the
    # rank's (worker, zero) ranks without FSDP, its zero block with it
    ranks = list({(r["index"], r["zero_index"]): r for r in ranks}.values())
    lays = _step_layouts(cfg, fsdp, ranks)
    cut = D.DSMConfig(tau=TAU, global_lr=ETA)
    for rl in lays:
        x0, mom = convert.shard_flat(row, lay, rl), torch.zeros_like(convert.shard_flat(row, lay,
                                                                                      rl))
        D.global_sign_momentum_step(x0, mom, convert.shard_flat(dense["x_tau"][0], lay, rl),
                                    GAMMA, cut)
        assert torch.equal(x0.view(torch.int32),
                           convert.shard_flat(dense["x0"][0], lay, rl).view(torch.int32))
        assert torch.equal(mom.view(torch.int32),
                           convert.shard_flat(dense["m"][0], lay, rl).view(torch.int32))
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0].item(), dense["losses"][0].item(), rtol=1e-5)
    got = {n: convert.gather_flat([r[n][0] for r in ranks], lay, lays)
           for n in ("x_tau", "x0", "m")}
    xt = 2 * GAMMA * sum(_adam_bound(t) for t in range(1, TAU + 1))
    bounds = {"x_tau": xt, "x0": 2 * ETA * GAMMA, "m": (1 - cut.beta2) * xt / GAMMA}
    for n, b in bounds.items():
        gap = float((got[n] - dense[n][0]).abs().max())
        assert gap <= b * (1 + 1e-5) + 1e-6 * float(dense[n][0].abs().max()), (n, gap, b)
    assert int(((got["x0"] - dense["x0"][0]).abs() > 0).sum()) <= lay.numel // 1000


@pytest.mark.parametrize("W,fsdp", STEP_GRIDS, ids=STEP_IDS)
def test_sp_dsm_step_collectives(step_runs, W, fsdp):
    """The model and zero groups' collectives of the round: the local
    phase's reckoning (with the flag), plus the stat sums' all-reduce over
    the model group."""
    cfg, _, runs = step_runs
    _, _, ranks = runs[(W, fsdp)]
    for r, rl in zip(ranks, _step_layouts(cfg, fsdp, ranks)):
        # one worker per rank: each worker row holds one of W = 2, or W = 1
        local = TP.local_phase_collectives(cfg, rl, 1, TAU, B, S)
        want = scaled_sum((1, local), (1, {"all_reduce_sum@model": {"calls": 1,
                                                                    "bytes": 7 * 4}}))
        got = {k: v for k, v in r["comm"].items() if k.endswith(("@model", "@zero"))}
        assert got == want
        assert "reduce_scatter@model" in got and ("reduce_scatter@zero" in got) == fsdp


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@functools.cache
def prefill_reference(name: str) -> dict:
    """The JAX package's prefill logits and cache under the flag."""
    jcfg, cfg, _ = sp_configs(name)
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    batch = _batch(cfg, 1, (B,), S_PROMPT)
    with _mesh():
        logits, cache = jax.jit(lambda p, b: JT.prefill(p, b, jcfg, remat=False))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"logits": np.asarray(logits), "cache": _leaves(cache), "batch": batch,
            "row": convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]}


@pytest.fixture(scope="module")
def prefill_runs() -> dict:
    """``{(name, M, flag): each rank's serve_rank result}`` with and without
    the flag, one start of the ranks per M."""
    out = {}
    dec = torch.from_numpy(np.random.default_rng(2).integers(0, 32, (1, B))).long()
    for M in (2, 4):
        keys, payload = [], []
        for name in PREFILL:
            _, cfg, rep = sp_configs(name)
            ref = prefill_reference(name)
            for flag in (True, False):
                keys.append((name, M, flag))
                payload.append({"cfg": dataclasses.replace(cfg, attn_seq_shard=flag), "model": M,
                                "row": ref["row"], "batch": _torch(ref["batch"]),
                                "dec_tokens": dec, "new": NEW, "temperature": 0.0,
                                "replicate": rep})
        res = run_ranks(torch_ranks.serve_rank, M, (payload,), timeout_s=300)
        out.update({k: [r[i] for r in res] for i, k in enumerate(keys)})
    return out


@pytest.mark.parametrize("name,M", PREFILL_CASES, ids=[f"{n}-{m}ranks" for n, m in PREFILL_CASES])
def test_sp_prefill_matches_jax(prefill_runs, name, M):
    ref = prefill_reference(name)
    _, cfg, rep = sp_configs(name)
    arch = NAMES[name][0]
    theirs = ref["logits"]
    for r, plain in zip(prefill_runs[(name, M, True)], prefill_runs[(name, M, False)]):
        lg = r["prefill"]["logits"].numpy()
        n = lg.shape[-1]
        cols = slice(r["model_index"] * n, (r["model_index"] + 1) * n)
        np.testing.assert_allclose(lg, theirs[:, cols], **_scaled(LOGIT_TOL, arch, theirs))
        mine = _leaves(r["prefill"]["cache"])
        assert sorted(mine) == sorted(ref["cache"])
        for path, leaf in ref["cache"].items():
            want = _rank_slice(path, leaf, r, cfg, M)
            if rep and path.rsplit(".", 1)[-1] in ("k", "v"):
                want = leaf           # every KV head over every position
            assert mine[path].shape == want.shape, path
            np.testing.assert_allclose(mine[path], want, err_msg=path, **_cache_tol(arch, want))
        # the cache the rank holds without the flag
        other = _leaves(plain["prefill"]["cache"])
        for path, leaf in other.items():
            assert mine[path].shape == leaf.shape, path
            np.testing.assert_allclose(mine[path], leaf, err_msg=path, **_cache_tol(arch, leaf))


@pytest.mark.parametrize("name,M", PREFILL_CASES, ids=[f"{n}-{m}ranks" for n, m in PREFILL_CASES])
def test_sp_prefill_collectives(prefill_runs, name, M):
    """The prefill's collectives (the params resolved, then the call) are
    ``serve_collectives``' with the flag: reduce-scatters where the model
    axis without it all-reduces."""
    _, cfg, rep = sp_configs(name)
    n0 = S_PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)
    for r in prefill_runs[(name, M, True)]:
        lay = TP.rank_layout(cfg, M, r["model_index"], replicate_names=rep)
        want = scaled_sum((1, TP.serve_collectives(cfg, lay, B, n0, "serving_params")),
                          (1, TP.serve_collectives(cfg, lay, B, n0, "prefill")))
        assert r["prefill"]["comm"] == want
        assert "reduce_scatter@model" in want
