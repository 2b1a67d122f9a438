"""Serving on the ``(data, model)`` mesh against the JAX package's dense
serving, on gloo ranks on the CPU (``tests/torch_ranks.py::serve_rank``),
all f32 at SMOKE widths.

Each rank holds its blocks of every leaf by the reference's serving
placement (``convert.shard_flat`` of the params that ``from_jax_numpy``
makes from the reference's ``init_params``) and serves its data row's rows
of a 4-sequence batch: 19 prompt tokens (past gemma3's 16-slot window, so
its ring wraps during decode), a VLM's 16 patches or an encdec's frames
beside them.

  * Grids (data 1, model 2), (data 2, model 2) and (data 1, model 4) for
    every family, Megatron-split: nano (tied), minitron_4b (GQA; at 4
    ranks its 2 KV heads are cut: two ranks read each), granite_34b (MQA),
    deepseek_67b (untied ``lm_head``), gemma3_1b (``swa``), granite_moe
    and llama4 (MoE FFNs split over the model axis, llama4's shared experts
    too), llava (``patch_proj`` column-parallel), mamba2 (its SSD by
    heads), recurrentgemma (the RG-LRU by channels) and whisper (the
    encoder and the cross-attention by heads).  Grid (data 1, model 3)
    for mamba2 and recurrentgemma, whose heads and channels do not divide
    over it: the mixer computed whole on every rank, each leaf gathered.
  * Prefill: each rank's logits (its rows, and its vocab block where the
    logits are split) and cache (its rows; the KV heads its query heads
    read, the cross-attention's too; a recurrent layer's state of its heads
    or channels) against the slices of the JAX package's
    ``prefill``; the blocks cover the whole (B, padded vocab).  Then
    ``N_DEC`` teacher-forced ``decode_step``s against JAX's ``decode_step``,
    every step's logits and the cache after them.  Tolerances:
    ``test_torch_serve.py``'s ``LOGIT_TOL`` / ``CACHE_TOL`` (mamba2's cache
    its ``SSD_CACHE_REL``).
  * Greedy ``generate``: every rank returns the whole batch's tokens, the
    same on every rank, equal to the JAX package's ``generate`` wherever
    the reference's top-2 margin exceeds 10 x ``LOGIT_TOL["atol"]``, as
    ``test_torch_serve.py`` checks (a row is compared up to its first step
    inside that margin).  llava's reference ``generate`` overruns its cache
    (ROADMAP.md, "Reference caveats"), so its tokens are held against the
    reference's greedy loop with a cache that holds every position.
  * ``CommStats`` per group equals ``tensor_parallel.serve_collectives`` to
    the byte, per phase; ``init_cache(..., layout=)`` has the rank's shapes.
  * Temperature sampling: per step the ranks' logits and Gumbel noise
    blocks, concatenated, give the ranks' tokens under a dense pick of
    ``logits / T + g``; each rank's noise is its ``(seed, model index)``
    generator's draw for the whole batch, its rows cut out, so every row
    has noise of its own and one prompt in every row gives different
    samples.
  * The serving placement's model dims equal the training placements'
    (x0's and the worker params') for every arch id, and a head split that
    cuts KV groups is refused.
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
from repro.train import serve as JS
from repro_torch.configs import load_arch
from repro_torch.distributed import mesh as MESH
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.comm import scaled_sum
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch import dryrun as DR
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import serve as S
from repro_torch.train import trainer as TR
from test_torch_serve import CACHE_TOL, LOGIT_TOL, SSD_CACHE_REL, _leaves
from test_torch_tensor_parallel import _batch, _configs, _torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

GRIDS = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4), "1x3": (1, 3)}
MEGATRON = ("nano", "minitron_4b", "granite_34b", "deepseek_67b", "gemma3_1b",
            "granite_moe_3b_a800m", "llama4_maverick_400b_a17b", "llava_next_34b",
            "mamba2_780m", "recurrentgemma_2b", "whisper_large_v3")
# over 3 model ranks mamba2's 8 heads and recurrentgemma's 128 RG-LRU
# channels do not divide: each rank serves the whole mixer over its leaves
UNDIVIDED = ("mamba2_780m", "recurrentgemma_2b")
CASES = ([(a, g) for g in ("1x2", "2x2", "1x4") for a in MEGATRON]
         + [(a, "1x3") for a in UNDIVIDED])
IDS = [f"{a}-{g}" for a, g in CASES]
SAMPLED = ("minitron_4b", "2x2")           # the temperature case
TEMPERATURE = 1.5
SAME_PROMPT = SAMPLED + (TEMPERATURE, True)  # ... with every row the same prompt
B, S_PROMPT, N_DEC, NEW = 4, 19, 3, 4


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    TR.set_matmul_precision()


@functools.cache
def reference(arch: str) -> dict:
    """The JAX package's dense serving of ``arch`` on one batch: prefill,
    ``N_DEC`` teacher-forced decode steps, greedy tokens and every step's
    logits along them (the reference's jitted prefill and decode)."""
    jcfg, cfg = _configs(arch)
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    batch = _batch(cfg, 1, (B,), S_PROMPT)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    extra = {k: v for k, v in jb.items() if k != "tokens"}
    n0 = S_PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)
    prefill = jax.jit(lambda p, b: JT.prefill(p, b, jcfg, remat=False))
    decode = jax.jit(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, jcfg))
    logits, small = prefill(jp, jb)
    start = JS._splice_cache(JT.init_cache(jcfg, B, n0 + NEW, jcfg.act_dtype), small, jcfg, n0)
    dec = np.random.default_rng(2).integers(0, cfg.vocab_size, (N_DEC, B)).astype(np.int32)
    steps, cache = [], start
    for i, tok in enumerate(dec):
        lg, cache = decode(jp, cache, jnp.asarray(tok), jnp.int32(n0 + i))
        steps.append(np.asarray(lg))

    def follow(toks):
        """Each step's logits along ``toks`` (None: greedy), and the tokens."""
        lg, c, out, seen = logits, start, [], []
        for i in range(NEW):
            seen.append(np.asarray(lg)[:, :cfg.vocab_size])
            tok = (np.argmax(seen[-1], axis=-1).astype(np.int32) if toks is None
                   else toks[:, i])
            out.append(tok)
            if i + 1 < NEW:
                lg, c = decode(jp, c, jnp.asarray(tok), jnp.int32(n0 + i))
        return np.stack(out, axis=1), seen

    if cfg.family == "vlm":
        toks, seen = follow(None)
    else:
        toks = np.asarray(JS.generate(jp, jcfg, jb["tokens"], max_new_tokens=NEW,
                                      extra_batch=extra or None)[0])
        toks, seen = follow(toks)
    return {"cfg": cfg, "jp": jp, "batch": batch, "n0": n0, "logits": np.asarray(logits),
            "cache": _leaves(small), "dec": dec, "dec_logits": steps, "dec_cache": _leaves(cache),
            "tokens": toks, "step_logits": seen,
            "row": convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]}


def _payload(arch: str, grid: str, temperature: float, same_prompt: bool = False) -> dict:
    ref = reference(arch)
    batch = _torch(ref["batch"])
    if same_prompt:
        batch = {k: v[:1].expand_as(v).clone() for k, v in batch.items()}
    return {"cfg": ref["cfg"], "model": GRIDS[grid][1], "row": ref["row"],
            "batch": batch, "dec_tokens": torch.from_numpy(ref["dec"]).long(),
            "new": NEW, "temperature": temperature}


@pytest.fixture(scope="module")
def served() -> dict:
    """``{(arch, grid, temperature): [each rank's serve_rank result]}``: one
    start of the ranks per world size."""
    keys = [(a, g, 0.0) for a, g in CASES] + [SAMPLED + (TEMPERATURE,), SAME_PROMPT]
    by_world: dict = {}
    for key in keys:
        D, M = GRIDS[key[1]]
        by_world.setdefault(D * M, []).append(key)
    out = {}
    for world, group in sorted(by_world.items()):
        res = run_ranks(torch_ranks.serve_rank, world, ([_payload(*k) for k in group],),
                        timeout_s=300)
        out.update({k: [r[i] for r in res] for i, k in enumerate(group)})
    return out


def _kv_range(cfg, M: int, m: int) -> range:
    """The KV heads model rank m of M caches: those its query heads [m H/M,
    (m + 1) H/M) read; all of them where H / M is not whole."""
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    if H % M:
        return range(KVH)
    rep = H // KVH
    heads = sorted({h // rep for h in range(m * H // M, (m + 1) * H // M)})
    return range(heads[0], heads[-1] + 1)


def _rank_slice(path: str, leaf: np.ndarray, r: dict, cfg, M: int) -> np.ndarray:
    """The slice of a dense cache leaf that rank ``r`` holds: its rows and
    its KV heads of a key or value (the cross-attention's too); an ``ssm``
    layer's state of its heads and conv tail of its heads' x channels and
    every B and C channel, an ``rglru`` layer's of its channels
    (``transformer.mixer_parts``)."""
    lead = 1 if path.startswith("blocks") else 0
    out = leaf[(slice(None),) * lead + (slice(*r["rows"]),)]
    _, layer, name = path.split(".")
    mixer = cfg.pattern[int(layer.lstrip("p"))].split(":")[0]
    if name in ("k", "v", "kx", "vx"):
        heads = _kv_range(cfg, M, r["model_index"])
        return out[..., heads.start:heads.stop, :]
    if mixer in T.RECURRENT and T._rank_width(mixer, cfg, M) is not None:
        parts = T.mixer_parts(mixer, cfg, M, r["model_index"])
        if name == "state":
            ((a, b),) = parts["A_log"][1]
            return out[..., a:b, :, :]
        ranges = parts["conv.b" if name == "conv" else "lam"][1]
        return np.concatenate([out[..., a:b] for a, b in ranges], axis=-1)
    return out


# whisper's and llava's SMOKE keys and values reach magnitudes past 4 (the
# stub frame and patch embeddings are standard normal): their cache leaves
# and logits are held as tests/test_torch_encdec_vlm.py holds them, within
# the same atol per unit of the leaf's largest magnitude (at least 1)
SCALED = ("whisper_large_v3", "llava_next_34b")


def _scaled(tol: dict, arch: str, leaf: np.ndarray) -> dict:
    if arch not in SCALED:
        return tol
    return dict(tol, atol=tol["atol"] * max(1.0, float(np.abs(leaf).max())))


def _cache_tol(arch: str, leaf: np.ndarray) -> dict:
    if arch == "mamba2_780m":
        return dict(rtol=0, atol=SSD_CACHE_REL * float(np.abs(leaf).max()))
    return _scaled(CACHE_TOL, arch, leaf)


def _assert_rank_cache(ours, theirs: dict, r: dict, arch: str, M: int) -> None:
    cfg = reference(arch)["cfg"]
    mine = _leaves(ours)
    assert sorted(mine) == sorted(theirs)
    for path, leaf in theirs.items():
        want = _rank_slice(path, leaf, r, cfg, M)
        assert mine[path].shape == want.shape, path
        np.testing.assert_allclose(mine[path], want, err_msg=path, **_cache_tol(arch, want))


def _assert_rank_logits(blocks: list, theirs: np.ndarray, arch: str, M: int) -> None:
    """Every rank's block against its slice of the dense logits; together
    the blocks cover every row and column."""
    cfg = reference(arch)["cfg"]
    covered = np.zeros(theirs.shape, dtype=bool)
    for r, lg in blocks:
        n = lg.shape[-1]
        split = n < cfg.padded_vocab
        assert split == (cfg.padded_vocab % M == 0), (n, M)
        cols = slice(r["model_index"] * n, (r["model_index"] + 1) * n) if split else slice(None)
        rows = slice(*r["rows"])
        np.testing.assert_allclose(lg.numpy(), theirs[rows, cols],
                                   **_scaled(LOGIT_TOL, arch, theirs))
        covered[rows, cols] = True
    assert covered.all()


@pytest.mark.parametrize("arch,grid", CASES, ids=IDS)
def test_prefill_matches_jax(served, arch, grid):
    ref, M = reference(arch), GRIDS[grid][1]
    ranks = served[(arch, grid, 0.0)]
    assert sorted((r["data_index"], r["model_index"]) for r in ranks) == [
        (d, m) for d in range(GRIDS[grid][0]) for m in range(M)]
    _assert_rank_logits([(r, r["prefill"]["logits"]) for r in ranks], ref["logits"], arch, M)
    for r in ranks:
        _assert_rank_cache(r["prefill"]["cache"], ref["cache"], r, arch, M)


@pytest.mark.parametrize("arch,grid", CASES, ids=IDS)
def test_decode_matches_jax(served, arch, grid):
    """Each teacher-forced decode step's logits, then the cache after them."""
    ref, M = reference(arch), GRIDS[grid][1]
    ranks = served[(arch, grid, 0.0)]
    for i, theirs in enumerate(ref["dec_logits"]):
        _assert_rank_logits([(r, r["decode"]["logits"][i]) for r in ranks], theirs, arch, M)
    for r in ranks:
        _assert_rank_cache(r["decode"]["cache"], ref["dec_cache"], r, arch, M)


@pytest.mark.parametrize("arch,grid", CASES, ids=IDS)
def test_greedy_tokens_match_jax(served, arch, grid):
    """The same whole-batch tokens on every rank, equal to the reference's
    up to each row's first step whose top-2 margin is inside 10 x atol."""
    ref = reference(arch)
    ranks = served[(arch, grid, 0.0)]
    toks = ranks[0]["generate"]["tokens"]
    assert toks.shape == (B, NEW)
    assert all(torch.equal(r["generate"]["tokens"], toks) for r in ranks)
    decided = 0
    for row in range(B):
        for i, lg in enumerate(ref["step_logits"]):
            top2 = np.sort(lg[row])[-2:]
            if top2[1] - top2[0] <= 10 * LOGIT_TOL["atol"]:
                break
            assert toks[row, i].item() == ref["tokens"][row, i], (row, i)
            decided += 1
    assert decided >= B * NEW // 2


@pytest.mark.parametrize("arch,grid", CASES, ids=IDS)
def test_collectives_and_cache_placement(served, arch, grid):
    """Per phase each rank's CommStats equals the placement's reckoning to
    the byte (prefill on the rank's blocks as they are: the params resolved
    and the call; ``serving_params``, then each decode step on what it
    resolved; generate: the params resolved once, the prefill, NEW - 1
    decode steps, NEW picks and the rows' tokens gathered over data); its
    init_cache has its rows and, on the Megatron path, its KV heads."""
    ref, (D, M) = reference(arch), GRIDS[grid]
    cfg, n0 = ref["cfg"], ref["n0"]
    for r in served[(arch, grid, 0.0)]:
        lay = TP.rank_layout(cfg, M, r["model_index"])
        b = r["rows"][1] - r["rows"][0]
        assert b == B // D
        resolve, prefill, decode, pick = (TP.serve_collectives(cfg, lay, b, n0, k)
                                          for k in ("serving_params", "prefill", "decode",
                                                    "pick"))
        assert r["prefill"]["comm"] == scaled_sum((1, resolve), (1, prefill))
        assert r["decode"]["serving_params_comm"] == resolve
        assert r["decode"]["comm"] == scaled_sum((N_DEC, decode))
        gathered = {"all_gather@data": {"calls": 1, "bytes": b * NEW * 8}} if D > 1 else {}
        assert r["generate"]["comm"] == scaled_sum((1, resolve), (1, prefill),
                                                   (NEW - 1, decode), (NEW, pick), (1, gathered))
        heads = len(_kv_range(cfg, M, r["model_index"]))
        for path, shape in r["init_cache"].items():
            lead = (cfg.n_scan_blocks,) if path.startswith("blocks") else ()
            assert shape[len(lead)] == b, path
            if path.rsplit(".", 1)[-1] in ("k", "v"):
                assert shape[len(lead) + 2] == heads, path


def test_temperature_sampling_is_the_dense_pick_of_the_ranks_noise(served):
    """minitron_4b on (2, 2) at temperature 1.5: per data row and step the
    model ranks' logit blocks and their rows of the noise, concatenated,
    give the ranks' tokens under the dense pick (argmax of logits / T + g
    over the unpadded vocab).  Each rank's noise is its (0, model index)
    generator's draw for the whole batch, its rows cut out: the two model
    ranks' noise differs, and so does the two data rows' at each model
    index."""
    ranks = served[SAMPLED + (TEMPERATURE,)]
    cfg = reference(SAMPLED[0])["cfg"]
    D, M = GRIDS[SAMPLED[1]]
    toks = ranks[0]["generate"]["tokens"]
    assert all(torch.equal(r["generate"]["tokens"], toks) for r in ranks)
    for d in range(D):
        row = sorted((r for r in ranks if r["data_index"] == d), key=lambda r: r["model_index"])
        rows = slice(*row[0]["rows"])
        for i in range(NEW):
            lg = torch.cat([r["generate"]["logits"][i] for r in row], dim=-1)
            g = torch.cat([r["generate"]["noise"][i][rows] for r in row], dim=-1)
            pick = (lg / TEMPERATURE + g)[:, :cfg.vocab_size].argmax(-1)
            assert torch.equal(pick, toks[rows, i]), (d, i)
        for r in row:
            gen = TP.noise_generator(0, r["model_index"], "cpu")
            assert len(r["generate"]["noise"]) == NEW
            for noise in r["generate"]["noise"]:
                assert noise.shape[0] == B
                assert torch.equal(noise, S.gumbel(noise.shape, gen, "cpu"))
        assert not torch.equal(row[0]["generate"]["noise"][0], row[1]["generate"]["noise"][0])
    by = {(r["data_index"], r["model_index"]): r for r in ranks}
    for m in range(M):
        a, b = by[(0, m)], by[(1, m)]
        for i in range(NEW):
            mine, theirs = (r["generate"]["noise"][i][slice(*r["rows"])] for r in (a, b))
            assert not torch.equal(mine, theirs), (m, i)


def test_sampling_duplicate_prompts_diverge(served):
    """minitron_4b on (2, 2) at temperature 1.5 with every row the same
    prompt: each row draws noise of its own, so the four rows sample four
    different sequences, the rows at the same place of the two data rows
    included (one noise stream per data row would give those the same
    tokens); every rank returns the same tokens."""
    ranks = served[SAME_PROMPT]
    toks = ranks[0]["generate"]["tokens"]
    assert all(torch.equal(r["generate"]["tokens"], toks) for r in ranks)
    assert sorted({r["rows"] for r in ranks}) == [(0, B // 2), (B // 2, B)]
    assert len({tuple(t.tolist()) for t in toks}) == B, toks


@pytest.mark.parametrize("arch", DR.ALL_ARCHS)
def test_serving_placement_holds_the_training_blocks(arch):
    """A training rank's saved blocks are a serving rank's: the model dims of
    the reference's serving placement (``zero=D, zero_axes=("data",)``)
    equal those of x0's (over ``("worker", "zero")``) and of the worker
    params' (less their worker dim), on the single pod's grids."""
    from repro_torch.launch.train import resolve_arch

    cfg, topo = resolve_arch(arch)
    lay = T.layout(cfg)
    shapes = dict(zip(lay.names, lay.shapes))
    M = MESH.MODEL_PAR
    D = MESH.mesh_dims(MESH.serving_mesh(MESH.make_production_mesh()))["data"]
    W = topo.n_workers_single
    Z = MESH.mesh_dims(MESH.training_mesh(MESH.make_production_mesh(), W))["zero"]
    serve = SH.param_pspecs(shapes, model=M, zero=D, zero_axes=("data",))
    x0 = SH.param_pspecs(shapes, model=M, zero=W * Z, zero_axes=("worker", "zero"))
    workers = SH.param_pspecs({k: (W,) + s for k, s in shapes.items()}, model=M, zero=Z,
                              worker_axis=True)
    dims = TP.model_dims(cfg, M)
    for name in lay.names:
        d = SH.model_dim(serve[name])
        w = SH.model_dim(workers[name])
        assert d == SH.model_dim(x0[name]) == (None if w is None else w - 1) == dims[name], name
    assert any(d is not None for d in dims.values())


def test_a_head_split_that_cuts_kv_groups_is_refused():
    """6 query heads on 3 KV heads over 2 model ranks: each rank's 3 query
    heads cut a 2-head KV group.  init_cache, prefill, decode_step and
    generate refuse it, naming the ROADMAP item."""
    cfg = dataclasses.replace(load_arch("minitron_4b").SMOKE, n_heads=6, n_kv_heads=3,
                              name="kv_cut")
    lay = TP.rank_layout(cfg, 2, 0)
    params = convert.ShardedParams(lay, lay.views(lay.empty()))
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_cache(cfg, 1, 8, layout=lay)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.prefill(params, {"tokens": tokens}, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.decode_step(params, {}, tokens[:, 0], 4, cfg)
    topo = MESH.Topology(1, 1, 1, rank=0, group=object(), model=2, model_group=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        S.generate(params, cfg, tokens, 2, device="cpu", topo=topo)
    # 8 query heads on 2 KV heads over 4 ranks: two ranks read each KV head
    ok = load_arch("minitron_4b").SMOKE
    cache = T.init_cache(ok, 1, 8, layout=TP.rank_layout(ok, 4, 3))
    assert cache["blocks"]["p0"]["k"].shape == (ok.n_layers, 1, 8, 1, ok.hd)
