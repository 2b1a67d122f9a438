"""Serving a batch that does not split over data against the JAX package's
dense serving, on gloo ranks on the CPU (``tests/torch_ranks.py::
serve_rank``), all f32 at SMOKE widths.

Where B % D != 0 or B < D every data row serves the whole batch
(``tensor_parallel.serve_split``, the reference's ``serve_batch_pspecs`` /
``cache_pspecs`` fallback): the prefill runs the rank's chunk of the
decoder sequence (a VLM's 16 patches, then the prompt) where it divides
into D chunks, and a full-attention layer's cache holds the rank's block of
its L slots where L divides; ``swa`` rings, recurrent states, conv tails
and whisper's ``kx`` / ``vx`` stay whole on every data row.

  * Grids (data 2, model 1), (data 4, model 1) and (data 2, model 2) for
    gemma3_1b (``swa`` + global attention), mamba2_780m (the SSD carried
    across the chunks) and recurrentgemma_2b (the RG-LRU carried); every
    other Megatron family at (2, 1); gemma3 at (2, 2) and llava at (2, 1)
    and (4, 1) under FSDP over data (chunks wholly in the patches and
    wholly in the text: every data rank still gathers ``embed`` and
    ``patch_proj``).
    B = 1 everywhere, B = 3 at D = 2; a 32-token prompt (past gemma3
    SMOKE's 16-slot window, so the window spans the chunks' edge); a
    31-token prompt whose positions do not divide over 2 ranks (the prefill
    whole, the 36 cache slots still split); an 8-token prompt over 4 ranks,
    whose 2-position chunks are shorter than the conv's width - 1, for
    mamba2 and recurrentgemma.
  * Each rank's prefill logits (its vocab block where they are split) and
    cache (its block of the full-attention slots, zeros past the prompt;
    its KV heads and recurrent heads or channels on the model axis)
    against the slices of the JAX package's ``prefill``; ``N_DEC``
    teacher-forced ``decode_step``s and the cache after them; greedy
    ``generate``'s tokens, the same on every rank, against the reference's
    greedy loop where its top-2 margin exceeds 10 x ``LOGIT_TOL["atol"]``.
    Tolerances: ``test_torch_serve.py``'s ``LOGIT_TOL`` / ``CACHE_TOL``
    (mamba2's cache its ``SSD_CACHE_REL``).
  * ``CommStats`` per group equals ``tensor_parallel.serve_collectives``
    to the byte, per phase; ``init_cache`` gives each full-attention layer
    L / D slots where L divides.
  * gemma3 in bf16, the registry's serving dtype, at every grid: each
    rank's prefill and teacher-forced decode logits against the port's
    dense bf16 model's from the same params, within the dense bf16 model's
    distance from the same params in f32 at that step (the split's
    combine weighs the values in f32 where the dense decode rounds its
    probabilities to bf16).
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
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.comm import scaled_sum
from repro_torch.distributed.spawn import run_ranks
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import serve as S
from repro_torch.train import trainer as TR
from test_torch_serve import LOGIT_TOL, _leaves
from test_torch_serve_model_axis import MEGATRON, _cache_tol, _rank_slice, _scaled
from test_torch_tensor_parallel import _batch, _configs, _torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

GRIDS = {"2x1": (2, 1), "4x1": (4, 1), "2x2": (2, 2)}
CARRIED = ("gemma3_1b", "mamba2_780m", "recurrentgemma_2b")
N_DEC = 3
# (arch, grid, B, prompt tokens, new tokens, fsdp)
CASES = ([(a, g, 1, 32, 4, False) for g in GRIDS for a in CARRIED]
         + [(a, "2x1", 3, 32, 4, False) for a in CARRIED]
         + [(a, "2x1", 1, 32, 4, False) for a in MEGATRON if a not in CARRIED]
         + [("gemma3_1b", "2x2", 1, 32, 4, True)]
         # llava under FSDP: 16 patches + 16 tokens over 2 ranks (rank 0's
         # chunk all patches, rank 1's all text), + 32 tokens over 4 ranks
         + [("llava_next_34b", "2x1", 1, 16, 4, True), ("llava_next_34b", "4x1", 1, 32, 4, True)]
         + [(a, "2x1", 1, 31, 5, False) for a in ("gemma3_1b", "mamba2_780m")]
         + [(a, "4x1", 1, 8, 4, False) for a in ("mamba2_780m", "recurrentgemma_2b")])
IDS = [f"{a}-{g}-B{b}-S{s}" + ("-fsdp" if f else "") for a, g, b, s, _, f in CASES]
# B = 4 over 4 data rows: one row each (fewer than D), so no sequence split
ROWS = ("gemma3_1b", "4x1", 4, 32, 4, False)


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    TR.set_matmul_precision()


@functools.cache
def jax_params(arch: str) -> tuple:
    """(the reference's params, the port's dense (N,) row of them)."""
    jcfg, cfg = _configs(arch)
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    return jp, convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]


@functools.cache
def reference(arch: str, B: int, S: int, new: int) -> dict:
    """The JAX package's dense serving of ``arch`` on one (B, S) batch:
    prefill, ``N_DEC`` teacher-forced decode steps on a cache of n0 + new
    positions, and the greedy loop's tokens and every step's logits (the
    reference's jitted prefill and decode)."""
    jcfg, cfg = _configs(arch)
    jp, row = jax_params(arch)
    batch = _batch(cfg, 1, (B,), S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    n0 = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    prefill = jax.jit(lambda p, b: JT.prefill(p, b, jcfg, remat=False))
    decode = jax.jit(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, jcfg))
    logits, small = prefill(jp, jb)
    start = JS._splice_cache(JT.init_cache(jcfg, B, n0 + new, jcfg.act_dtype), small, jcfg, n0)
    dec = np.random.default_rng(2).integers(0, cfg.vocab_size, (N_DEC, B)).astype(np.int32)
    steps, cache = [], start
    for i, tok in enumerate(dec):
        lg, cache = decode(jp, cache, jnp.asarray(tok), jnp.int32(n0 + i))
        steps.append(np.asarray(lg))
    lg, c, toks, seen = logits, start, [], []
    for i in range(new):
        seen.append(np.asarray(lg)[:, :cfg.vocab_size])
        toks.append(np.argmax(seen[-1], axis=-1).astype(np.int32))
        if i + 1 < new:
            lg, c = decode(jp, c, jnp.asarray(toks[-1]), jnp.int32(n0 + i))
    return {"cfg": cfg, "batch": batch, "n0": n0, "logits": np.asarray(logits),
            "cache": _leaves(small), "dec": dec, "dec_logits": steps, "dec_cache": _leaves(cache),
            "tokens": np.stack(toks, axis=1), "step_logits": seen, "row": row}


def _payload(arch, grid, B, S, new, fsdp) -> dict:
    ref = reference(arch, B, S, new)
    return {"cfg": ref["cfg"], "model": GRIDS[grid][1], "row": ref["row"],
            "batch": _torch(ref["batch"]), "dec_tokens": torch.from_numpy(ref["dec"]).long(),
            "new": new, "temperature": 0.0, "fsdp": fsdp}


def _dense_steps(params, cfg, batch: dict, dec, new: int) -> list:
    """The port's dense prefill logits, then each teacher-forced
    ``decode_step``'s on a cache of n0 + new positions."""
    n0 = batch["tokens"].shape[1]
    with torch.no_grad():
        logits, small = T.prefill(params, batch, cfg, remat=False)
        cache = S._splice_cache(T.init_cache(cfg, 1, n0 + new), small, cfg, n0)
        steps = [logits]
        for i, tok in enumerate(dec):
            logits, cache = T.decode_step(params, cache, tok, n0 + i, cfg)
            steps.append(logits)
    return steps


@functools.cache
def bf16_dense() -> dict:
    """gemma3 SMOKE in bf16: the port's params from a seed, a B = 1
    32-token batch, ``N_DEC`` teacher-forced tokens, and the dense port's
    logits per step (``_dense_steps``) in bf16 and on the same params in
    f32."""
    cfg32 = load_arch("gemma3_1b").SMOKE
    cfg = dataclasses.replace(cfg32, dtype="bfloat16", param_dtype="bfloat16")
    row = T.init_params(torch.Generator().manual_seed(5), cfg)
    batch = _torch(_batch(cfg, 1, (1,), 32))
    dec = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (N_DEC, 1)))
    params = T.layout(cfg).views(row)
    return {"cfg": cfg, "row": row, "batch": batch, "dec": dec,
            "bf16": _dense_steps(params, cfg, batch, dec, 4),
            "f32": _dense_steps({k: v.float() for k, v in params.items()}, cfg32, batch, dec, 4)}


def _bf16_payload(grid: str) -> dict:
    ref = bf16_dense()
    return {"cfg": ref["cfg"], "model": GRIDS[grid][1], "row": ref["row"], "batch": ref["batch"],
            "dec_tokens": ref["dec"], "new": 4, "temperature": 0.0}


@pytest.fixture(scope="module")
def served() -> dict:
    """``{case: [each rank's serve_rank result]}`` (the bf16 cases under
    ``("bf16", grid)``): one start of the ranks per world size."""
    jobs = ([(c, GRIDS[c[1]], functools.partial(_payload, *c)) for c in CASES + [ROWS]]
            + [(("bf16", g), GRIDS[g], functools.partial(_bf16_payload, g)) for g in GRIDS])
    by_world: dict = {}
    for key, (D, M), payload in jobs:
        by_world.setdefault(D * M, []).append((key, payload))
    out = {}
    for world, group in sorted(by_world.items()):
        res = run_ranks(torch_ranks.serve_rank, world, ([p() for _, p in group],),
                        timeout_s=300)
        out.update({key: [r[i] for r in res] for i, (key, _) in enumerate(group)})
    return out


def _split(t) -> TP.SeqSplit:
    return None if t is None else TP.SeqSplit(*t[:3])


def _mixer(path: str, cfg) -> str:
    return cfg.pattern[int(path.split(".")[1].lstrip("p"))].split(":")[0]


def _want(path: str, leaf: np.ndarray, r: dict, cfg, M: int) -> np.ndarray:
    """The rank's part of a dense cache leaf: ``_rank_slice``'s rows, KV
    heads and recurrent heads or channels, and a full-attention ``k`` /
    ``v``'s block of slots (zeros past the dense leaf's positions)."""
    out = _rank_slice(path, leaf, r, cfg, M)
    slots = _split(r["slots"])
    if slots is None or path.rsplit(".", 1)[-1] not in ("k", "v") or _mixer(path, cfg) == "swa":
        return out
    ax = 2 if path.startswith("blocks") else 1
    part = np.take(out, range(slots.start, min(slots.stop, out.shape[ax])), axis=ax)
    pad = [(0, 0)] * out.ndim
    pad[ax] = (0, slots.n - part.shape[ax])
    return np.pad(part, pad)


def _assert_rank_cache(ours, theirs: dict, r: dict, arch: str, cfg, M: int) -> None:
    mine = _leaves(ours)
    assert sorted(mine) == sorted(theirs)
    for path, leaf in theirs.items():
        want = _want(path, leaf, r, cfg, M)
        assert mine[path].shape == want.shape, path
        np.testing.assert_allclose(mine[path], want, err_msg=path, **_cache_tol(arch, want))


def _assert_rank_logits(ranks: list, key, theirs: np.ndarray, arch: str, cfg) -> None:
    """Every rank's (B, block) logits against its vocab block of the dense
    logits: every data rank holds every row."""
    for r in ranks:
        lg = key(r)
        n = lg.shape[-1]
        cols = slice(r["model_index"] * n, (r["model_index"] + 1) * n)
        assert r["rows"] == (0, theirs.shape[0])
        np.testing.assert_allclose(lg.numpy(), theirs[:, cols], **_scaled(LOGIT_TOL, arch, theirs))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_matches_jax(served, case):
    arch, grid, B, S, new, _ = case
    ref, (D, M) = reference(arch, B, S, new), GRIDS[grid]
    ranks = served[case]
    assert sorted((r["data_index"], r["model_index"]) for r in ranks) == [
        (d, m) for d in range(D) for m in range(M)]
    _assert_rank_logits(ranks, lambda r: r["prefill"]["logits"], ref["logits"], arch, ref["cfg"])
    for r in ranks:
        _assert_rank_cache(r["prefill"]["cache"], ref["cache"], r, arch, ref["cfg"], M)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_matches_jax(served, case):
    """Each teacher-forced decode step's logits, then the cache after them."""
    arch, grid, B, S, new, _ = case
    ref, M = reference(arch, B, S, new), GRIDS[grid][1]
    ranks = served[case]
    for i, theirs in enumerate(ref["dec_logits"]):
        _assert_rank_logits(ranks, lambda r: r["decode"]["logits"][i], theirs, arch, ref["cfg"])
    for r in ranks:
        _assert_rank_cache(r["decode"]["cache"], ref["dec_cache"], r, arch, ref["cfg"], M)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_greedy_tokens_match_jax(served, case):
    """The same whole-batch tokens on every rank, equal to the reference's
    greedy loop up to each row's first step whose top-2 margin is inside
    10 x atol."""
    arch, _, B, S, new, _ = case
    _assert_greedy(served[case], reference(arch, B, S, new))


def _assert_greedy(ranks: list, ref: dict) -> None:
    B, new = ref["tokens"].shape
    toks = ranks[0]["generate"]["tokens"]
    assert toks.shape == (B, new)
    assert all(torch.equal(r["generate"]["tokens"], toks) for r in ranks)
    decided = 0
    for row in range(B):
        for i, lg in enumerate(ref["step_logits"]):
            top2 = np.sort(lg[row])[-2:]
            if top2[1] - top2[0] <= 10 * LOGIT_TOL["atol"]:
                break
            assert toks[row, i].item() == ref["tokens"][row, i], (row, i)
            decided += 1
    assert decided >= B * new // 2


def test_a_batch_over_data_splits_no_sequence(served):
    """B = 4 over 4 data rows, one row each: the rows lie over data and
    neither the prompt nor the caches do, in generate too (its tokens the
    reference's greedy loop's)."""
    arch, _, B, S, new, _ = ROWS
    ranks = served[ROWS]
    assert sorted(r["rows"] for r in ranks) == [(i, i + 1) for i in range(B)]
    assert all(r["seq"] is None and r["slots"] is None for r in ranks)
    _assert_greedy(ranks, reference(arch, B, S, new))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_collectives_and_cache_blocks(served, case):
    """The split the rule picks (the prompt's positions over data where
    they divide, the cache's slots where they divide), per phase each
    rank's CommStats equal to the reckoning's to the byte (the params
    resolved and the prefill; each decode step; generate: the params
    resolved once, the prefill, new - 1 decode steps, new picks and no
    gather of the tokens), and its init_cache's full-attention layers
    L / D slots, its swa rings and recurrent states whole."""
    arch, grid, B, S, new, fsdp = case
    ref, (D, M) = reference(arch, B, S, new), GRIDS[grid]
    cfg, n0 = ref["cfg"], ref["n0"]
    for r in served[case]:
        seq, slots = _split(r["seq"]), _split(r["slots"])
        assert (seq is None) == (n0 % D > 0)
        assert slots == TP.SeqSplit(n0 + new, D, r["data_index"])
        if seq is not None:
            assert seq == TP.SeqSplit(n0, D, r["data_index"])
        lay = (TP.rank_layout(cfg, M, r["model_index"], zero=D, zero_index=r["data_index"],
                              zero_axes=("data",)) if fsdp
               else TP.rank_layout(cfg, M, r["model_index"]))
        resolve = TP.serve_collectives(cfg, lay, B, n0, "serving_params")
        prefill = TP.serve_collectives(cfg, lay, B, n0, "prefill", chunk=seq)
        decode = TP.serve_collectives(cfg, lay, B, n0, "decode", slots=slots)
        pick = TP.serve_collectives(cfg, lay, B, n0, "pick")
        assert r["prefill"]["comm"] == scaled_sum((1, resolve), (1, prefill))
        assert r["decode"]["serving_params_comm"] == resolve
        assert r["decode"]["comm"] == scaled_sum((N_DEC, decode))
        assert r["generate"]["comm"] == scaled_sum((1, resolve), (1, prefill), (new - 1, decode),
                                                   (new, pick))
        if seq is not None:
            assert prefill["all_gather@data"]["calls"] > 0
        for path, shape in r["init_cache"].items():
            lead = 1 if path.startswith("blocks") else 0
            assert shape[lead] == B, path
            name, mixer = path.rsplit(".", 1)[-1], _mixer(path, cfg)
            if name in ("k", "v") and mixer != "swa":
                assert shape[lead + 1] == (n0 + new) // D, path
            elif name in ("k", "v"):
                assert shape[lead + 1] == min(cfg.window, n0 + new), path


@pytest.mark.parametrize("grid", GRIDS)
def test_bf16_split_is_within_the_dense_bf16_noise(served, grid):
    """gemma3 in bf16 over the split (the prompt's chunks, the global
    layer's slots): each rank's prefill and teacher-forced decode logits
    (its vocab block) against the dense bf16 model's, within the dense
    bf16 model's distance from the same params in f32 at that step."""
    ref = bf16_dense()
    for r in served[("bf16", grid)]:
        assert r["seq"] is not None and r["slots"] is not None
        ours = [r["prefill"]["logits"]] + r["decode"]["logits"]
        for i, (lg, d16, d32) in enumerate(zip(ours, ref["bf16"], ref["f32"])):
            n = lg.shape[-1]
            cols = slice(r["model_index"] * n, (r["model_index"] + 1) * n)
            noise = (d16 - d32).abs().max().item()
            gap = (lg - d16[:, cols]).abs().max().item()
            assert gap <= noise, (r["rank"], i, gap, noise)


def test_the_placement_rule():
    """``serve_split``: rows over data where B splits (no sequence split);
    else the sequence in D blocks where it divides, whole where it does
    not; a prefill's blocks an ssm model's SSD cannot chunk (past 128 and
    no multiple of it) whole, a cache's slots never held to that; a
    prompt the SSD cannot chunk whole refused, as the dense path refuses
    it."""
    gemma, mamba = load_arch("gemma3_1b").SMOKE, load_arch("mamba2_780m").SMOKE
    assert TP.serve_split(4, 32, 4, gemma, 2) == (None, None)     # B over data
    assert TP.serve_rows(4, MESH.Topology(2, 2, 1, rank=1, group=object())) == slice(2, 4)
    assert TP.serve_split(1, 32, 4, gemma) == (None, None)        # one data row
    for B in (1, 3):
        got, slots = TP.serve_split(B, 32, 8, gemma, 4, 3)
        assert (got.length, got.world, got.index, got.n, got.start, got.stop) == (
            32, 4, 3, 8, 24, 32)
        assert slots == TP.SeqSplit(40, 4, 3)
        topo = MESH.Topology(4, 4, 1, rank=3, group=object())
        assert TP.serve_rows(B, topo) == slice(0, B)
    assert TP.serve_split(1, 31, 5, gemma, 2) == (None, TP.SeqSplit(36, 2, 0))  # 31: whole
    assert TP.serve_split(1, 0, 36, gemma, 2) == (None, TP.SeqSplit(36, 2, 0))  # decode alone
    assert TP.serve_split(1, 384, 0, mamba, 2) == (None, TP.SeqSplit(384, 2, 0))  # 192 blocks
    assert TP.serve_split(1, 384, 0, gemma, 2)[0] == TP.SeqSplit(384, 2, 0)  # no ssm layer
    assert TP.serve_split(1, 512, 0, mamba, 2)[0].n == 256
    assert TP.serve_split(1, 96, 0, mamba, 2)[0].n == 48
    for D in (1, 2):
        with pytest.raises(ValueError, match="divisible by ssd chunk"):
            TP.serve_split(1, 200, 4, mamba, D)


@pytest.mark.parametrize("window", [None, 5])
def test_causal_attention_from_an_offset_is_the_whole_sequences(window):
    """Each chunk's queries from their offset over the keys up to the
    chunk's end give the whole sequence's causal attention of those rows
    (the sliding window across the chunks' edges)."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 12, 4, 8, generator=gen) for _ in range(3))
    whole = L.causal_attention(q, k[:, :, :2], v[:, :, :2], window=window, q_block=4)
    for a in range(0, 12, 3):
        part = L.causal_attention(q[:, a:a + 3], k[:, :a + 3, :2], v[:, :a + 3, :2],
                                  window=window, q_block=2, q_start=a)
        torch.testing.assert_close(part, whole[:, a:a + 3], rtol=1e-6, atol=1e-6)


def test_init_cache_holds_the_ranks_block_of_slots():
    """A full-attention layer's k / v hold L / D slots of the rank's block;
    the swa ring and a recurrent state stay whole; slots for another L are
    refused."""
    gemma, rg = load_arch("gemma3_1b").SMOKE, load_arch("recurrentgemma_2b").SMOKE
    slots = TP.SeqSplit(40, 4, 1)
    cache = T.init_cache(gemma, 1, 40, slots=slots)
    assert cache["blocks"]["p1"]["k"].shape == (1, 1, 10, 1, gemma.hd)
    assert cache["blocks"]["p0"]["k"].shape == (1, 1, 16, 1, gemma.hd)
    whole = T.init_cache(rg, 1, 40)
    ours = T.init_cache(rg, 1, 40, slots=slots)
    assert all(a.shape == b.shape for a, b in zip(*(
        [t for _, t in convert.flatten_tree(c, is_leaf=lambda x: isinstance(x, torch.Tensor))]
        for c in (whole, ours))))
    with pytest.raises(ValueError, match="slots"):
        T.init_cache(gemma, 1, 36, slots=slots)
