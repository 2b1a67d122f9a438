"""Sequence parallelism (``cfg.attn_seq_shard``) inside a prefill whose
sequence also lies over data (``tensor_parallel.serve_split``), against the
JAX package's dense serving and the same grid without the flag, on gloo
ranks on the CPU (``tests/torch_ranks.py::serve_rank``), all f32 at SMOKE
widths.

A batch of B = 1 over (data 2, model 2): data rank d runs its chunk of the
32-token prompt (16 positions, a VLM's 16 patches and 16 tokens), and
within it model rank m runs its block of 8 (``seq_shard`` of the chunk):
the keys and values gathered over the model group, then over the data
group; a recurrence carried over the model group's blocks by the gather,
then across the data group's chunks; the last position's hidden state
from the last model rank of the last data rank.

  * minitron_4b (GQA, attention by heads), gemma3_1b (``swa`` + global
    attention) with its attention by heads and with ``TOPO.attn_tp`` off
    (``wq`` / ``wk`` / ``wv`` / ``wo`` whole on every model rank: the
    block's queries at their offset over every rank's keys and values),
    mamba2_780m (the SSD by heads), recurrentgemma_2b (the RG-LRU by
    channels), llava_next_34b (the patches in data rank 0's chunk) and
    whisper_large_v3 (the encoder whole on every rank).
  * Each rank's prefill logits and cache, ``N_DEC`` teacher-forced decode
    steps and greedy ``generate`` against the JAX package's, within
    ``test_torch_serve_sequence_split.py``'s tolerances.
  * Each rank's prefill cache bit for bit the one the same rank holds
    without the flag.
  * ``CommStats`` per phase equals ``tensor_parallel.serve_collectives``
    to the byte: the model group's reduce-scatters and gathers over the
    rank's block of its chunk, beside the data group's gathers.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.comm import scaled_sum
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch.dryrun import ATTN_NAMES
from repro_torch.train import trainer as TR
from test_torch_serve import _leaves
from test_torch_serve_sequence_split import (N_DEC, _assert_greedy, _assert_rank_cache,
                                             _assert_rank_logits, _split, reference)
from test_torch_tensor_parallel import _torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

D, M, B, S_PROMPT, NEW = 2, 2, 1, 32, 4
# case name -> (arch, leaves held whole on every model rank)
NAMES = {"minitron_4b": ("minitron_4b", ()), "gemma3_1b": ("gemma3_1b", ()),
         "gemma3_1b-attn_tp_off": ("gemma3_1b", ATTN_NAMES),
         "mamba2_780m": ("mamba2_780m", ()), "recurrentgemma_2b": ("recurrentgemma_2b", ()),
         "llava_next_34b": ("llava_next_34b", ()), "whisper_large_v3": ("whisper_large_v3", ())}


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    TR.set_matmul_precision()


def _ref(name: str) -> dict:
    return reference(NAMES[name][0], B, S_PROMPT, NEW)


def _cfg(name: str, flag: bool = True):
    return dataclasses.replace(_ref(name)["cfg"], attn_seq_shard=flag)


@pytest.fixture(scope="module")
def served() -> dict:
    """``{(name, flag): [each rank's serve_rank result]}``: every case with
    and without the flag in one start of the 4 ranks."""
    keys, payload = [], []
    for name, (_, rep) in NAMES.items():
        ref = _ref(name)
        for flag in (True, False):
            keys.append((name, flag))
            payload.append({"cfg": _cfg(name, flag), "model": M, "row": ref["row"],
                            "batch": _torch(ref["batch"]),
                            "dec_tokens": torch.from_numpy(ref["dec"]).long(), "new": NEW,
                            "temperature": 0.0, "replicate": rep})
    res = run_ranks(torch_ranks.serve_rank, D * M, (payload,), timeout_s=600)
    return {k: [r[i] for r in res] for i, k in enumerate(keys)}


@pytest.mark.parametrize("name", list(NAMES))
def test_sp_split_prefill_and_decode_match_jax(served, name):
    ref, cfg = _ref(name), _cfg(name)
    ranks = served[(name, True)]
    assert sorted((r["data_index"], r["model_index"]) for r in ranks) == [
        (d, m) for d in range(D) for m in range(M)]
    arch, rep = NAMES[name]
    _assert_rank_logits(ranks, lambda r: r["prefill"]["logits"], ref["logits"], arch, cfg)
    for i, theirs in enumerate(ref["dec_logits"]):
        _assert_rank_logits(ranks, lambda r: r["decode"]["logits"][i], theirs, arch, cfg)
    for r in ranks:
        assert _split(r["seq"]) == TP.SeqSplit(ref["n0"], D, r["data_index"])
        # the KV heads the rank computes: with attn_tp off every head, as
        # the one model rank of a grid of (data 2, model 1) holds them
        at, heads = (dict(r, model_index=0), 1) if rep else (r, M)
        _assert_rank_cache(r["prefill"]["cache"], ref["cache"], at, arch, cfg, heads)
        _assert_rank_cache(r["decode"]["cache"], ref["dec_cache"], at, arch, cfg, heads)
    _assert_greedy(ranks, ref)


@pytest.mark.parametrize("name", list(NAMES))
def test_sp_split_cache_is_the_grids_without_the_flag(served, name):
    """Each rank's prefill cache, bit for bit, and its logits, within the
    JAX tolerance of them, are those the same rank computes without the
    flag; the greedy tokens are the same."""
    for r, plain in zip(served[(name, True)], served[(name, False)], strict=True):
        assert (r["data_index"], r["model_index"]) == (plain["data_index"], plain["model_index"])
        ours, theirs = _leaves(r["prefill"]["cache"]), _leaves(plain["prefill"]["cache"])
        assert sorted(ours) == sorted(theirs)
        for path, leaf in theirs.items():
            assert ours[path].shape == leaf.shape and ours[path].dtype == leaf.dtype, path
            assert np.array_equal(ours[path].view(np.uint8), leaf.view(np.uint8)), path
        assert torch.equal(r["generate"]["tokens"], plain["generate"]["tokens"])


@pytest.mark.parametrize("name", list(NAMES))
def test_sp_split_collectives_equal_the_reckoning(served, name):
    """Per phase each rank's CommStats equal ``serve_collectives``' with
    the flag and the rank's chunk, to the byte: reduce-scatters over the
    model group where the grid without the flag all-reduces, the data
    group's gathers as without it."""
    ref, cfg = _ref(name), _cfg(name)
    n0, rep = ref["n0"], NAMES[name][1]
    for r in served[(name, True)]:
        seq, slots = _split(r["seq"]), _split(r["slots"])
        lay = TP.rank_layout(cfg, M, r["model_index"], replicate_names=rep)
        assert TP.seq_shard(cfg, lay, seq.n) is not None
        resolve = TP.serve_collectives(cfg, lay, B, n0, "serving_params")
        prefill = TP.serve_collectives(cfg, lay, B, n0, "prefill", chunk=seq)
        decode = TP.serve_collectives(cfg, lay, B, n0, "decode", slots=slots)
        pick = TP.serve_collectives(cfg, lay, B, n0, "pick")
        assert r["prefill"]["comm"] == scaled_sum((1, resolve), (1, prefill))
        assert r["decode"]["comm"] == scaled_sum((N_DEC, decode))
        assert r["generate"]["comm"] == scaled_sum((1, resolve), (1, prefill), (NEW - 1, decode),
                                                   (NEW, pick))
        plain = TP.serve_collectives(_cfg(name, False), lay, B, n0, "prefill", chunk=seq)
        assert "reduce_scatter@model" in prefill and "reduce_scatter@model" not in plain
        assert prefill["all_gather@data"] == plain["all_gather@data"]


def test_prefill_with_sp_and_a_split_over_data_runs():
    """The combination that raised before runs on a lone rank's view of the
    rule: ``seq_shard`` of a chunk cuts the chunk, and a chunk that does
    not divide over the model group stays whole."""
    cfg = _cfg("minitron_4b")
    lay = TP.rank_layout(cfg, M, 1)
    seq, _ = TP.serve_split(1, 32, 4, cfg, D, 1)
    sp = TP.seq_shard(cfg, lay, seq.n)
    assert (seq.start, seq.stop, sp.start, sp.stop) == (16, 32, 8, 16)
    odd, _ = TP.serve_split(1, 30, 4, cfg, D, 1)
    assert odd.n == 15 and TP.seq_shard(cfg, lay, odd.n) is None


@pytest.mark.parametrize("arch", ["minitron_4b", "gemma3_1b", "mamba2_780m"])
def test_dryrun_reckons_sp_inside_a_split_prefill(arch):
    """``dryrun.reckon_serve`` of a one-sequence 1,024-token prefill over
    (data 2, model 2) with the flag, on meta: the prompt's positions over
    data, rank 0's collectives ``serve_collectives``' with the flag and its
    chunk (the params resolved, then the call), and fewer bytes held by the
    call than without the flag (the residual stream of a block of the
    chunk, not the chunk)."""
    from repro_torch.configs import load_arch
    from repro_torch.launch import dryrun as DR

    recs = {}
    for flag in (True, False):
        cfg = dataclasses.replace(load_arch(arch).SMOKE, attn_seq_shard=flag)
        recs[flag] = rec = DR.reckon_serve(cfg, "prefill", 1, 1024, D, M)
        assert rec["seq_over_data"] and not rec["batch_over_data"]
        lay = TP.rank_layout(cfg, M, 0)
        seq, _ = TP.serve_split(1, 1024, 0, cfg, D, 0)
        assert rec["comm"] == scaled_sum(
            (1, TP.serve_collectives(cfg, lay, 1, 1024, "serving_params")),
            (1, TP.serve_collectives(cfg, lay, 1, 1024, "prefill", chunk=seq)))
    assert "reduce_scatter@model" in recs[True]["comm"]
    assert recs[True]["memory"]["call_bytes"] < recs[False]["memory"]["call_bytes"]
