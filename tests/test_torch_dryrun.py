"""The port's input specs and its one-card dry-run against the JAX package's
``configs/specs.py``, on the CPU.

  * ``train_batch_specs`` / ``prefill_batch_specs`` / ``decode_specs`` and
    ``abstract_params``: every leaf's shape and dtype equal the reference's
    ``ShapeDtypeStruct``s (by pytree path; the port's specs are ``meta``
    tensors), for the 13 arch ids and nano, FULL configs, each input shape
    the reference's dry-run admits (``arch_supports_shape``);
    ``param_count`` and ``active_param_count`` equal, and the reference's
    asserts are ``ValueError``s.
  * ``python -m repro_torch.launch.dryrun --smoke`` runs every (arch x
    shape) on meta to ``status: ok``, one record per admitted combination,
    MoE archs included (``layers._host_sizes`` splits the rows evenly on
    meta, which leaves ``grouped_mm``'s FLOPs and bytes as they are).
  * :class:`MemoryTracker` reads the same forward-and-backward high-water
    mark over meta tensors as over real CPU tensors of a SMOKE config.
  * ``"full"`` remat reckons fewer activation bytes than no remat; over
    ranks the reckoning counts the round's collectives and the high-water
    mark of building the state.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import load_arch as j_load_arch
from repro.configs import specs as JSPECS
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, arch_supports_shape, load_arch, specs
from repro_torch.distributed.comm import scaled_sum
from repro_torch.launch import dryrun as DR
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = DR.ALL_ARCHS      # nano, the three GPT-2 sizes, the reference's ARCH_IDS


def _configs(arch):
    if arch == "nano":
        from benchmarks.tables import NANO as J_NANO
        from repro_torch.configs.nano import NANO

        return J_NANO, NANO, j_load_arch("gpt2_small").TOPO, load_arch("gpt2_small").TOPO
    jm, m = j_load_arch(arch), load_arch(arch)
    return jm.FULL, m.FULL, jm.TOPO, m.TOPO


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "") if isinstance(x, torch.Tensor) \
        else np.dtype(x.dtype).name


def _spec_leaves(tree) -> dict:
    """{path: (shape, dtype name)} of a reference SDS tree or a port tree
    of meta tensors."""
    flat = convert.flatten_tree(tree, is_leaf=lambda x: isinstance(x, torch.Tensor)
                                or hasattr(x, "shape") and hasattr(x, "dtype"))
    return {k: (tuple(v.shape), _dtype(v)) for k, v in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    jcfg, cfg, jtopo, topo = _configs(arch)
    theirs = _spec_leaves(JSPECS.abstract_params(jcfg))
    ours = specs.abstract_params(cfg)
    assert all(t.is_meta for t in ours.values())
    assert _spec_leaves(ours) == theirs
    assert specs.param_count(cfg) == JSPECS.param_count(jcfg)
    assert specs.active_param_count(cfg) == JSPECS.active_param_count(jcfg)
    for name, shape in INPUT_SHAPES.items():
        if not arch_supports_shape(cfg, topo, name):
            continue
        jshape = J_INPUT_SHAPES[name]
        if shape.kind == "train":
            W = topo.n_workers_single
            got = specs.train_batch_specs(cfg, topo, shape, W)
            want = JSPECS.train_batch_specs(jcfg, jtopo, jshape, W)
        elif shape.kind == "prefill":
            got = specs.prefill_batch_specs(cfg, shape)
            want = JSPECS.prefill_batch_specs(jcfg, jshape)
        else:
            got = specs.decode_specs(cfg, shape)
            want = JSPECS.decode_specs(jcfg, jshape)
        assert _spec_leaves(got) == _spec_leaves(want), (arch, name)
        assert all(t.is_meta for t in jax.tree.leaves(got)), (arch, name)


def test_specs_refuse_what_the_reference_asserts():
    cfg, topo = load_arch("gpt2_small").FULL, load_arch("gpt2_small").TOPO
    with pytest.raises(ValueError):
        specs.train_batch_specs(cfg, topo, INPUT_SHAPES["prefill_32k"], 8)
    with pytest.raises(ValueError):
        specs.train_batch_specs(cfg, topo, INPUT_SHAPES["train_4k"], 3)
    with pytest.raises(ValueError):
        specs.prefill_batch_specs(cfg, INPUT_SHAPES["decode_32k"])
    with pytest.raises(ValueError):
        specs.decode_specs(cfg, INPUT_SHAPES["train_4k"])


def test_dryrun_runs_every_smoke_combination(tmp_path, capsys):
    recs = DR.main(["--arch", "all", "--shape", "all", "--smoke", "--outdir", str(tmp_path)])
    admitted = [(a, s) for a, s, ok in DR.combinations("all", "all", smoke=True) if ok]
    assert len(recs) == len(admitted) == len(list(tmp_path.iterdir()))
    bad = [(r["arch"], r["shape"], r.get("error")) for r in recs if r["status"] != "ok"]
    assert not bad
    for (arch, shape), rec in zip(admitted, recs):
        on_disk = json.loads((tmp_path / f"{arch}.{shape}.json").read_text())
        assert on_disk["status"] == "ok" and on_disk["arch"] == arch
        assert rec["flops"] > 0 and rec["memory"]["peak_bytes"] > 0
        assert rec["dominant"] in ("compute", "memory") and rec["card"] == DR.CARD
    out = capsys.readouterr().out
    assert out.count("OK ") == len(admitted) and "ERR" not in out
    assert any(r["arch"].startswith("granite_moe") for r in recs)


@pytest.mark.parametrize("arch", ["gpt2_medium", "granite_moe_3b_a800m", "mamba2_780m",
                                  "whisper_large_v3"])
@pytest.mark.parametrize("remat", [False, True])
def test_tracker_reads_meta_as_cpu(arch, remat):
    """The forward-and-backward high-water mark over meta tensors equals
    the one over real CPU tensors (a MoE's group sizes read on the CPU,
    split evenly on meta: the same total rows)."""
    cfg = load_arch(arch).SMOKE
    lay = T.layout(cfg)

    def hwm(device):
        flat = lay.empty(device=device)
        if device == "cpu":
            flat.normal_(generator=torch.Generator().manual_seed(0))
        grad = torch.zeros_like(flat)
        batch = DR._micro(cfg, 2, 32)
        batch = {k: v.to(device) if device == "meta" else
                 (torch.randint(0, cfg.vocab_size, v.shape) if k == "tokens" else
                  torch.randn(v.shape, dtype=v.dtype))
                 for k, v in batch.items()}
        tracker = DR.MemoryTracker()
        with tracker:
            loss = T.loss_fn(lay.autograd_leaves(flat, grad), batch, cfg, remat=remat)
            loss.backward()
            del loss
        return tracker.peak, tracker.live

    assert hwm("meta") == hwm("cpu")


def test_meta_moe_sizes_split_the_rows_evenly():
    assert L._host_sizes(torch.empty(4, device="meta"), 10) == [3, 3, 2, 2]
    assert L._host_sizes(torch.tensor([1, 0, 5]), 6) == [1, 0, 5]


@pytest.mark.parametrize("arch", ["mamba2_780m", "gpt2_small"])
def test_full_remat_reckons_fewer_activation_bytes(arch):
    cfg = load_arch(arch).FULL
    kw = dict(n_workers=2, tau=12, b_micro=1, seq=512)
    plain = DR.reckon_train(cfg, **kw)
    full = DR.reckon_train(cfg, remat=True, **kw)
    dots = DR.reckon_train(cfg, remat=True, remat_policy="dots", **kw)
    assert full["memory"]["local_bytes"] < dots["memory"]["local_bytes"] \
        < plain["memory"]["local_bytes"]
    assert full["memory"]["state_bytes"] == plain["memory"]["state_bytes"]
    # the recompute runs the forward again: more FLOPs
    assert full["flops"] > plain["flops"]


def test_reckoning_over_ranks_counts_the_rounds_collectives():
    """Rank 0 of four, granite SMOKE with bf16 parameters (two dtype
    groups): one scatter and one all-gather per group, the stat sums'
    all-reduce and the losses' gather, as ``CommStats`` counts them."""
    import dataclasses

    cfg = dataclasses.replace(load_arch("granite_moe_3b_a800m").SMOKE, param_dtype="bfloat16")
    rec = DR.reckon_train(cfg, n_workers=4, tau=2, b_micro=2, seq=32, world=4)
    calls = {k: v["calls"] for k, v in rec["comm"].items()}
    assert calls == {"gather_workers": 1, "scatter_rows": 2, "all_reduce_sum": 1,
                     "all_gather_shards": 2}
    dense = DR.reckon_train(cfg, n_workers=4, tau=2, b_micro=2, seq=32)
    assert rec["memory"]["state_bytes"] < dense["memory"]["state_bytes"]
    # dsm_init holds the whole x0 and m until it keeps the rank's shards;
    # the dense state sets no peak while it is built
    assert rec["memory"]["init_bytes"] > rec["memory"]["state_bytes"]
    assert dense["memory"]["peak_bytes"] > dense["memory"]["init_bytes"]


# ---------------------------------------------------------------------------
# The pod meshes (--mesh single | multi | both)
# ---------------------------------------------------------------------------

POD_DENSE = ("nano", "gpt2_small_smoke", "minitron_4b_smoke", "granite_34b_smoke",
             "deepseek_67b_smoke", "gemma3_1b_smoke")


def test_pod_mesh_records(tmp_path, capsys):
    """Every dense arch's train_4k under ``--mesh single`` is ``ok`` (the
    SMOKE configs, and minitron_4b at full width), with the reference's
    fields; so are its serving shapes, on the (data, model) serving grid;
    ``--mesh card`` records are as before."""
    recs = DR.main(["--arch", ",".join(POD_DENSE + ("minitron_4b",)), "--shape", "all",
                    "--mesh", "single", "--outdir", str(tmp_path)])
    train = [r for r in recs if r["shape"] == "train_4k"]
    assert len(train) == len(POD_DENSE) + 1
    for r in train:
        assert r["status"] == "ok", r.get("error")
        assert r["mesh"]["model"] == 16 and r["n_chips"] == 256 and not r["multi_pod"]
        assert r["mesh"]["worker"] * r["mesh"]["zero"] == 16
        assert set(r["collectives"]) == {"all-reduce", "all-gather", "reduce-scatter",
                                         "all-to-all", "collective-permute", "wire_bytes"}
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["t_collective_s"] == r["collectives"]["wire_bytes"] / DR.LINK_BYTES_PER_S
        assert r["link"] == DR.LINK and r["zero_axis"] == DR.ZERO_AXIS
        assert r["zero_axis"].startswith("sharded (FSDP)") and r["fsdp"]
        assert r["fits_per_card"] == (r["memory"]["peak_bytes"] <= DR.CARD_BYTES)
        assert (tmp_path / f"{r['arch']}.train_4k.singlepod.json").exists()
    serving = [r for r in recs if r["shape"] != "train_4k"]
    assert len(serving) == 2 * len(train) + 1         # gemma3 admits long_500k
    for r in serving:
        _assert_serving_record(r, multi=False)
    out = capsys.readouterr().out
    assert "ERR" not in out and out.count("OK ") == len(recs)
    card = DR.main(["--arch", "nano", "--shape", "train_4k", "--outdir", str(tmp_path)])
    assert "mesh" not in card[0] and card[0]["fits_one_card"]
    assert (tmp_path / "nano.train_4k.json").exists()


@pytest.mark.parametrize("arch,multi", [("minitron_4b_smoke", False),
                                        ("granite_34b_smoke", True)])
def test_reckoned_rank_state_is_its_placements_blocks(arch, multi):
    """The reckoned rank's state bytes, to the byte: its zero blocks of its
    blocks (the reference's placements at MODEL_PAR and zero) in bf16 / f32
    params, gradients and AdamW moments per local worker, the kept initial
    x0, its ZeRO chunk of x0 and m over its worker peers (over the (worker,
    zero) ranks where zero is 1), and its round's tokens."""
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import zero as Z
    from repro_torch.launch.train import resolve_arch

    cfg, topo = resolve_arch(arch)
    rec = DR.reckon_pod(arch, "train_4k", multi)
    W = topo.n_workers_multi if multi else topo.n_workers_single
    dims = M.mesh_dims(M.training_mesh(M.make_production_mesh(multi_pod=multi), W))
    lay = T.layout(cfg)
    rep = () if topo.attn_tp else DR.ATTN_NAMES
    specs_ = SH.param_pspecs(dict(zip(lay.names, lay.shapes)), model=dims["model"],
                             zero=dims["zero"], replicate_names=rep)
    n = 0
    for name, shape in zip(lay.names, lay.shapes):
        d, zd = SH.model_dim(specs_[name]), SH.model_dim(specs_[name], "zero")
        n += (int(np.prod(shape)) // (dims["model"] if d is not None else 1)
              // (dims["zero"] if zd is not None else 1))
    p = lay.dtypes[0].itemsize
    w_local = W // dims["worker"]
    chunk = Z.chunk_size(n, dims["worker"])
    assert rec["batch_over_zero"] == (dims["zero"] > 1)
    batch = specs.train_batch_specs(cfg, topo, INPUT_SHAPES["train_4k"], W)["tokens"]
    tokens = w_local * int(np.prod(batch.shape[1:])) * 8
    want = n * w_local * (2 * p + 8) + n * p + chunk * (p + 4) + tokens
    assert rec["memory"]["state_bytes"] == rec["state_bytes_per_rank"] == want


def test_meta_collectives_equal_a_real_run():
    """The reckoning's collectives of one round, per name, kind and group,
    equal rank 0's of a real run of the same step on 4 gloo ranks of
    (worker 2, zero 1, model 2), minitron_4b SMOKE."""
    import sys
    from pathlib import Path

    from repro_torch.distributed.spawn import run_ranks

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_ranks

    cfg = load_arch("minitron_4b").SMOKE
    rec = DR.reckon_train(cfg, n_workers=2, tau=2, b_micro=2, seq=32, world=4, model=2)
    row = T.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 1, 2, 32))
    ranks = run_ranks(torch_ranks.tp_dsm_rank, 4,
                      (cfg, 2, 2, {"zero_sharded": True, "device_parallel_local": True}, row,
                       [{"tokens": tokens}]), timeout_s=300)
    assert ranks[0]["comm"] == rec["comm"]
    assert DR.collectives(ranks[0]["comm"]) == DR.collectives(rec["comm"])


def test_fsdp_meta_state_and_collectives_equal_a_real_run():
    """Under FSDP the reckoning's state bytes and collectives of one round,
    per name and group (``@zero`` too), equal rank 0's of a real run of the
    same step on 4 gloo ranks of (worker 1, zero 2, model 2), minitron_4b
    SMOKE, B_micro 2 over zero."""
    import sys
    from pathlib import Path

    from repro_torch.distributed.spawn import run_ranks

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_ranks

    cfg = load_arch("minitron_4b").SMOKE
    rec = DR.reckon_train(cfg, n_workers=1, tau=2, b_micro=2, seq=32, world=4, model=2,
                          fsdp=True)
    assert rec["batch_over_zero"] and rec["zero"] == 2
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 2, 1, 2, 32))
    case = dict(cfg=cfg, n_workers=1, model=2, fsdp=True, row=T.init_params(
        torch.Generator().manual_seed(0), cfg), batches=[{"tokens": tokens}], gamma=1e-3,
        flags={"zero_sharded": True, "device_parallel_local": True})
    rank0 = run_ranks(torch_ranks.fsdp_dsm_rank, 4, ([case],), timeout_s=300)[0][0]
    assert rank0["comm"] == rec["comm"]
    assert rank0["state_bytes"] == rec["memory"]["state_bytes"]
    plain = DR.reckon_train(cfg, n_workers=1, tau=2, b_micro=2, seq=32, world=4, model=2)
    assert rec["memory"]["state_bytes"] < 0.6 * plain["memory"]["state_bytes"]


def _assert_serving_record(r: dict, multi: bool) -> None:
    """A pod mesh's serving record: ``ok``, rank 0 of (16, 16) or (32, 16)
    with the training records' fields and the serving ones."""
    assert r["status"] == "ok", (r["arch"], r["shape"], r.get("error"))
    assert r["mesh"] == {"data": 32 if multi else 16, "model": 16}
    assert r["n_chips"] == 512 if multi else 256
    assert r["kind"] == INPUT_SHAPES[r["shape"]].kind and r["flops"] > 0
    mem = r["memory"]
    assert set(mem) >= {"params_bytes", "cache_bytes_per_rank", "peak_bytes",
                        "cache_bytes_per_rank_reference_placement"}
    assert mem["peak_bytes"] >= mem["params_bytes"] + mem["cache_bytes_per_rank"] * (
        r["kind"] == "decode")
    assert r["data_axis"] == DR.DATA_AXIS and r["data_axis"].startswith("sharded (FSDP")
    B = INPUT_SHAPES[r["shape"]].global_batch
    assert r["batch_over_data"] == (B % r["mesh"]["data"] == 0)
    assert r["batch_per_rank"] == (B // r["mesh"]["data"] if r["batch_over_data"] else B)
    assert set(r["collectives"]) == {"all-reduce", "all-gather", "reduce-scatter",
                                     "all-to-all", "collective-permute", "wire_bytes"}
    assert r["t_collective_s"] == r["collectives"]["wire_bytes"] / DR.LINK_BYTES_PER_S
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["fits_per_card"] == (mem["peak_bytes"] <= DR.CARD_BYTES)
    # the meta run's collectives are the placement's reckoning, split by
    # heads or not (every SMOKE config's attention at 16 model ranks is not)
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch.train import resolve_arch

    cfg = resolve_arch(r["arch"])[0]
    lay = TP.rank_layout(cfg, r["mesh"]["model"], 0, zero=r["mesh"]["data"],
                         zero_axes=("data",))
    assert mem["params_bytes"] == sum(n * dt.itemsize
                                      for n, dt in zip(lay.group_numels, lay.dtypes))
    # where the batch does not split over data: the prompt's positions and
    # the cache's slots over data where they divide (tensor_parallel.serve_split)
    D, seq = r["mesh"]["data"], r["seq"]
    over = not r["batch_over_data"] and seq % D == 0
    assert r.get("seq_over_data", False) == (over and r["kind"] == "prefill")
    full = any(k.split(":")[0] in ("attn", "xattn") for k in cfg.pattern)
    assert r.get("cache_slots_over_data", False) == (over and full)
    split = TP.SeqSplit(seq, D, 0) if over else None
    call = TP.serve_collectives(cfg, lay, r["batch_per_rank"], seq, r["kind"],
                                chunk=split if r["kind"] == "prefill" else None, slots=split)
    # a prefill on the rank's blocks resolves them first; a decode step
    # runs on params resolved once before it, as generate's steps
    resolve = TP.serve_collectives(cfg, lay, r["batch_per_rank"], r["seq"], "serving_params")
    assert r["comm"] == (scaled_sum((1, resolve), (1, call)) if r["kind"] == "prefill" else call)


def test_pod_serving_records_for_every_arch(tmp_path):
    """prefill_32k and decode_32k under ``--mesh single`` are ``ok`` for every
    arch id (SMOKE configs), and long_500k where the reference admits it."""
    recs = DR.main(["--arch", "all", "--shape", "prefill_32k,decode_32k,long_500k", "--smoke",
                    "--mesh", "single", "--outdir", str(tmp_path)])
    admitted = [(a, s) for a, s, ok in DR.combinations(
        "all", "prefill_32k,decode_32k,long_500k", smoke=True) if ok]
    assert [(r["arch"], r["shape"]) for r in recs] == admitted
    assert {s for _, s in admitted} == {"prefill_32k", "decode_32k", "long_500k"}
    for r in recs:
        _assert_serving_record(r, multi=False)
        assert (tmp_path / f"{r['arch']}.{r['shape']}.singlepod.json").exists()


@pytest.mark.parametrize("arch,shape,multi", [("minitron_4b", "decode_32k", False),
                                              ("granite_34b", "prefill_32k", True),
                                              ("gemma3_1b", "long_500k", False),
                                              ("mamba2_780m", "decode_32k", False)])
def test_serving_record_cache_bytes_are_the_rank_init_cache(arch, shape, multi):
    """A serving record's cache bytes per rank equal the bytes of the rank's
    ``init_cache`` (its rows, its KV heads, a recurrent layer's heads or
    channels) to the byte; the reference placement's equal each leaf's bytes over the mesh
    axes ``cache_pspecs`` puts on it.  minitron_4b at 16 model ranks: its 24
    query heads do not split 16 ways, so every rank computes every head and
    holds all 8 KV heads; granite_34b's one KV head is on every rank (the
    reference splits its head dim instead)."""
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP

    cfg = load_arch(arch).FULL
    rec = DR.reckon_pod(arch, shape, multi)
    dims = M.mesh_dims(M.serving_mesh(M.make_production_mesh(multi_pod=multi)))
    s = INPUT_SHAPES[shape]
    b = rec["batch_per_rank"]
    lay = TP.rank_layout(cfg, dims["model"], 0)
    # a batch that does not split over data: the full-attention slots over it
    slots = (None if rec["batch_over_data"] or s.seq_len % dims["data"]
             else TP.SeqSplit(s.seq_len, dims["data"], 0))
    mine = T.init_cache(cfg, b, s.seq_len, device="meta", layout=lay, slots=slots)
    assert rec["memory"]["cache_bytes_per_rank"] == DR.cache_bytes(mine)
    dense = T.init_cache(cfg, s.global_batch, s.seq_len, device="meta")
    leaves = dict(convert.flatten_tree(dense, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want = 0
    for path, spec in SH.cache_pspecs(dense, dims["data"], dims["model"]).items():
        cut = (dims["data"] if "data" in spec else 1) * (dims["model"] if "model" in spec else 1)
        want += leaves[path].numel() * leaves[path].element_size() // cut
    assert rec["memory"]["cache_bytes_per_rank_reference_placement"] == want
    if arch == "granite_34b":
        assert rec["memory"]["cache_bytes_per_rank"] == 16 * want   # MQA: 1 head, hd / 16
    if arch == "mamba2_780m":
        # its heads' state (the reference cuts N instead: the same bytes) and
        # conv tail of its heads' x channels and every B and C channel (the
        # reference cuts the conv's channels evenly)
        M_, N_ = dims["model"], cfg.ssm_state
        extra = (cfg.n_layers * b * (cfg.conv_width - 1) * 2 * N_ * (M_ - 1) // M_
                 * cfg.act_dtype.itemsize)
        assert rec["memory"]["cache_bytes_per_rank"] == want + extra


def test_meta_serving_collectives_equal_a_real_run():
    """The serving reckoning's collectives (prefill, decode, generate), per
    name and group and per kind, equal rank 0's of a real run of the same
    calls on 4 gloo ranks of (data 2, model 2), minitron_4b SMOKE."""
    import sys
    from pathlib import Path

    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.spawn import run_ranks

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_ranks

    cfg = load_arch("minitron_4b").SMOKE
    Bt, S, steps, new = 4, 16, 2, 3
    rng = np.random.default_rng(0)
    case = {"cfg": cfg, "model": 2, "row": T.init_params(torch.Generator().manual_seed(0), cfg),
            "batch": {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (Bt, S)))},
            "dec_tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (steps, Bt))),
            "new": new, "temperature": 0.0}
    rank0 = run_ranks(torch_ranks.serve_rank, 4, ([case],), timeout_s=300)[0][0]
    prefill = DR.reckon_serve(cfg, "prefill", Bt, S, data=2, model=2)
    decode = DR.reckon_serve(cfg, "decode", Bt, S + new, data=2, model=2)
    gen = DR.reckon_serve(cfg, "generate", Bt, S, data=2, model=2, new=new)
    scaled = {k: {"calls": steps * v["calls"], "bytes": steps * v["bytes"]}
              for k, v in decode["comm"].items()}
    assert rank0["prefill"]["comm"] == prefill["comm"]
    assert rank0["decode"]["comm"] == scaled
    assert rank0["generate"]["comm"] == gen["comm"]
    assert "all_gather@data" in gen["comm"] and "all_reduce_sum@model" in prefill["comm"]
    for ours, theirs in ((rank0["prefill"]["comm"], prefill), (rank0["generate"]["comm"], gen)):
        assert DR.collectives(ours) == DR.collectives(theirs["comm"])
    assert gen["memory"]["cache_bytes_per_rank"] == DR.cache_bytes(T.init_cache(
        cfg, Bt // 2, S + new, layout=TP.rank_layout(cfg, 2, 0)))


# sha256 (first 16 hex digits) of json.dumps({"memory", "comm", "flops"},
# sort_keys=True) of the long_500k single-pod records of the long-context
# archs without a full-attention layer, as DR.reckon_pod gave them at
# commit ae145c5, before a batch that does not split over data put the
# sequence over data
LONG_RECORDS_AT_AE145C5 = {
    "recurrentgemma_2b": "a707ea5abde44d69",
    "mamba2_780m": "96efe3a7132abeaa",
}


def test_long_context_decode_holds_its_block_of_the_global_caches():
    """gemma3_1b long_500k on the single pod (B = 1 over 16 data rows, the
    reference's cache_pspecs fallback): each of its 4 global layers holds
    its block of 524,288 / 16 slots, its 22 window rings whole, so a rank's
    cache falls from 2,159,017,984 B (at ae145c5, every data row the whole
    cache) to 145,752,064; each global layer's decode attention combines
    the blocks over data with one f32 max and one f32 sum of (B, H, 1 + hd);
    recurrentgemma_2b's and mamba2_780m's long_500k records (no
    full-attention layer: nothing of their caches splits) are those of
    ae145c5, to the byte."""
    import hashlib

    from repro_torch.distributed import tensor_parallel as TP

    cfg = load_arch("gemma3_1b").FULL
    n_slots = INPUT_SHAPES["long_500k"].seq_len
    rec = DR.reckon_pod("gemma3_1b", "long_500k", False)
    assert (rec["batch_over_data"], rec["seq_over_data"], rec["cache_slots_over_data"]) == (
        False, False, True)
    n_global = sum(k.startswith("attn") for k in cfg.layer_kinds())
    n_rings = cfg.n_layers - n_global
    assert (n_global, n_rings) == (4, 22)
    kv = 2 * cfg.n_kv_heads * cfg.hd * cfg.act_dtype.itemsize
    assert rec["memory"]["cache_bytes_per_rank"] == (
        n_global * (n_slots // 16) * kv + n_rings * cfg.window * kv) == 145_752_064
    assert rec["memory"]["peak_bytes"] < 2_716_948_192 / 10       # at ae145c5
    H = cfg.n_heads                # 4 heads over 16 model ranks: every rank computes each
    assert rec["comm"]["all_reduce_max@data"] == {"calls": 4, "bytes": 4 * H * 4}
    assert rec["comm"]["all_reduce_sum@data"] == {"calls": 4, "bytes": 4 * H * (1 + cfg.hd) * 4}
    lay = TP.rank_layout(cfg, 16, 0, zero=16, zero_axes=("data",))
    assert rec["comm"] == TP.serve_collectives(cfg, lay, 1, n_slots, "decode",
                                               slots=TP.SeqSplit(n_slots, 16, 0))
    for arch, digest in LONG_RECORDS_AT_AE145C5.items():
        rec = DR.reckon_pod(arch, "long_500k", False)
        keep = {k: rec[k] for k in ("memory", "comm", "flops")}
        assert hashlib.sha256(json.dumps(keep, sort_keys=True).encode()).hexdigest()[:16] == \
            digest, arch
        assert not rec["seq_over_data"] and not rec["cache_slots_over_data"]


def test_a_one_sequence_prefill_runs_its_chunk_over_data():
    """gemma3_1b prefilling one 32,768-token prompt over (data 16, model 16):
    rank 0 runs its 2,048 positions (26 layers' keys and values all-gathered
    over data, the last position's hidden state gathered once), keeps its
    2,048-slot blocks of the global caches beside the whole rings
    (19,922,944 B against 145,752,064 B with every position), and reckons
    its peak at 468,286,160 B (3,436,239,568 at ae145c5, the whole prompt on
    every data row); its collectives are the placement's reckoning."""
    from repro_torch.distributed import tensor_parallel as TP

    cfg = load_arch("gemma3_1b").FULL
    rec = DR.reckon_serve(cfg, "prefill", 1, 32768, data=16, model=16)
    assert rec["seq_over_data"] and rec["cache_slots_over_data"]
    kv = 2 * cfg.n_kv_heads * cfg.hd * cfg.act_dtype.itemsize
    assert rec["memory"]["cache_bytes_per_rank"] == 4 * 2048 * kv + 22 * cfg.window * kv \
        == 19_922_944
    assert rec["memory"]["peak_bytes"] == 468_286_160
    lay = TP.rank_layout(cfg, 16, 0)
    chunk = TP.SeqSplit(32768, 16, 0)
    want = scaled_sum((1, TP.serve_collectives(cfg, lay, 1, 32768, "serving_params")),
                      (1, TP.serve_collectives(cfg, lay, 1, 32768, "prefill", chunk=chunk)))
    assert rec["comm"] == want
    assert rec["comm"]["all_gather@data"] == {
        "calls": cfg.n_layers + 1,
        "bytes": cfg.n_layers * 2048 * kv + cfg.d_model * cfg.act_dtype.itemsize}


# ---------------------------------------------------------------------------
# Sequence parallelism (cfg.attn_seq_shard) on the pod's model axis
# ---------------------------------------------------------------------------

def test_no_registry_config_sets_attn_seq_shard():
    """No registry config sets the flag, so every registry pod record is the
    one reckoned without it (minitron_4b's train_4k constants above still
    hold; the whole ``--mesh both`` set was diffed against the tree before
    the flag was read: unchanged to the byte)."""
    for arch in ARCH_IDS:
        mod = load_arch(arch)
        assert not mod.FULL.attn_seq_shard and not mod.SMOKE.attn_seq_shard, arch


# (arch, TOPO fields replaced): Megatron-SP with attention by heads, and
# gemma3's attention weights whole (attn_tp=False, its one KV head)
SP_PODS = [("minitron_4b", {}), ("gemma3_1b", {}), ("gemma3_1b", {"attn_tp": False})]
SP_POD_IDS = ["minitron_4b", "gemma3_1b", "gemma3_1b-attn_tp_off"]
# sha256 (first 16 hex digits) of json.dumps({"memory", "comm", "flops"},
# sort_keys=True) of the registry's single-pod train_4k records, as
# DR.reckon_pod gave them at commit b19616b, before the flag was read
TRAIN_4K_AT_B19616B = {"minitron_4b": "4f162839d946402c", "gemma3_1b": "b5131f5a53944a04"}


@pytest.mark.parametrize("arch,topo_fields", SP_PODS, ids=SP_POD_IDS)
def test_seq_shard_pod_records_reckon_fewer_activation_bytes(monkeypatch, arch, topo_fields):
    """train_4k on the single pod (model 16, S = 4,096: 256 positions per
    rank): with the flag the rank's local phase (its activations) and its
    peak reckon fewer bytes than without, and its row-parallel outputs are
    reduce-scattered; without it the registry's record is the one reckoned
    before the flag was read, to the byte."""
    import hashlib

    from repro_torch.launch import train as LT

    mod = load_arch(arch)
    topo = dataclasses.replace(mod.TOPO, **topo_fields)
    records = []
    for cfg in (mod.FULL, dataclasses.replace(mod.FULL, attn_seq_shard=True)):
        monkeypatch.setattr(LT, "resolve_arch", lambda name, cfg=cfg: (cfg, topo))
        records.append(DR.reckon_pod(arch, "train_4k", False))
    plain, sp = records
    if not topo_fields:
        keep = {k: plain[k] for k in ("memory", "comm", "flops")}
        assert hashlib.sha256(json.dumps(keep, sort_keys=True).encode()).hexdigest()[:16] == \
            TRAIN_4K_AT_B19616B[arch]
    assert sp["mesh"] == plain["mesh"] and sp["mesh"]["model"] == 16
    assert sp["memory"]["local_bytes"] < plain["memory"]["local_bytes"]
    assert sp["memory"]["peak_bytes"] < plain["memory"]["peak_bytes"]
    assert sp["memory"]["state_bytes"] == plain["memory"]["state_bytes"]
    assert "reduce_scatter@model" in sp["comm"] and "reduce_scatter@model" not in plain["comm"]


# (arch, W, model, leaves held whole)
SP_META = [("minitron_4b", 2, 2, ()), ("gemma3_1b", 1, 4, DR.ATTN_NAMES)]


@pytest.mark.parametrize("arch,W,M,rep", SP_META, ids=["minitron_4b-2x1x2",
                                                        "gemma3_1b-attn_tp_off-1x1x4"])
def test_seq_shard_meta_collectives_equal_a_real_run(arch, W, M, rep):
    """With the flag the reckoning's collectives of one round, per name,
    kind and group, equal rank 0's of a real run of the same DSM step on 4
    gloo ranks: minitron_4b SMOKE over (worker 2, zero 1, model 2) and
    gemma3_1b SMOKE with its attention weights whole over (1, 1, 4)."""
    import sys
    from pathlib import Path

    from repro_torch.distributed.spawn import run_ranks

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_ranks

    cfg = dataclasses.replace(load_arch(arch).SMOKE, attn_seq_shard=True)
    rec = DR.reckon_train(cfg, n_workers=W, tau=2, b_micro=2, seq=32, world=4, model=M,
                          replicate_names=rep)
    row = T.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (W, 2, 1, 2, 32))
    case = dict(cfg=cfg, n_workers=W, model=M, fsdp=False, row=row, gamma=1e-3,
                flags={"zero_sharded": True, "device_parallel_local": True},
                batches=[{"tokens": tokens}], replicate=rep)
    rank0 = run_ranks(torch_ranks.fsdp_dsm_rank, 4, ([case],), timeout_s=300)[0][0]
    assert rank0["comm"] == rec["comm"]
    assert DR.collectives(rank0["comm"]) == DR.collectives(rec["comm"])
    assert "reduce_scatter@model" in rec["comm"]
