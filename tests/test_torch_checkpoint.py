"""The port's checkpoints against the JAX package's (``repro.checkpoint``):
the same npz + json format both ways, atomic rotated saves, dtype- and
shape-checked restores, bit-exact resume of ``run_training``, a
checkpoint of the reference's ``run_training`` carried into the port and
stepped on, and the recurrent models' states (their f32 leaves beside bf16
ones) read by both packages, on the CPU."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.tables import NANO as J_NANO
from repro.checkpoint import checkpoint as JCK
from repro.configs import load_arch as j_load_arch
from repro.core import base_opt as JB
from repro.core import dsm as JD
from repro.core import schedules as JS
from repro.models import transformer as JT
from repro.train import trainer as JTR
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import load_arch
from repro_torch.configs.nano import NANO
from repro_torch.core import base_opt as B
from repro_torch.core import dsm as D
from repro_torch.core import schedules as S
from repro_torch.data.pipeline import MarkovCorpus, dsm_batches
from repro_torch.groups import each
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.robustness import guards as G
from repro_torch.train import trainer as TR

BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: a pool of threads waiting
    at every op's barrier slows the runs many times over when other test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {
        "w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.tensor([1.5, -0.0, 3.1416, 1e-30], dtype=torch.bfloat16),
                   "t": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_trees_equal(a, b):
    fa, fb = CK.flatten(a), CK.flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, (p, x.dtype, y.dtype)
        bits = BITS.get(x.dtype)
        assert torch.equal(x.view(bits), y.view(bits)) if bits else torch.equal(x, y), p


# ---------------------------------------------------------------------------
# single-checkpoint primitives
# ---------------------------------------------------------------------------

def test_bf16_roundtrip_is_bit_exact(tmp_path):
    tree = _tree()
    CK.save(str(tmp_path / "ck"), tree, step=3)
    restored, step = CK.restore(str(tmp_path / "ck"), tree)
    assert step == 3
    _assert_trees_equal(restored, tree)
    keys = CK.load_meta(str(tmp_path / "ck"))["keys"]
    assert ["nested/b", "__bf16__"] in keys and ["nested/t", "int32"] in keys


def test_save_is_complete_and_extra_meta_roundtrips(tmp_path):
    base = str(tmp_path / "ck")
    extra = {"history": [4.5, 4.25], "evals": [[2, 4.3]], "rollbacks": 1}
    CK.save(base, _tree(), step=9, extra=extra)
    assert CK.is_complete(base)
    meta = CK.load_meta(base)
    assert meta["step"] == 9 and meta["extra"] == extra
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]   # no temp left


@pytest.mark.parametrize("drift", ["dtype", "bf16", "shape", "missing"])
def test_restore_rejects_drift(tmp_path, drift):
    base = str(tmp_path / "ck")
    CK.save(base, _tree())
    like = _tree()
    if drift == "dtype":
        like["w"] = like["w"].to(torch.int32)
        err, match = ValueError, "dtype mismatch for w"
    elif drift == "bf16":
        like["nested"]["b"] = like["nested"]["b"].float()
        err, match = ValueError, "dtype mismatch for nested/b"
    elif drift == "shape":
        like["w"] = torch.zeros(3, 2)
        err, match = ValueError, "shape mismatch for w"
    else:
        like["nested"]["extra"] = torch.zeros(1)
        err, match = KeyError, "missing leaf nested/extra"
    with pytest.raises(err, match=match):
        CK.restore(base, like)


def test_torn_write_is_ignored(tmp_path):
    d = str(tmp_path)
    CK.save_checkpoint(d, _tree(), 1)
    # a kill between the npz and its json, and a stray temp file
    CK.save(CK.step_path(d, 2), _tree(), step=2)
    os.remove(CK.step_path(d, 2) + ".json")
    open(CK.step_path(d, 3) + ".npz.tmp.123", "wb").close()
    assert [s for s, _ in CK.list_checkpoints(d)] == [1]
    assert CK.latest_checkpoint(d) == CK.step_path(d, 1)
    _, step, _ = CK.restore_latest(d, _tree())
    assert step == 1


def test_retention_keeps_newest_and_repoints_latest(tmp_path):
    d = str(tmp_path)
    for step in range(5):
        CK.save_checkpoint(d, _tree(), step, keep=2)
    assert [s for s, _ in CK.list_checkpoints(d)] == [3, 4]
    with open(os.path.join(d, "latest")) as f:
        assert f.read() == "ckpt_00000004"


def test_latest_pointer_falls_back_to_scan(tmp_path):
    d = str(tmp_path)
    CK.save_checkpoint(d, _tree(), 5)
    CK.save_checkpoint(d, _tree(), 6)
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("ckpt_00000099")                      # stale pointer
    assert CK.latest_checkpoint(d) == CK.step_path(d, 6)
    os.remove(os.path.join(d, "latest"))              # no pointer at all
    assert CK.latest_checkpoint(d) == CK.step_path(d, 6)


def test_restore_latest_empty_dir(tmp_path):
    assert CK.latest_checkpoint(str(tmp_path)) is None
    assert CK.restore_latest(str(tmp_path), _tree()) is None


def _jax_tree():
    return {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "nested": {"b": jnp.asarray([1.5, -0.0, 3.1416, 1e-30], jnp.bfloat16),
                       "t": jnp.asarray(7, jnp.int32)}}


def test_port_restores_a_reference_file_bit_exactly(tmp_path):
    base = str(tmp_path / "ref")
    JCK.save(base, _jax_tree(), step=4, extra={"history": [1.0]})
    restored, step = CK.restore(base, _tree())
    assert step == 4 and CK.load_meta(base)["extra"] == {"history": [1.0]}
    _assert_trees_equal(restored, _tree())


def test_reference_restores_a_port_file_bit_exactly(tmp_path):
    base = str(tmp_path / "port")
    CK.save(base, _tree(), step=2)
    restored, step = JCK.restore(base, _jax_tree())
    assert step == 2
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(_jax_tree())):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))


# ---------------------------------------------------------------------------
# whole training states
# ---------------------------------------------------------------------------

def _jax_init():
    return JT.init_params(jax.random.PRNGKey(0), J_NANO)


def _port_init():
    return convert.from_jax_numpy(jax.tree.map(np.asarray, _jax_init()), NANO, 1)


def _flat_jax(tree, n_workers=None) -> np.ndarray:
    leaves = [np.asarray(v, np.float32) for _, v in convert.flatten_tree(
        jax.tree.map(np.asarray, tree), is_leaf=lambda x: isinstance(x, np.ndarray))]
    if n_workers is None:
        return np.concatenate([v.ravel() for v in leaves])
    return np.concatenate([v.reshape(n_workers, -1) for v in leaves], axis=1)


def _settings(mod, **kw):
    base = dict(n_workers=4, tau=2, steps=8, b_micro=2, seq=32, eval_every=2,
                peak_lr=5e-3, global_lr=0.3)
    return mod.TrainSettings(**{**base, **kw})


def test_dsm_state_tree_has_the_reference_paths():
    state = D.dsm_init(_port_init()[0], B.adamw(), 4)
    ours = {p for p, _ in CK.flatten(convert.state_to_tree(state, NANO))}
    jstate = JD.dsm_init(_jax_init(), JB.adamw(), 4)
    theirs = {JCK._path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert ours == theirs and "base_state/v/decoder/blocks/p0/mlp/w1" in ours


def test_reference_restores_the_port_state_subtree(tmp_path):
    """The reference's checkpoint.restore reads a checkpoint of the port's
    run_training into its own DSMState, every leaf bit for bit."""
    d = str(tmp_path)
    res = TR.run_training(NANO, _settings(TR, steps=2, checkpoint_dir=d, checkpoint_every=2,
                                          guard_nonfinite=True),
                          device="cpu", params=_port_init())
    like = {"state": JD.dsm_init(_jax_init(), JB.adamw(), 4)}
    tree, step, extra = JCK.restore_latest(d, like)
    st, jst = res["state"], tree["state"]
    assert step == 2 and extra["history"] == res["history"]
    assert (int(jst.t), int(jst.inner)) == (st.t, st.inner) == (2, 4)
    np.testing.assert_array_equal(_flat_jax(jst.x0), st.x0.numpy())
    np.testing.assert_array_equal(_flat_jax(jst.m), st.m.numpy())
    np.testing.assert_array_equal(_flat_jax(jst.params, 4), st.params.numpy())
    np.testing.assert_array_equal(_flat_jax(jst.base_state.v, 4), st.base_state.v.numpy())
    meta = JCK.load_meta(os.path.join(d, "ckpt_00000002"))
    assert {k for k, _ in meta["keys"]} >= {"rng", "guard/ema", "guard/skipped", "state/t"}


def _assert_close_with_flips(ours, theirs, rtol, atol, flip_size, max_flips, what):
    """Elementwise close, except at most ``max_flips`` coordinates that may
    differ by up to ``flip_size`` (a flipped sign; see test_torch_dsm.py)."""
    diff = np.abs(ours - theirs)
    bad = diff > atol + rtol * np.abs(theirs)
    assert bad.sum() <= max_flips, f"{what}: {bad.sum()} coordinates differ"
    assert (diff[bad] <= flip_size * 1.001).all(), f"{what}: max diff {diff.max()}"


def test_reference_checkpoint_restores_into_the_port_and_steps_on(tmp_path):
    """The reference's run_training(checkpoint_dir=...) at f32 writes step 2;
    convert.state_from_tree carries it into the port bit for bit, and one
    further outer step matches the reference's next step within the
    tolerances of test_torch_dsm.py (kernel tolerances plus a budget of
    flipped signs of size 2 * eta * gamma)."""
    d = str(tmp_path)
    tau, w, steps = 2, 4, 2
    JTR.run_training(J_NANO, _settings(JTR, steps=steps, checkpoint_dir=d,
                                       checkpoint_every=steps))
    jbase, base = JB.adamw(), B.adamw()
    like = {"state": convert.state_to_tree(
        D.dsm_init(torch.zeros(T.layout(NANO).numel), base, w), NANO)}
    tree, step, _ = CK.restore_latest(d, like)
    state = convert.state_from_tree(tree["state"], NANO, base, w, "cpu")
    jtree, _, _ = JCK.restore_latest(d, {"state": JD.dsm_init(_jax_init(), jbase, w)})
    jstate = jtree["state"]
    assert step == steps and (state.t, state.inner) == (int(jstate.t), int(jstate.inner))
    np.testing.assert_array_equal(state.x0.numpy(), _flat_jax(jstate.x0))
    np.testing.assert_array_equal(state.params.numpy(), _flat_jax(jstate.params, w))
    np.testing.assert_array_equal(state.base_state.m.numpy(), _flat_jax(jstate.base_state.m, w))

    s = _settings(JTR, steps=steps)
    jstep = jax.jit(JD.make_dsm_step(
        lambda p, mb: JT.loss_fn(p, mb, J_NANO, remat=False), jbase,
        JD.DSMConfig(tau=tau, global_lr=s.global_lr),
        JS.cosine_with_warmup(s.peak_lr, steps, warmup_steps=s.warmup)))
    step_fn = D.make_dsm_step(lambda p, mb: T.loss_fn(p, mb, NANO), base,
                              D.DSMConfig(tau=tau, global_lr=s.global_lr),
                              S.cosine_with_warmup(s.peak_lr, steps, warmup_steps=s.warmup),
                              T.layout(NANO))
    batches = dsm_batches(MarkovCorpus(NANO.vocab_size, seed=1), w, tau, 1, s.b_micro, s.seq,
                          seed=s.seed)
    for _ in range(steps):
        next(batches)
    tokens = next(batches)["tokens"]
    jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
    state, m = step_fn(state, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    flip = 2 * np.float32(s.global_lr) * np.float32(jm["gamma"])
    n = T.layout(NANO).numel
    _assert_close_with_flips(state.x0.numpy(), _flat_jax(jstate.x0), 1e-5, 1e-5, flip,
                             max_flips=n // 1000, what="x0")
    _assert_close_with_flips(state.m.numpy(), _flat_jax(jstate.m), 1e-4, 1e-5,
                             (1 - 0.98) * 2 * tau * (steps + 1), max_flips=n // 1000, what="m")
    np.testing.assert_allclose(state.base_state.v.numpy(), _flat_jax(jstate.base_state.v, w),
                               rtol=1e-4, atol=1e-9)
    assert state.t == int(jstate.t) == steps + 1


RESUME_RUNS = [dict(), dict(faults="drop=0.25,nan=0.2,seed=4", guard_nonfinite=True),
               dict(sign_mode="rand_pm"), dict(base_opt="sophia"), dict(base_opt="sgd"),
               dict(algorithm="global_adamw"), dict(algorithm="perstep"),
               dict(algorithm="mv_signsgd")]


@pytest.mark.parametrize("kw", RESUME_RUNS, ids=lambda k: ",".join(f"{a}={b}" for a, b in
                                                                   k.items()) or "dsm")
def test_kill_and_resume_is_bit_exact(tmp_path, kw):
    """Stop at step 4 of 8 (checkpoints every 2), resume: the history,
    evals, every state buffer and the generator's state equal the
    uninterrupted run's bit for bit."""
    d = str(tmp_path)
    ref = TR.run_training(NANO, _settings(TR, **kw), device="cpu", params=_port_init())
    TR.run_training(NANO, _settings(TR, steps=4, checkpoint_dir=d, checkpoint_every=2, **kw),
                    device="cpu", params=_port_init())
    res = TR.run_training(NANO, _settings(TR, checkpoint_dir=d, checkpoint_every=2, resume=True,
                                          **kw), device="cpu", params=_port_init())
    assert res["restore_s"] is not None and len(res["checkpoint_s"]) == 2    # steps 6, 8
    assert res["history"] == ref["history"] and res["eval_losses"] == ref["eval_losses"]
    for a, b in zip(G.state_tensors(res["state"]), G.state_tensors(ref["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launcher_faulted_guarded_checkpointed_run_resumes(tmp_path, capsys):
    """The launcher's robustness flags: 4 steps with checkpoints, then the
    same command with --resume to 6 steps, equal to an uninterrupted 6-step
    run; --checkpoint writes the final global params in the reference's
    format."""
    from repro_torch.launch import train as launch

    cmd = ["--device", "cpu", "--faults", "drop=0.25,straggle=0.1,nan=0.05,seed=0",
           "--guard-nonfinite", "--tau", "2", "--n-workers", "2", "--seq", "32",
           "--b-micro", "2"]
    d = str(tmp_path / "ck")
    launch.main(cmd + ["--steps", "4", "--checkpoint-dir", d])
    assert [s for s, _ in CK.list_checkpoints(d)][-1] == 4
    capsys.readouterr()
    res = launch.main(cmd + ["--steps", "6", "--checkpoint-dir", d, "--resume",
                             "--checkpoint", str(tmp_path / "final")])
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 4" in out and "skipped rounds: 0" in out
    ref = launch.main(cmd + ["--steps", "6"])
    assert res["history"] == ref["history"]
    params, step = JCK.restore(str(tmp_path / "final"), _jax_init())
    assert step == 6
    np.testing.assert_array_equal(_flat_jax(params), res["state"].x0.numpy())
    with open(str(tmp_path / "final") + ".json") as f:
        assert len(json.load(f)["keys"]) == len(T.layout(NANO).names)


# ---------------------------------------------------------------------------
# A mixed-dtype state: granite_moe SMOKE with bf16 parameters, its routers
# f32 (two dtype groups)
# ---------------------------------------------------------------------------

MIXED = dataclasses.replace(load_arch("granite_moe_3b_a800m").SMOKE, param_dtype="bfloat16",
                            name="granite_moe_smoke_bf16_params")
MIXED_RESUME_RUNS = [dict(), dict(faults="drop=0.25,nan=0.2,seed=4", guard_nonfinite=True),
                     dict(algorithm="global_adamw"), dict(base_opt="momentum")]


def _mixed_settings(**kw):
    base = dict(n_workers=2, tau=2, steps=4, b_micro=1, seq=16, eval_every=2, eval_batch=2,
                peak_lr=5e-3, global_lr=0.3)
    return TR.TrainSettings(**{**base, **kw})


def _mixed_init():
    return T.init_params(torch.Generator().manual_seed(0), MIXED)


def test_mixed_dtype_state_roundtrip_keeps_each_leaf_dtype(tmp_path):
    """After one DSM outer step: ``state_to_tree`` -> save -> restore ->
    ``load_state_tree`` into a fresh state is bit-equal in every buffer;
    the file holds each router leaf of params and x0 as float32 and every
    other param-dtype leaf as bf16, m and the AdamW moments as float32; a
    file whose router is bf16 is refused."""
    lay = T.layout(MIXED)
    base = B.adamw()
    step = D.make_dsm_step(lambda p, mb: T.loss_fn(p, mb, MIXED), base, D.DSMConfig(tau=2),
                           S.constant(1e-3), lay)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, MIXED.vocab_size,
                                                                (2, 2, 1, 1, 16)))
    state, _ = step(D.dsm_init(_mixed_init(), base, 2), {"tokens": tokens})
    path = str(tmp_path / "mixed")
    CK.save(path, convert.state_to_tree(state, MIXED), step=1)
    with open(path + ".json") as f:
        tags = dict(json.load(f)["keys"])
    for key, tag in tags.items():
        field, leaf = key.split("/", 1)[0], key.rsplit("/", 1)[-1]
        want = ("float32" if field in ("m", "base_state") or leaf == "router" else "__bf16__")
        assert tag == (want if field != "t" and field != "inner" else "int32"), key
    fresh = D.dsm_init(each(torch.zeros_like, _mixed_init()), base, 2)
    tree, _ = CK.restore(path, convert.state_to_tree(fresh, MIXED))
    convert.load_state_tree(fresh, tree, MIXED)
    assert fresh.t == state.t and fresh.inner == state.inner
    for a, b in zip(G.state_tensors(fresh), G.state_tensors(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tree["x0"]["decoder/blocks/p0/moe/router"] = tree["x0"]["decoder/blocks/p0/moe/router"].to(
        torch.bfloat16)
    with pytest.raises(ValueError, match="router"):
        convert.load_state_tree(fresh, tree, MIXED)


@pytest.mark.parametrize("kw", MIXED_RESUME_RUNS, ids=lambda k: ",".join(
    f"{a}={b}" for a, b in k.items()) or "dsm")
def test_mixed_dtype_kill_and_resume_is_bit_exact(tmp_path, kw):
    """The mixed-dtype model stopped at step 2 of 4 (checkpoints every 2)
    and resumed: history, evals and every state buffer equal the
    uninterrupted run's bit for bit."""
    d = str(tmp_path)
    ref = TR.run_training(MIXED, _mixed_settings(**kw), device="cpu", params=_mixed_init())
    TR.run_training(MIXED, _mixed_settings(steps=2, checkpoint_dir=d, checkpoint_every=2, **kw),
                    device="cpu", params=_mixed_init())
    res = TR.run_training(MIXED, _mixed_settings(checkpoint_dir=d, checkpoint_every=2,
                                                 resume=True, **kw),
                          device="cpu", params=_mixed_init())
    assert res["restore_s"] is not None
    assert res["history"] == ref["history"] and res["eval_losses"] == ref["eval_losses"]
    tensors = G.state_tensors(res["state"])
    assert {t.dtype for t in tensors if t.is_floating_point()} >= {torch.bfloat16, torch.float32}
    for a, b in zip(tensors, G.state_tensors(ref["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch,f32_leaves", [("mamba2_780m", {"A_log", "D", "dt_bias"}),
                                             ("recurrentgemma_2b", {"lam"})])
def test_recurrent_state_roundtrips_in_both_packages(tmp_path, arch, f32_leaves):
    """A recurrent SMOKE with bf16 parameters (its f32 leaves in a second
    dtype group) after one DSM outer step: the port's checkpoint holds those
    leaves of params and x0 as float32 and every other param leaf as bf16;
    the port restores it into a fresh state bit-equal in every buffer, and
    the reference's ``checkpoint.restore`` reads it into its own DSMState,
    every leaf bit for bit."""
    kw = dict(param_dtype="bfloat16", name=f"{arch}_smoke_bf16_params")
    jcfg = dataclasses.replace(j_load_arch(arch).SMOKE, **kw)
    cfg = dataclasses.replace(load_arch(arch).SMOKE, **kw)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    x0 = each(lambda t: t[0], convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, 1))
    lay, base = T.layout(cfg), B.adamw()
    assert lay.n_groups == 2
    step = D.make_dsm_step(lambda p, mb: T.loss_fn(p, mb, cfg), base, D.DSMConfig(tau=2),
                           S.constant(1e-3), lay)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                (2, 2, 1, 1, 16)))
    state, _ = step(D.dsm_init(x0, base, 2), {"tokens": tokens})
    path = str(tmp_path / arch)
    CK.save(path, convert.state_to_tree(state, cfg), step=1)
    with open(path + ".json") as f:
        for key, tag in json.load(f)["keys"]:
            field, leaf = key.split("/", 1)[0], key.rsplit("/", 1)[-1]
            want = ("int32" if field in ("t", "inner") else "float32"
                    if field in ("m", "base_state") or leaf in f32_leaves else "__bf16__")
            assert tag == want, key
    fresh = D.dsm_init(each(torch.zeros_like, x0), base, 2)
    tree, _ = CK.restore(path, convert.state_to_tree(fresh, cfg))
    convert.load_state_tree(fresh, tree, cfg)
    for a, b in zip(G.state_tensors(fresh), G.state_tensors(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jstate, _ = JCK.restore(path, JD.dsm_init(jp, JB.adamw(), n_workers=2))
    for field in ("x0", "m"):
        ours = lay.views(getattr(state, field))
        for name, leaf in convert.flatten_tree(jax.tree.map(np.asarray, getattr(jstate, field)),
                                               is_leaf=lambda x: isinstance(x, np.ndarray)):
            assert str(ours[name].dtype).removeprefix("torch.") == str(leaf.dtype), name
            np.testing.assert_array_equal(ours[name].float().numpy(), leaf.astype(np.float32),
                                          err_msg=f"{field} {name}")
