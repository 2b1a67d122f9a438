"""The port's fault injection, survivor-aware DSM step and guards against the
JAX package's (``repro.robustness``, ``repro.core.dsm``), on the CPU, from
the same numpy inputs.

Fault masks are numpy draws in both packages and must agree element for
element.  The survivor-aware outer step is compared round by round with the
kernel tolerances of ``tests/test_kernels.py`` (x: rtol = atol = 1e-5; m:
rtol 1e-5, atol 1e-6) on the reference's quadratic chaos problem, whose
pseudo-gradients sit far from 0, so no sign flips.  Whole nano runs are
compared by their loss history within the 2e-3 of
``test_torch_dsm.py::test_run_training_matches_reference_history``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.tables import NANO as J_NANO
from repro.core import dsm as JD
from repro.core import base_opt as JB
from repro.core import schedules as JS
from repro.data.pipeline import MarkovCorpus as JMarkovCorpus
from repro.models import transformer as JT
from repro.obs import metrics as JM
from repro.robustness import faults as JF
from repro.robustness import guards as JG
from repro.train import trainer as JTR
from repro_torch.configs.nano import NANO
from repro_torch.core import base_opt as B
from repro_torch.core import dsm as D
from repro_torch.core import schedules as S
from repro_torch.data.pipeline import MarkovCorpus
from repro_torch.models import convert
from repro_torch.obs import metrics as M
from repro_torch.robustness import faults as F
from repro_torch.robustness import guards as G
from repro_torch.train import trainer as TR

W, D_QUAD = 4, 24
X_TOL = dict(rtol=1e-5, atol=1e-5)
M_TOL = dict(rtol=1e-5, atol=1e-6)
SPECS = ["drop=0.25,straggle=0.1,nan=0.05,seed=0", "drop=0.3, straggle=0.2, nan=0.1, seed=11",
         "nan=0.5,seed=3", "corrupt=0.4,drop=0.6", ""]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: a pool of threads waiting
    at every op's barrier slows the runs many times over when other test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# FaultSpec / FaultPlan: the reference's draws, element for element
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parse_matches_reference(spec):
    ours, theirs = F.FaultSpec.parse(spec), JF.FaultSpec.parse(spec)
    assert (ours.p_drop, ours.p_straggle, ours.p_corrupt, ours.seed) == (
        theirs.p_drop, theirs.p_straggle, theirs.p_corrupt, theirs.seed)


@pytest.mark.parametrize("bad,match", [("explode=1.0", "unknown fault key"),
                                       ("drop", "bad fault spec"), ("drop=1.5", "lie in")])
def test_fault_spec_rejects_what_the_reference_rejects(bad, match):
    for mod in (F, JF):
        with pytest.raises(ValueError, match=match):
            mod.FaultSpec.parse(bad)


@pytest.mark.parametrize("spec", SPECS[:4])
@pytest.mark.parametrize("n_workers,steps", [(4, 12), (8, 20), (1, 3)])
def test_fault_plan_masks_equal_reference(spec, n_workers, steps):
    ours = F.FaultPlan.from_spec(spec, n_workers, steps)
    theirs = JF.FaultPlan.from_spec(spec, n_workers, steps)
    for name in ("drop", "stale", "corrupt"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)
    assert ours.dropped_frac() == theirs.dropped_frac()
    for t in (0, steps - 1, steps, 99):        # past the horizon: fault-free
        fr, jfr = ours.round(t, "cpu"), theirs.round(t)
        for a, b in zip(fr, jfr):
            assert a.dtype == torch.bool and a.shape == (n_workers,)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # horizon-independent: round t's faults do not depend on the plan's length
    short = F.FaultPlan.from_spec(spec, n_workers, 2)
    np.testing.assert_array_equal(short.corrupt, ours.corrupt[:2])


def _faults(survivors, stale, corrupt):
    """The same round as the port's FaultRound and the reference's."""
    arrs = [np.asarray(a, bool) for a in (survivors, stale, corrupt)]
    return (F.FaultRound(*(torch.from_numpy(a) for a in arrs)),
            JF.FaultRound(*(jnp.asarray(a) for a in arrs)))


def _j(t: torch.Tensor):
    jdt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.float().numpy()).astype(jdt)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_apply_faults_matches_reference(dtype):
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.standard_normal((W, 301)).astype(np.float32)).to(dtype)
    x0 = torch.from_numpy(rng.standard_normal(301).astype(np.float32)).to(dtype)
    fr, jfr = _faults([1, 1, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1])
    out = F.apply_faults(p, x0, fr)
    jout = JF.apply_faults({"x": _j(p)}, {"x": _j(x0)}, jfr)["x"]
    assert out.dtype == dtype and out.shape == p.shape
    np.testing.assert_array_equal(out.float().numpy(), _np(jout))    # NaN where NaN
    np.testing.assert_array_equal(out[1].float().numpy(), x0.float().numpy())
    assert torch.equal(out[0], p[0]) and out[3].isnan().all()


def test_worker_finite_mask_matches_reference():
    p = torch.randn(5, 40, generator=torch.Generator().manual_seed(1))
    p[1, 3], p[3, 39], p[4, 0] = float("nan"), float("inf"), -float("inf")
    np.testing.assert_array_equal(D.worker_finite_mask(p).numpy(),
                                  np.asarray(JD.worker_finite_mask({"x": _j(p)})))
    assert D.worker_finite_mask(p).tolist() == [True, False, True, False, False]


@pytest.mark.parametrize("weights", [[1, 1, 0, 1], [0, 1, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]],
                         ids=["3of4", "1of4", "4of4", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_masked_worker_mean_matches_reference(dtype, weights):
    """3 of 4 survivors with the dropped worker NaN: the division by 3 is
    not exact in bf16, so the order and dtypes must be the reference's.
    Bit for bit: the same IEEE operations on the same values.  Every
    zero-weight worker is NaN."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.standard_normal((W, 4099)).astype(np.float32)).to(dtype)
    p[torch.tensor(weights) == 0] = float("nan")
    w = torch.tensor(weights, dtype=torch.float32)
    out = D.masked_worker_mean(p, w)
    jout = JD.masked_worker_mean({"x": _j(p)}, jnp.asarray(w.numpy()))["x"]
    assert out.dtype == dtype and torch.isfinite(out).all()
    np.testing.assert_array_equal(out.float().numpy(), _np(jout))
    if sum(weights) == 0:
        assert (out == 0).all()


# ---------------------------------------------------------------------------
# The survivor-aware outer step on the reference's chaos problem
# ---------------------------------------------------------------------------

def _quad(n_workers=W, tau=2):
    """The reference's quadratic chaos problem (tests/test_robustness.py) in
    both packages: (loss, batch(t)) for each, and the port's layout."""
    key = jax.random.PRNGKey(7)
    center = jax.random.normal(key, (D_QUAD,))
    tcenter = torch.from_numpy(np.array(center))

    def jloss(params, batch):
        tgt = center + batch["noise"]
        return 0.5 * jnp.mean(jnp.sum((params["x"][None] - tgt) ** 2, axis=-1))

    def loss(p, mb):
        return 0.5 * ((p["x"][None] - (tcenter + mb["noise"])) ** 2).sum(-1).mean()

    def noise(t):
        return 0.1 * jax.random.normal(jax.random.fold_in(key, t), (n_workers, tau, 1, 4, D_QUAD))

    lay = convert.FlatLayout.from_tree({"x": ((D_QUAD,), None)},
                                       is_leaf=lambda x: isinstance(x, tuple))
    return jloss, loss, noise, lay


def _quad_steps(cfg_kw, tau=2, gamma=0.05, base="sgd"):
    jloss, loss, noise, lay = _quad(tau=tau)
    jbase, pbase = getattr(JB, base)(), getattr(B, base)()
    jstep = jax.jit(JD.make_dsm_step(jloss, jbase, JD.DSMConfig(tau=tau, **cfg_kw),
                                     JS.constant(gamma)))
    step = D.make_dsm_step(loss, pbase, D.DSMConfig(tau=tau, **cfg_kw), S.constant(gamma), lay)
    jstate = JD.dsm_init({"x": jnp.zeros((D_QUAD,))}, jbase, W)
    state = D.dsm_init(torch.zeros(D_QUAD), pbase, W)
    return jstep, step, jstate, state, noise


# six rounds: a clean one, each fault alone, drop + corrupt, all dropped
PLAN_ROUNDS = [([1, 1, 1, 1], [0, 0, 0, 0], [0, 0, 0, 0]),
               ([1, 0, 1, 1], [0, 0, 0, 0], [0, 0, 0, 0]),
               ([1, 1, 1, 1], [0, 0, 1, 0], [0, 0, 0, 0]),
               ([1, 1, 1, 1], [0, 0, 0, 0], [0, 1, 0, 0]),
               ([0, 1, 1, 1], [0, 0, 1, 0], [0, 0, 0, 1]),
               ([0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0])]


@pytest.mark.parametrize("source", ["hand", "plan"])
def test_faulted_outer_steps_match_reference(source):
    """Six survivor-aware rounds: every state buffer, the survivors and the
    pack's survivor_frac against the reference's make_dsm_step(faults=...)."""
    jstep, step, jstate, state, noise = _quad_steps(dict(global_lr=0.7), base="adamw")
    plan = F.FaultPlan(W, 6, F.FaultSpec(p_drop=0.4, p_straggle=0.2, p_corrupt=0.3, seed=9))
    jplan = JF.FaultPlan(W, 6, JF.FaultSpec(p_drop=0.4, p_straggle=0.2, p_corrupt=0.3, seed=9))
    for t in range(6):
        if source == "hand":
            fr, jfr = _faults(*PLAN_ROUNDS[t])
        else:
            fr, jfr = plan.round(t, "cpu"), jplan.round(t)
        batch = noise(t)
        jstate, jm = jstep(jstate, {"noise": batch}, None, jfr)
        state, m = step(state, {"noise": torch.from_numpy(np.array(batch))}, None, fr)
        np.testing.assert_allclose(state.x0.numpy(), _np(jstate.x0["x"]), **X_TOL)
        np.testing.assert_allclose(state.m.numpy(), _np(jstate.m["x"]), **M_TOL)
        np.testing.assert_allclose(state.params.numpy(), _np(jstate.params["x"]), **X_TOL)
        np.testing.assert_allclose(state.base_state.m.numpy(), _np(jstate.base_state.m["x"]),
                                   **M_TOL)
        assert (state.t, state.inner) == (int(jstate.t), int(jstate.inner)) == (t + 1, 2 * t + 2)
        assert m["survivors"].item() == float(jm["survivors"])
        want = ((fr.survivors & ~fr.corrupt).sum() / W).item()
        sf = m["pack"][M.IDX["survivor_frac"]].item()
        assert sf == float(jm["pack"][JM.IDX["survivor_frac"]]) == want
        for buf in (state.x0, state.m, state.params, *state.base_state):
            assert torch.isfinite(buf).all(), t
    if source == "plan":
        assert plan.corrupt.any() and plan.drop.any() and plan.stale.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_all_dropped_round_is_skipped_bit_exactly(dtype, monkeypatch):
    """x0 and m bit-untouched, the workers re-synced from x0, t and inner
    advanced; the DSM kernel's wrapper still ran once."""
    _, loss, noise, lay = _quad()
    calls = []
    monkeypatch.setattr(D, "dsm_update", lambda *a, _f=D.dsm_update, **k: (calls.append(1),
                                                                           _f(*a, **k))[1])
    step = D.make_dsm_step(loss, B.adamw(), D.DSMConfig(tau=2, global_lr=0.7), S.constant(0.05),
                           lay)
    state = D.dsm_init(torch.zeros(D_QUAD, dtype=dtype), B.adamw(), W)
    fr, _ = _faults(*PLAN_ROUNDS[0])
    step(state, {"noise": torch.from_numpy(np.array(noise(0))).to(dtype)}, None, fr)
    x0, m = state.x0.clone(), state.m.clone()
    dead, _ = _faults(*PLAN_ROUNDS[5])
    state, metrics = step(state, {"noise": torch.from_numpy(np.array(noise(1))).to(dtype)}, None,
                          dead)
    assert torch.equal(state.x0.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       x0.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(state.m.view(torch.int32), m.view(torch.int32))
    assert torch.equal(state.params, state.x0.expand_as(state.params))
    assert metrics["survivors"].item() == 0.0 and (state.t, state.inner) == (2, 4)
    assert metrics["pack"][M.IDX["survivor_frac"]].item() == 0.0
    assert len(calls) == 2


def test_mask_nonfinite_masks_a_diverged_worker_like_the_reference():
    """No injected faults: worker 1's batch is NaN, so its local phase
    diverges; ``mask_nonfinite`` finds and masks it on the device."""
    assert D.DSMConfig(mask_nonfinite=True).mask_nonfinite
    jstep, step, jstate, state, noise = _quad_steps(dict(global_lr=0.7, mask_nonfinite=True))
    for t in range(3):
        batch = np.array(noise(t))
        batch[1] = np.nan
        jstate, jm = jstep(jstate, {"noise": jnp.asarray(batch)})
        state, m = step(state, {"noise": torch.from_numpy(batch)})
        np.testing.assert_allclose(state.x0.numpy(), _np(jstate.x0["x"]), **X_TOL)
        np.testing.assert_allclose(state.m.numpy(), _np(jstate.m["x"]), **M_TOL)
        assert m["survivors"].item() == float(jm["survivors"]) == 3.0
        assert torch.isfinite(state.x0).all() and torch.isfinite(state.m).all()


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

def _fake_step(state, batch, rng=None, faults=None):
    """The reference test's fake step, in place on the port's tensors."""
    state["x"] += 1.0
    state["m"] += batch["poison"]
    return state, {"loss": batch["loss"]}


def _j_fake_step(state, batch, rng=None, faults=None):
    return {"x": state["x"] + 1.0, "m": state["m"] + batch["poison"]}, {"loss": batch["loss"]}


@pytest.mark.parametrize("losses,spike", [([1.0, 1.1, 10.0, 1.0], 2.0),
                                          ([3.0, 2.0, 2.5, 1.0, 5.0, 1.2], 1.5),
                                          ([1.0, float("nan"), 1.0], 0.0)])
def test_guard_verdicts_match_reference(losses, spike):
    gstep = G.make_guarded_step(_fake_step, nonfinite=True, spike_factor=spike, ema_beta=0.5)
    jgstep = jax.jit(JG.make_guarded_step(_j_fake_step, nonfinite=True, spike_factor=spike,
                                          ema_beta=0.5))
    state, guard = {"x": torch.zeros(3), "m": torch.zeros(3)}, G.init_guard()
    jstate, jguard = {"x": jnp.zeros(3), "m": jnp.zeros(3)}, JG.init_guard()
    for loss in losses:
        state, guard, m = gstep(state, guard, {"loss": torch.tensor(loss),
                                               "poison": torch.tensor(0.0)})
        jstate, jguard, jm = jgstep(jstate, jguard, {"loss": jnp.float32(loss),
                                                     "poison": jnp.float32(0.0)}, None, None)
        assert bool(m["guard_ok"]) == bool(jm["guard_ok"])
        for a, b in zip(guard, jguard):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(state["x"].numpy(), np.asarray(jstate["x"]))
    assert int(guard.skipped) >= 1


def test_guard_skips_nonfinite_update_and_m_is_untouched():
    gstep = G.make_guarded_step(_fake_step, nonfinite=True)
    state, guard = {"x": torch.zeros(3), "m": torch.arange(3.0)}, G.init_guard()
    new_state, guard, metrics = gstep(state, guard, {"loss": torch.tensor(1.0),
                                                     "poison": torch.tensor(float("nan"))})
    assert not bool(metrics["guard_ok"])
    assert torch.equal(new_state["m"], torch.arange(3.0))     # momentum untouched
    assert torch.equal(new_state["x"], torch.zeros(3))
    assert int(guard.bad_streak) == 1 and int(guard.skipped) == 1


def test_guard_rejects_a_dsm_round_and_restores_every_buffer_bit_exactly():
    """A spike factor that rejects the second round: every state tensor, the
    AdamW moments and the host counters t / inner come back bit for bit, and
    the pack carries the verdict."""
    _, loss, noise, lay = _quad()
    step = D.make_dsm_step(loss, B.adamw(), D.DSMConfig(tau=2, global_lr=0.7),
                           S.constant(0.05), lay)
    gstep = G.make_guarded_step(step, nonfinite=True, spike_factor=1e-6)
    state, guard = D.dsm_init(torch.zeros(D_QUAD), B.adamw(), W), G.init_guard()
    state, guard, m = gstep(state, guard, {"noise": torch.from_numpy(np.array(noise(0)))})
    assert bool(m["guard_ok"]) and m["pack"][M.IDX["guard_ok"]].item() == 1.0
    before = [t.clone() for t in G.state_tensors(state)]
    assert len(before) == 5      # params, x0, m, AdamW m and v; not the grads
    state, guard, m = gstep(state, guard, {"noise": torch.from_numpy(np.array(noise(1)))})
    assert not bool(m["guard_ok"]) and m["pack"][M.IDX["guard_ok"]].item() == 0.0
    for a, b in zip(G.state_tensors(state), before):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (state.t, state.inner) == (1, 2)
    assert (int(guard.seen), int(guard.skipped), int(guard.bad_streak)) == (1, 1, 1)


def _nano_settings(mod, **kw):
    base = dict(algorithm="dsm", n_workers=4, tau=2, steps=8, b_micro=2, seq=32,
                eval_every=4)
    return mod.TrainSettings(**{**base, **kw})


def _nano_init():
    jparams = JT.init_params(jax.random.PRNGKey(0), J_NANO)
    return convert.from_jax_numpy(jax.tree.map(np.asarray, jparams), NANO, 1)


def test_guard_rollback_is_bounded_like_the_reference(tmp_path):
    """spike_factor < 1: every round after the first is bad, so both
    packages roll back once and then raise."""
    kw = dict(n_workers=2, guard_spike_factor=0.5, guard_patience=2, guard_max_rollbacks=1,
              checkpoint_every=2)
    logs, jlogs = [], []
    with pytest.raises(RuntimeError, match="training diverged") as ours:
        TR.run_training(NANO, _nano_settings(TR, checkpoint_dir=str(tmp_path / "port"), **kw),
                        MarkovCorpus(NANO.vocab_size, branch=4, seed=7), log=logs.append,
                        device="cpu", params=_nano_init())
    with pytest.raises(RuntimeError, match="training diverged") as theirs:
        JTR.run_training(J_NANO, _nano_settings(JTR, checkpoint_dir=str(tmp_path / "ref"), **kw),
                         JMarkovCorpus(J_NANO.vocab_size, branch=4, seed=7), log=jlogs.append)
    assert str(ours.value) == str(theirs.value)
    roll = [ln for ln in logs if "rollback" in ln]
    assert roll == [ln for ln in jlogs if "rollback" in ln] and roll[0].startswith("rollback #1")


FAULTY_RUNS = [dict(faults="drop=0.25,straggle=0.1,nan=0.2,seed=4", guard_nonfinite=True),
               dict(faults="drop=0.5,nan=0.3,seed=1"),
               dict(mask_nonfinite=True, guard_nonfinite=True, guard_spike_factor=3.0),
               dict(algorithm="signed_lookahead", faults="drop=0.3,straggle=0.3,seed=2")]


@pytest.mark.parametrize("kw", FAULTY_RUNS, ids=lambda k: ",".join(sorted(k)))
def test_run_training_with_faults_and_guards_matches_reference_history(kw):
    """8 outer steps of nano under a fault plan and guards, from the same
    init and batches: loss history and final eval within 2e-3 (the bound of
    test_torch_dsm.py; sign flips move a few coordinates by 2 * eta *
    gamma), the same skipped rounds."""
    run = dict(kw, peak_lr=5e-3, global_lr=0.3)
    jres = JTR.run_training(J_NANO, _nano_settings(JTR, **run))
    res = TR.run_training(NANO, _nano_settings(TR, **run), device="cpu", params=_nano_init())
    assert res["skipped_rounds"] == jres["skipped_rounds"] and res["rollbacks"] == 0
    np.testing.assert_allclose(res["history"], jres["history"], rtol=2e-3)
    np.testing.assert_allclose(res["final_eval"], jres["final_eval"], rtol=2e-3)
    st = res["state"]
    for buf in (st.x0, st.m, st.params, *st.base_state):
        assert torch.isfinite(buf).all()


@pytest.mark.parametrize("algorithm", ["slowmo", "perstep", "mv_signsgd"])
def test_faults_require_dsm_family(algorithm):
    corpus = MarkovCorpus(NANO.vocab_size, branch=4, seed=7)
    with pytest.raises(ValueError, match="DSM step family"):
        TR.run_training(NANO, _nano_settings(TR, algorithm=algorithm, steps=2,
                                             faults="drop=0.5"), corpus, device="cpu")
