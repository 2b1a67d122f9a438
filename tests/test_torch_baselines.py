"""The port's baselines, randomized signs and algorithm wiring against the
JAX package's, on nano on the CPU, from the same init (``T.init_params``
through ``from_jax_numpy``) and the same batches.

Tolerances, and why:
  * one step of a global update or of MV-signSGD: the port and the
    reference do the same f32 operations in the same order on the worker
    mean; what differs is the local phase's backward, whose sums run in
    another order.  So x0 within rtol 1e-5 / atol 1e-6; buffers of
    gradients within 3e-5 of their largest magnitude (the gradient bound of
    tests/test_torch_model.py); buffers of pseudo-gradients, which divide
    x's ulps by gamma, within rtol 1e-4 / atol 1e-4 of their largest
    magnitude.  AdamW's first local steps are sign-like (m_hat / sqrt(v_hat)
    = g / |g|), so a gradient within rounding of 0 can move a worker's
    coordinate by up to 2 * gamma, and a sign of x0 - x_tau within rounding
    of 0 can flip; at most 0.1% of coordinates may differ by such a flip.
  * the randomized signs from the reference's own uniforms: the kernel
    tolerances (x rtol 1e-5 / atol 1e-5, m atol 1e-6).
  * trajectories: the loss history within 2e-3 relative, as
    tests/test_torch_dsm.py states for DSM.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.tables import NANO as J_NANO
from repro.core import base_opt as JB
from repro.core import baselines as JBL
from repro.core import dsm as JD
from repro.core import schedules as JS
from repro.models import transformer as JT
from repro.train import trainer as JTR
from repro_torch.configs.nano import NANO
from repro_torch.core import base_opt as B
from repro_torch.core import baselines as BL
from repro_torch.core import dsm as D
from repro_torch.core import schedules as S
from repro_torch.data.pipeline import MarkovCorpus, dsm_batches
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR

W, TAU, BM, SEQ = 2, 2, 2, 32
ETA = 5e-3
SCHED = dict(total_steps=40, warmup_steps=4)
# the paper's settings of each baseline's global step (benchmarks/tables.py)
LOCAL_KW = {"slowmo": dict(beta=0.5, alpha=1.0), "signed_slowmo": dict(beta=0.5, eta=0.02),
            "lookahead": dict(beta=0.2, eta=1.0), "global_adamw": dict(eta=1.0),
            "local_avg": {}}


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    """No TF32 anywhere the tests might reach a card (as run_training sets)."""
    TR.set_matmul_precision()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Nano-sized tensors gain nothing from intra-op threads, and under a
    parallel test run each worker's 8 OpenMP threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_jax(tree, n_workers=None) -> np.ndarray:
    """A JAX param-shaped tree as the port's flat layout ((W, N) or (N,))."""
    leaves = [np.asarray(v, np.float32) for _, v in convert.flatten_tree(
        jax.tree.map(np.asarray, tree), is_leaf=lambda x: isinstance(x, np.ndarray))]
    if n_workers is None:
        return np.concatenate([v.ravel() for v in leaves])
    return np.concatenate([v.reshape(n_workers, -1) for v in leaves], axis=1)


def _close(ours, theirs, rtol, atol_frac, what, flips=0.0):
    """Within rtol and ``atol_frac`` of the largest magnitude, except at most
    0.1% of coordinates that may differ by up to ``flips``."""
    ours, theirs = np.asarray(ours, np.float32), np.asarray(theirs, np.float32)
    diff = np.abs(ours - theirs)
    bad = diff > atol_frac * np.abs(theirs).max() + rtol * np.abs(theirs)
    assert bad.sum() <= theirs.size // 1000, f"{what}: {bad.sum()} coordinates differ"
    assert (diff[bad] <= flips * 1.001).all(), f"{what}: max diff {diff.max()}"


def _jax_loss(p, mb):
    return JT.loss_fn(p, mb, J_NANO, remat=False)


def _loss(p, mb):
    return T.loss_fn(p, mb, NANO)


def _init():
    jparams = JT.init_params(jax.random.PRNGKey(0), J_NANO)
    return jparams, convert.from_jax_numpy(jax.tree.map(np.asarray, jparams), NANO, 1)[0]


def _batches():
    return dsm_batches(MarkovCorpus(NANO.vocab_size, seed=1), W, TAU, 1, BM, SEQ, seed=0)


@pytest.mark.parametrize("method", list(LOCAL_KW))
def test_local_step_method_matches_reference(method):
    """Two outer steps (the second reads the carried global state) of each
    local-step method with AdamW local steps, against the reference's
    ``make_local_step_method``, run eagerly."""
    jparams, x0 = _init()
    kw = LOCAL_KW[method]
    jinit, jstep = getattr(JBL, method)(_jax_loss, JB.adamw(), TAU,
                                        JS.cosine_with_warmup(ETA, **SCHED), **kw)
    init, step = BL.LOCAL_METHODS[method](_loss, B.adamw(), TAU,
                                          S.cosine_with_warmup(ETA, **SCHED), T.layout(NANO),
                                          **kw)
    jstate, state = jinit(jparams, W), init(x0, W)
    batches = _batches()
    for t in range(2):
        tokens = next(batches)["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens[:, :, 0])})
        state, m = step(state, {"tokens": torch.from_numpy(tokens).long()})
        gamma = float(jm["gamma"])
        assert m["gamma"].item() == gamma
        assert (state.t, state.inner) == (int(jstate.t), int(jstate.inner))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        # a flipped local AdamW step moves the worker mean by 2 gamma / W per
        # local step; each method scales that into x0 and its momentum
        x_flip = {"slowmo": 2 * TAU * gamma, "lookahead": 2 * TAU * gamma,
                  "local_avg": 2 * TAU * gamma, "global_adamw": 2 * gamma,
                  "signed_slowmo": 2 * 0.02 * 0.5}[method] * (t + 1)
        _close(state.x0.numpy(), _flat_jax(jstate.x0), 1e-5, 1e-6, f"x0 step {t}", x_flip)
        np.testing.assert_array_equal(state.params.numpy(),
                                      np.broadcast_to(state.x0.numpy(), state.params.shape))
        jaux = [jstate.aux] if isinstance(state.aux, torch.Tensor) else list(jstate.aux)
        assert len(B._buffers(state.aux)) == len(jaux)
        for ours, theirs in zip(B._buffers(state.aux), jaux):
            theirs = _flat_jax(theirs)
            _close(ours.numpy(), theirs, 1e-4, 1e-4, f"aux step {t}",
                   flips=np.abs(theirs).max())
        _close(state.base_state.m.numpy(), _flat_jax(jstate.base_state.m, W), 0.0, 3e-5,
               f"AdamW m step {t}")


def _mv_uniforms(key, m_tree) -> torch.Tensor:
    """The reference's MV-signSGD draws (``baselines.py:341-345``) as the
    port's (W, N) flat layout."""
    leaves = jax.tree.leaves(m_tree)
    keys = jax.random.split(key, len(leaves))
    rows = [jax.vmap(lambda kk: jax.random.uniform(kk, leaf.shape[1:], dtype=leaf.dtype))(
        jax.random.split(k, leaf.shape[0])).reshape(leaf.shape[0], -1)
        for leaf, k in zip(leaves, keys)]
    return torch.from_numpy(np.concatenate([np.asarray(r) for r in rows], axis=1))


def test_mv_signsgd_matches_reference_from_its_uniforms():
    """Two outer steps of Alg. 6 (the second extrapolates from x_prev) with
    the reference's own uniforms laid out in the flat order."""
    jparams, x0 = _init()
    kw = dict(gamma=ETA, eta=0.3 * ETA, beta=0.5, bound=1.0)
    jinit, jstep = JBL.make_mv_signsgd_step(_jax_loss, TAU, **kw)
    jstep = jax.jit(jstep)
    init, step = BL.make_mv_signsgd_step(_loss, TAU, layout=T.layout(NANO), **kw)
    jstate, state = jinit(jparams, W), init(x0, W)
    batches = _batches()
    for t in range(2):
        tokens = next(batches)["tokens"]
        key = jax.random.PRNGKey(100 + t)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens[:, :, 0])}, key)
        state, m = step(state, {"tokens": torch.from_numpy(tokens).long()},
                        uniform=_mv_uniforms(key, jstate.m))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        _close(state.m.numpy(), _flat_jax(jstate.m, W), 0.0, 3e-5, f"m step {t}")
        # x moves by exactly eta per coordinate: any disagreement is a flipped vote
        _close(state.x.numpy(), _flat_jax(jstate.x), 1e-5, 1e-6, f"x step {t}",
               flips=2 * 0.3 * ETA)
        _close(state.x_prev.numpy(), _flat_jax(jstate.x_prev), 1e-5, 1e-6, f"x_prev step {t}",
               flips=2 * 0.3 * ETA)
        assert state.t == int(jstate.t) == t + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["rand_pm", "rand_zero"])
def test_randomized_global_step_matches_reference_from_its_uniforms(mode, dtype):
    """One global step over a three-leaf tree, the reference's per-leaf key
    split (``dsm.py:229``) laid out in the flat order."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3001,), "b": {"c": (7, 13)}, "d": (5,)}
    leaves = convert.flatten_tree(shapes, is_leaf=lambda x: isinstance(x, tuple))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def draw(scale=1.0):
        return {n: (scale * rng.standard_normal(s)).astype(np.float32) for n, s in leaves}

    x0, m, noise = draw(), draw(), draw(0.003)
    x0 = {n: np.asarray(jnp.asarray(v).astype(jdt).astype(jnp.float32)) for n, v in x0.items()}
    xt = {n: np.asarray(jnp.asarray(x0[n] - noise[n]).astype(jdt).astype(jnp.float32))
          for n in x0}

    def tree(flat_by_name, cast):
        out = {"a": flat_by_name["a"], "b": {"c": flat_by_name["b.c"]}, "d": flat_by_name["d"]}
        return jax.tree.map(lambda v: jnp.asarray(v).astype(cast), out)

    gamma, bound, key = 0.01, 4.0, jax.random.PRNGKey(3)
    jx, jm = JD.global_sign_momentum_step(
        tree(x0, jdt), tree(m, jnp.float32), tree(xt, jdt), jnp.float32(gamma),
        JD.DSMConfig(global_lr=0.3, sign_mode=mode, sign_bound=bound), rng=key)
    keys = jax.random.split(key, len(leaves))
    uniform = np.concatenate([np.asarray(jax.random.uniform(k, s, dtype=jnp.float32)).ravel()
                              for k, (_, s) in zip(keys, leaves)])

    def flat(d):
        return torch.from_numpy(np.concatenate([d[n].ravel() for n, _ in leaves]))

    cfg = D.DSMConfig(global_lr=0.3, sign_mode=mode, sign_bound=bound)
    x_out, m_out = D.global_sign_momentum_step(flat(x0).to(dtype), flat(m), flat(xt).to(dtype),
                                               gamma, cfg, uniform=torch.from_numpy(uniform))
    np.testing.assert_allclose(x_out.float().numpy(), _flat_jax(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m_out.numpy(), _flat_jax(jm), rtol=1e-5, atol=1e-6)
    # not vacuous: the draws changed some signs from the deterministic step
    xs, _ = D.global_sign_momentum_step(flat(x0).to(dtype), flat(m), flat(xt).to(dtype), gamma,
                                        D.DSMConfig(global_lr=0.3))
    assert (xs != x_out).float().mean() > 0.1


@pytest.mark.parametrize("mode", ["rand_pm", "rand_zero"])
def test_randomized_signs_are_unbiased(mode):
    """Lemma 1: E[S(v)] = v / B for |v| <= B.  Each draw has variance <= 1,
    so the mean of K = 20,000 draws is within 5 / sqrt(K) = 0.035 of v / B
    at each of 256 coordinates (a 5-sigma bound)."""
    k, n = 20_000, 256
    v = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, n).astype(np.float32))
    bound = 1.2 * float(v.abs().max())
    gen = torch.Generator().manual_seed(0)
    samples = D.RANDOMIZED_SIGNS[mode](v.expand(k, n), gen, bound)
    err = (samples.mean(dim=0) - v / bound).abs().max().item()
    assert err < 5 / k ** 0.5, err


def _settings(algorithm, **kw):
    base = dict(algorithm=algorithm, n_workers=W, tau=3, steps=4, b_micro=BM, seq=SEQ,
                peak_lr=ETA, global_lr=0.3, eval_every=4, eval_batch=4)
    if algorithm == "signed_slowmo":
        # benchmarks/tables.py's quick value: each flipped sign of x0 - x_tau
        # moves a coordinate by 2 * eta * (1 - beta)
        base["global_lr"] = 0.005
    return {**base, **kw}


@pytest.mark.parametrize("algorithm", ["slowmo", "signed_slowmo", "lookahead",
                                       "signed_lookahead", "global_adamw", "local_avg",
                                       "perstep"])
def test_run_training_matches_reference_history(algorithm):
    kw = _settings(algorithm)
    jres = JTR.run_training(J_NANO, JTR.TrainSettings(**kw))
    res = TR.run_training(NANO, TR.TrainSettings(**kw), device="cpu",
                          params=_init()[1])
    assert (res["tokens"], res["comm_rounds"]) == (jres["tokens"], jres["comm_rounds"])
    np.testing.assert_allclose(res["history"], jres["history"], rtol=2e-3)
    np.testing.assert_allclose(res["final_eval"], jres["final_eval"], rtol=2e-3)


def test_perstep_runs_at_bf16_and_keeps_the_param_dtype():
    """The reference's per-step baseline cannot run bf16 params
    (``baselines.py:267`` promotes them to f32 inside its scan); the port
    casts the update back, as the local steps do."""
    cfg = dataclasses.replace(NANO, dtype="bfloat16", param_dtype="bfloat16")
    res = TR.run_training(cfg, TR.TrainSettings(**_settings("perstep", steps=2)), device="cpu")
    st = res["state"]
    assert st.params.dtype == torch.bfloat16 and st.params.shape == (T.layout(cfg).numel,)
    assert st.base_state.m.dtype == torch.float32
    assert np.isfinite(res["history"]).all() and np.isfinite(res["final_eval"])


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Shapes of every call of the two kernels' wrappers (on the CPU they run
    the plain versions; on the card each call is one launch)."""
    calls = {"dsm_update": [], "adamw_update": []}
    for mod, name in ((D, "dsm_update"), (B, "adamw_update")):
        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            calls[_n].append(tuple(a[0].shape))
            return _f(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


ROUTES = [(a, "adamw", "sign") for a in TR.ALGORITHMS] + [
    ("dsm", "sophia", "sign"), ("dsm", "sgd", "sign"), ("dsm", "adamw", "rand_pm"),
    ("dsm", "adamw", "rand_zero")]


@pytest.mark.parametrize("algorithm,base_opt,sign_mode", ROUTES,
                         ids=["-".join(r) for r in ROUTES])
def test_kernel_wrappers_run_where_the_table_says(wrapper_calls, algorithm, base_opt,
                                                  sign_mode):
    """Per outer step: the DSM step once for dsm (any base optimizer, the
    deterministic sign) and signed_lookahead; the AdamW step tau times on
    (W, N) for every local-step method with AdamW, tau times on (N,) for
    perstep, never for mv_signsgd or another base optimizer."""
    steps, tau = 2, 2
    s = TR.TrainSettings(**_settings(algorithm, base_opt=base_opt, sign_mode=sign_mode,
                                     steps=steps, tau=tau))
    res = TR.run_training(NANO, s, device="cpu")
    assert np.isfinite(res["history"]).all()
    n = T.layout(NANO).numel
    dsm = steps if algorithm in ("dsm", "signed_lookahead") and sign_mode == "sign" else 0
    adamw = 0 if algorithm == "mv_signsgd" or base_opt != "adamw" else steps * tau
    shape = (n,) if algorithm == "perstep" else (W, n)
    assert wrapper_calls["dsm_update"] == [(n,)] * dsm
    assert wrapper_calls["adamw_update"] == [shape] * adamw


@pytest.mark.parametrize("mode", ["rand_pm", "rand_zero"])
def test_randomized_dsm_trains_and_repeats_from_its_seed(mode):
    s = TR.TrainSettings(**_settings("dsm", sign_mode=mode, steps=2, tau=2))
    a, b = (TR.run_training(NANO, s, device="cpu")["history"] for _ in range(2))
    det = TR.run_training(NANO, dataclasses.replace(s, sign_mode="sign"), device="cpu")
    assert np.isfinite(a).all() and a == b and a[1:] != det["history"][1:]


@pytest.mark.parametrize("algorithm", TR.ALGORITHMS)
def test_launcher_runs_every_algorithm_on_cpu(algorithm):
    from repro_torch.launch import train as launch

    res = launch.main(["--device", "cpu", "--algorithm", algorithm, "--steps", "1",
                       "--n-workers", "2", "--tau", "2", "--seq", "16", "--b-micro", "1"])
    assert np.isfinite(res["final_eval"])
    assert res["comm_rounds"] == (2 if algorithm == "perstep" else 1)


def test_launcher_takes_the_reference_choices():
    from repro_torch.launch import train as launch

    ap = launch.build_parser()
    assert TR.ALGORITHMS == JTR.ALGORITHMS
    for name in JB.REGISTRY:
        assert ap.parse_args(["--base-opt", name]).base_opt == name
    with pytest.raises(SystemExit):
        ap.parse_args(["--base-opt", "adagrad"])


@pytest.mark.parametrize("name,args", [("signsgd_momentum_config", (0.9,)),
                                       ("signed_lookahead_config", (8, 0.6)),
                                       ("signed_lookahead_config", (8, 0.6, 0.1))])
def test_config_instances_match_reference(name, args):
    ours, theirs = getattr(D, name)(*args), getattr(JD, name)(*args)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
