"""DSM outer steps of the port against the JAX package's, on nano, on the
CPU, from the same init (``T.init_params`` through ``from_jax_numpy``) and
the same batches (the numpy pipeline, identical in both packages).

``sign()`` turns few-ulp differences in x_tau into whole steps of size
2 * eta * gamma wherever u is within rounding of 0, because Delta scales
x_tau's ulps by 1 / gamma (``distributed/zero.py:19-26``).  AdamW's first
steps are sign-like too (m_hat / sqrt(v_hat) = g / |g|), so a gradient
within rounding of 0 can move a worker's coordinate by 2 * gamma, which
moves Delta by up to 2 / W per local step.  So one outer step is compared
element by element with the kernel tolerances plus a small budget of such
flipped coordinates, and a 12-step trajectory by its loss history.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.tables import NANO as J_NANO
from repro.core import base_opt as JB
from repro.core import dsm as JD
from repro.core import schedules as JS
from repro.models import transformer as JT
from repro.train import trainer as JTR
from repro_torch.configs.nano import NANO
from repro_torch.core import base_opt as B
from repro_torch.core import dsm as D
from repro_torch.core import schedules as S
from repro_torch.data.pipeline import MarkovCorpus, dsm_batches
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import IDX
from repro_torch.train import trainer as TR

W, TAU, BM, SEQ = 4, 4, 2, 64
ETA, GLOBAL_LR = 5e-3, 0.3


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    """No TF32 anywhere the tests might reach a card (as run_training sets)."""
    TR.set_matmul_precision()


def _flat_jax(tree, n_workers=None) -> np.ndarray:
    """A JAX param-shaped tree as the port's flat layout ((W, N) or (N,))."""
    leaves = [np.asarray(v, np.float32) for _, v in convert.flatten_tree(
        jax.tree.map(np.asarray, tree), is_leaf=lambda x: isinstance(x, np.ndarray))]
    if n_workers is None:
        return np.concatenate([v.ravel() for v in leaves])
    return np.concatenate([v.reshape(n_workers, -1) for v in leaves], axis=1)


def _assert_close_with_flips(ours, theirs, rtol, atol, flip_size, max_flips, what):
    """Elementwise close, except at most ``max_flips`` coordinates that may
    differ by up to ``flip_size`` (a flipped sign)."""
    diff = np.abs(ours - theirs)
    bad = diff > atol + rtol * np.abs(theirs)
    assert bad.sum() <= max_flips, f"{what}: {bad.sum()} coordinates differ"
    assert (diff[bad] <= flip_size * 1.001).all(), f"{what}: max diff {diff.max()}"


def test_outer_steps_match_make_dsm_step():
    sched_kw = dict(total_steps=40, warmup_steps=24)
    jparams = JT.init_params(jax.random.PRNGKey(0), J_NANO)
    jbase = JB.adamw()
    jstep = jax.jit(JD.make_dsm_step(
        lambda p, mb: JT.loss_fn(p, mb, J_NANO, remat=False), jbase,
        JD.DSMConfig(tau=TAU, global_lr=GLOBAL_LR, use_kernel=True),
        JS.cosine_with_warmup(ETA, **sched_kw)))
    jstate = JD.dsm_init(jparams, jbase, W)

    base = B.adamw()
    lay = T.layout(NANO)
    step = D.make_dsm_step(lambda p, mb: T.loss_fn(p, mb, NANO), base,
                           D.DSMConfig(tau=TAU, global_lr=GLOBAL_LR),
                           S.cosine_with_warmup(ETA, **sched_kw), lay)
    x0 = convert.from_jax_numpy(jax.tree.map(np.asarray, jparams), NANO, 1)[0]
    state = D.dsm_init(x0, base, W)

    batches = dsm_batches(MarkovCorpus(NANO.vocab_size, seed=1), W, TAU, 1, BM, SEQ, seed=0)
    for t in range(2):      # the second step checks what carries over
        tokens = next(batches)["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens).long()})
        gamma = float(jm["gamma"])
        # 1 ulp: under jit XLA turns the warmup's division by a constant into
        # a product with its reciprocal; the port divides, as eager JAX does
        assert abs(m["gamma"].item() - gamma) <= np.spacing(np.float32(gamma))
        assert (state.t, state.inner) == (int(jstate.t), int(jstate.inner)) == (t + 1,
                                                                                 TAU * (t + 1))
        flip = 2 * np.float32(GLOBAL_LR) * np.float32(gamma)
        _assert_close_with_flips(state.x0.numpy(), _flat_jax(jstate.x0), 1e-5, 1e-5, flip,
                                 max_flips=lay.numel // 1000, what=f"x0 step {t}")
        np.testing.assert_array_equal(state.params.numpy(),
                                      np.broadcast_to(state.x0.numpy(), state.params.shape))
        np.testing.assert_allclose(state.params.numpy(), _flat_jax(jstate.params, W),
                                   rtol=1e-5, atol=flip * 1.001)
        m_flip = (1 - 0.98) * 2 * TAU * (t + 1)    # (1 - beta2) * flipped Delta
        _assert_close_with_flips(state.m.numpy(), _flat_jax(jstate.m), 1e-4, 1e-5, m_flip,
                                 max_flips=lay.numel // 1000, what=f"m step {t}")
        np.testing.assert_allclose(state.base_state.m.numpy(),
                                   _flat_jax(jstate.base_state.m, W), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(state.base_state.v.numpy(),
                                   _flat_jax(jstate.base_state.v, W), rtol=1e-4, atol=1e-9)
        pack, jpack = m["pack"].numpy(), np.asarray(jm["pack"])
        for name in ("loss", "last_loss", "gamma", "survivor_frac", "guard_ok"):
            np.testing.assert_allclose(pack[IDX[name]], jpack[IDX[name]], rtol=1e-5,
                                       err_msg=name)
        # spread^2 = E[l^2] - E[l]^2 cancels: it is known to a few ulps of loss^2
        sq = np.float32(pack[IDX["loss"]]) ** 2
        assert abs(pack[IDX["worker_spread"]] ** 2 - jpack[IDX["worker_spread"]] ** 2) \
            <= 8 * np.spacing(sq)
        for name in ("pg_l1", "pg_l2", "pg_density", "m_l1", "update_cos", "sign_agree"):
            np.testing.assert_allclose(pack[IDX[name]], jpack[IDX[name]], rtol=1e-3,
                                       err_msg=name)


def test_run_training_matches_reference_history():
    """12 outer steps (W=4, tau=12, the launcher's learning rates) from the
    same init and batches.  Bound: the per-step train loss and the final
    eval within 2e-3 relative; sign flips (see the module docstring) move
    only a few coordinates by 2 * eta * gamma per step."""
    kw = dict(n_workers=W, tau=12, steps=12, b_micro=BM, seq=SEQ, peak_lr=ETA,
              global_lr=GLOBAL_LR, eval_every=4, eval_batch=8)
    jres = JTR.run_training(J_NANO, JTR.TrainSettings(**kw),
                            corpus=None)
    jparams = JT.init_params(jax.random.PRNGKey(0), J_NANO)
    params = convert.from_jax_numpy(jax.tree.map(np.asarray, jparams), NANO, 1)
    res = TR.run_training(NANO, TR.TrainSettings(**kw), device="cpu", params=params)
    assert len(res["history"]) == 12 and res["comm_rounds"] == 12
    assert res["tokens"] == jres["tokens"]
    assert [t for t, _ in res["eval_losses"]] == [t for t, _ in jres["eval_losses"]]
    np.testing.assert_allclose(res["history"], jres["history"], rtol=2e-3)
    np.testing.assert_allclose([e for _, e in res["eval_losses"]],
                               [e for _, e in jres["eval_losses"]], rtol=2e-3)
    assert res["history"][-1] < res["history"][0]


def test_launcher_trains_on_cpu_with_reference_defaults():
    from repro_torch.launch import train as launch

    args = launch.build_parser().parse_args([])
    assert (args.arch, args.algorithm, args.n_workers, args.seq, args.b_micro, args.peak_lr,
            args.global_lr, args.steps) == ("nano", "dsm", 4, 128, 4, 5e-3, 0.3, 40)
    assert launch.resolve_arch("nano")[1].tau == 12
    assert launch.resolve_arch("gpt2_small")[0].d_model == 768
    res = launch.main(["--device", "cpu", "--steps", "2", "--n-workers", "2", "--tau", "2",
                       "--seq", "32", "--b-micro", "2"])
    assert np.isfinite(res["final_eval"]) and res["comm_rounds"] == 2
    with pytest.raises(SystemExit, match="--corpus text"):
        launch.make_corpus("markov", 50257)


def test_run_training_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        assert TR.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TR.run_training(NANO, TR.TrainSettings(steps=1))
