"""The port's base optimizers against the JAX package's, on the CPU.

Each optimizer's ``direction`` and the training path's local update
(``(x.f32 - gamma * d.f32).astype(x.dtype)``, ``repro/core/dsm.py:318-323``)
are held against ``repro.core.base_opt`` over 3 steps from seeded numpy
inputs, at f32 and bf16.  Both sides do the same IEEE operations in the same
order (the reference run eagerly, one rounding per operation), so the
tolerance is rtol 1e-6 in f32 and one bf16 ulp (rtol 2**-8) in bf16.  Then
DSM with each base optimizer trains nano for 4 outer steps against the
reference's ``run_training`` (loss history within 2e-3 relative, as
tests/test_torch_dsm.py states for AdamW).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.tables import NANO as J_NANO
from repro.core import base_opt as JB
from repro.models import transformer as JT
from repro.train import trainer as JTR
from repro_torch.configs.nano import NANO
from repro_torch.core import base_opt as B
from repro_torch.models import convert
from repro_torch.train import trainer as TR

CASES = [("sgd", {}), ("momentum", {"nesterov": False}), ("momentum", {"nesterov": True}),
         ("lion", {}), ("sophia", {})]
IDS = ["sgd", "momentum", "nesterov", "lion", "sophia"]
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Nano-sized tensors gain nothing from intra-op threads, and under a
    parallel test run each worker's 8 OpenMP threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    # a copy: jnp.asarray may share a numpy buffer that update() then writes
    return t.float().numpy().copy()


def _j(t: torch.Tensor):
    return jnp.asarray(_np(t)).astype(DTYPES[t.dtype])


@pytest.mark.parametrize("dtype", list(DTYPES), ids=["f32", "bf16"])
@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_direction_and_local_update_match_reference(name, kw, dtype):
    rng = np.random.default_rng(3)
    shape, gamma = (3, 37), np.float32(3e-3)
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    opt, jopt = B.get_base_optimizer(name, **kw), JB.get_base_optimizer(name, **kw)
    state, jstate = opt.init(p), jopt.init(_j(p))
    jp = _j(p)
    rtol = RTOL[dtype]
    for step in range(3):
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        d, new_state = opt.direction(g, state, p, step)
        jd, jstate = jopt.direction(_j(g), jstate, jp, jnp.int32(step))
        assert d.dtype == dtype
        np.testing.assert_allclose(_np(d), np.asarray(jd, np.float32), rtol=rtol, atol=1e-7)
        opt.update(p, g, state, float(gamma), step)
        jp = (jp.astype(jnp.float32) - jnp.float32(gamma) * jd.astype(jnp.float32)).astype(jp.dtype)
        np.testing.assert_allclose(_np(p), np.asarray(jp, np.float32), rtol=rtol, atol=1e-7,
                                   err_msg=f"params after step {step}")
        for ours, theirs, fresh in zip(B._buffers(state), jax.tree.leaves(jstate),
                                       B._buffers(new_state)):
            assert ours.dtype == fresh.dtype == (dtype if name == "momentum" else torch.float32)
            np.testing.assert_allclose(_np(ours), np.asarray(theirs, np.float32), rtol=rtol,
                                       atol=1e-7, err_msg=f"state after step {step}")


def test_sophia_takes_a_hessian_estimate():
    rng = np.random.default_rng(4)
    p, g, h = (torch.from_numpy(rng.standard_normal(50).astype(np.float32)) for _ in range(3))
    h = h.abs()
    opt, jopt = B.sophia(), JB.sophia()
    d, st = opt.direction(g, opt.init(p), p, 0, hess=h)
    jd, jst = jopt.direction(_j(g), jopt.init(_j(p)), _j(p), jnp.int32(0), hess=_j(h))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(jst.h), rtol=1e-6)


def test_registry_matches_reference():
    assert list(B.REGISTRY) == list(JB.REGISTRY)
    with pytest.raises(ValueError, match="unknown base optimizer"):
        B.get_base_optimizer("adagrad")


@pytest.mark.parametrize("base_opt", ["sgd", "momentum", "lion", "sophia"])
def test_dsm_trajectory_matches_reference(base_opt):
    """4 outer steps of DSM with each base optimizer from the same init and
    batches; the train losses and the final eval within 2e-3 relative."""
    kw = dict(base_opt=base_opt, n_workers=2, tau=3, steps=4, b_micro=2, seq=32,
              peak_lr=5e-3, global_lr=0.3, eval_every=4, eval_batch=4)
    jres = JTR.run_training(J_NANO, JTR.TrainSettings(**kw))
    params = convert.from_jax_numpy(
        jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), J_NANO)), NANO, 1)
    res = TR.run_training(NANO, TR.TrainSettings(**kw), device="cpu", params=params)
    np.testing.assert_allclose(res["history"], jres["history"], rtol=2e-3)
    np.testing.assert_allclose(res["final_eval"], jres["final_eval"], rtol=2e-3)
