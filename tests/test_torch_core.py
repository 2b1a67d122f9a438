"""The port's schedules, AdamW direction, global step and metric pack
against the JAX package's, on the CPU, from the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import base_opt as JB
from repro.core import dsm as JD
from repro.core import schedules as JS
from repro.obs import metrics as JM
from repro_torch.core import base_opt as B
from repro_torch.core import dsm as D
from repro_torch.core import schedules as S
from repro_torch.obs import metrics as M


@pytest.mark.parametrize("peak,total,warmup", [(5e-3, 40, 24), (1e-2, 60, 5), (1e-3, 10, 12)])
def test_cosine_schedule_matches_at_every_step(peak, total, warmup):
    """f32 values at every step, past the warmup boundary and the end of the
    decay.  The warmup is exact.  XLA's f32 cos is not always correctly
    rounded (one ulp of cos is <= 1.2e-7, scaled by (peak - min) / 2 in the
    schedule), so the decay agrees within 1e-7 * peak."""
    ours = S.cosine_with_warmup(peak, total, warmup_steps=warmup)
    theirs = JS.cosine_with_warmup(peak, total, warmup_steps=warmup)
    for step in range(total + 5):
        a, b = ours(step), np.float32(theirs(step))
        assert a.dtype == torch.float32
        assert abs(a.item() - b) <= 1e-7 * peak, (step, a.item(), b)
        if step < warmup:
            assert a.item() == b, step


def test_constant_schedule():
    assert S.constant(3e-4)(7).item() == np.float32(JS.constant(3e-4)(7))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_direction_matches_reference(dtype):
    rng = np.random.default_rng(0)
    shape = (5, 37)
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    m = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(jdt if t.dtype == dtype else jnp.float32)

    for step in (0, 1, 23):
        d, st = B.adamw().direction(g, B.AdamWState(m, v), p, step)
        jd, jst = JB.adamw().direction(j(g), JB.AdamWState(j(m), j(v)), j(p), jnp.int32(step))
        assert d.dtype == dtype
        np.testing.assert_allclose(d.float().numpy(), np.asarray(jd, np.float32),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(st.m.numpy(), np.asarray(jst.m), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st.v.numpy(), np.asarray(jst.v), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_step_matches_reference(use_kernel, dtype):
    """The port's one global step against both of the reference's paths:
    ``use_kernel`` picks the reference's jnp path or its Pallas kernel (in
    interpret mode)."""
    rng = np.random.default_rng(11)
    n = 3001
    x0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    m = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    xt = (x0.float() - 0.003 * torch.from_numpy(rng.standard_normal(n).astype(np.float32)))
    xt = xt.to(dtype)
    gamma = 0.01
    cfg = D.DSMConfig(global_lr=0.3)
    jcfg = JD.DSMConfig(global_lr=0.3, use_kernel=use_kernel)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jm = JD.global_sign_momentum_step(
        {"a": jnp.asarray(x0.float().numpy()).astype(jdt)}, {"a": jnp.asarray(m.numpy())},
        {"a": jnp.asarray(xt.float().numpy()).astype(jdt)}, jnp.float32(gamma), jcfg)
    x_out, m_out = D.global_sign_momentum_step(x0.clone(), m.clone(), xt, gamma, cfg)
    np.testing.assert_allclose(x_out.float().numpy(), np.asarray(jx["a"], np.float32),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m_out.numpy(), np.asarray(jm["a"]), rtol=1e-5, atol=1e-6)


def test_metric_pack_matches_reference():
    rng = np.random.default_rng(2)
    n = 4099
    x0 = rng.standard_normal(n).astype(np.float32)
    m = rng.standard_normal(n).astype(np.float32)
    m[:50] = 0.0
    xt = (x0 - 0.01 * rng.standard_normal(n)).astype(np.float32)
    losses = rng.uniform(2.0, 4.0, (12, 4)).astype(np.float32)
    gamma, beta1 = 0.02, 0.95

    ours = M.stat_sums(torch.from_numpy(x0), torch.from_numpy(m), torch.from_numpy(xt),
                       gamma, beta1)
    theirs = JM.tree_stat_sums({"a": x0}, {"a": m}, {"a": xt}, jnp.float32(gamma), beta1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-5)
    assert ours[3].item() == float(theirs[3])          # sign-agreement count: exact

    lo = M.loss_stats(torch.from_numpy(losses))
    jlo = JM.loss_stats(jnp.asarray(losses))
    np.testing.assert_allclose([x.item() for x in lo], [float(x) for x in jlo], rtol=1e-6)

    pack = M.finish_pack(loss=lo[0], last_loss=lo[1], gamma=torch.tensor(gamma),
                         worker_spread=lo[2], stat_sums=ours, n_elems=n)
    jpack = JM.finish_pack(loss=jlo[0], last_loss=jlo[1], gamma=jnp.float32(gamma),
                           worker_spread=jlo[2], stat_sums=theirs, n_elems=n)
    assert pack.shape == (M.N_METRICS,) and M.METRIC_NAMES == JM.METRIC_NAMES
    np.testing.assert_allclose(pack.numpy(), np.asarray(jpack), rtol=2e-5)
