"""The paper's other GPT-2 sizes and the dense GQA/MQA archs in the port,
against the JAX package, on the CPU (the pattern of the reference's
``tests/test_smoke_archs.py``, held element for element).

For the SMOKE configs of gpt2_medium, gpt2_large, deepseek_67b (GQA 8/2,
gated SiLU, untied head), granite_34b (MQA, one kv head, GELU, untied) and
minitron_4b (GQA, gated SiLU, untied SMOKE head), all f32, from the
reference's ``init_params`` through ``convert.from_jax_numpy``:

  * loss rtol 1e-6 and every gradient leaf within 3e-5 of that leaf's
    largest magnitude (the tolerances of ``test_torch_model.py``);
  * one DSM outer step (W=2, tau=2, the arch's ``TOPO.base_opt``, constant
    gamma 1e-3, eta 0.5) from the same params and batch: the loss rtol 1e-5;
    each AdamW moment buffer within 1e-3 of its largest magnitude (the
    second local step's gradients are taken at params that differ on the
    coordinates the first step flipped, by 2 * gamma, so they differ by more
    than the gradient test's 3e-5: measured 2.5e-4); x0 elementwise (rtol
    1e-5, atol 1e-5)
    except at most N/1000 coordinates whose sign(u) flipped, each by at most
    2 * eta * gamma (``test_torch_dsm.py`` explains why such flips occur);
    the global momentum m = (1 - beta2) * Delta elementwise (rtol 1e-4,
    atol 1e-5) except at most N/100 coordinates, each within
    (1 - beta2) * 2 * tau.  AdamW's direction m_hat / (sqrt(v_hat) + eps) is
    scale-free: on its first step it is sign(g), and on the second the
    bias-corrected first moment can cancel (g1 against g2), so a coordinate
    whose gradients sit within the two packages' f32 rounding of such a
    point moves Delta by up to 2 * tau / W.  Measured: 0.44% of the
    coordinates of the gated SiLU archs (deepseek, minitron), 0.10% of
    granite's, under 0.1% of the GPT-2 sizes', each under 0.015.

Every other arch id's family or block kind is not ported: building its
layout raises ``NotImplementedError`` naming ROADMAP.md.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_arch as j_load_arch
from repro.core import DSMConfig as JDSMConfig
from repro.core import constant as j_constant
from repro.core import dsm_init as j_dsm_init
from repro.core import get_base_optimizer as j_get_base_optimizer
from repro.core import make_dsm_step as j_make_dsm_step
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, load_arch, specs
from repro_torch.core import base_opt as B
from repro_torch.core import dsm as D
from repro_torch.core import schedules as S
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR

PORTED = ("gpt2_medium", "gpt2_large", "deepseek_67b", "granite_34b", "minitron_4b")
UNPORTED = tuple(a for a in ARCH_IDS if a not in PORTED)
W, TAU, BM, SEQ = 2, 2, 2, 32
GAMMA, ETA = 1e-3, 0.5


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    """No TF32 anywhere the tests might reach a card (as run_training sets)."""
    TR.set_matmul_precision()


def _flat(tree, n_workers=None) -> np.ndarray:
    """A JAX param-shaped tree in the port's flat layout ((W, N) or (N,))."""
    leaves = [np.asarray(v, np.float32) for _, v in convert.flatten_tree(
        jax.tree.map(np.asarray, tree), is_leaf=lambda x: isinstance(x, np.ndarray))]
    if n_workers is None:
        return np.concatenate([v.ravel() for v in leaves])
    return np.concatenate([v.reshape(n_workers, -1) for v in leaves], axis=1)


def _setup(arch, seed):
    jcfg, cfg = j_load_arch(arch).SMOKE, load_arch(arch).SMOKE
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    flat = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
    return jcfg, cfg, jp, flat


def _assert_close_with_flips(ours, theirs, rtol, atol, flip_size, max_flips, what):
    diff = np.abs(ours - theirs)
    bad = diff > atol + rtol * np.abs(theirs)
    assert bad.sum() <= max_flips, f"{what}: {bad.sum()} coordinates differ"
    assert (diff[bad] <= flip_size * 1.001).all(), f"{what}: max diff {diff.max()}"


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_loss_and_grads_match_reference(arch):
    jcfg, cfg, jp, flat = _setup(arch, seed=3)
    assert cfg.n_layers <= 2 and cfg.d_model <= 512
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg, remat=False)))(jp)
    grad = torch.zeros_like(flat)
    loss = T.loss_fn(T.layout(cfg).autograd_leaves(flat, grad),
                     torch.from_numpy(tokens).long(), cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    ours = convert.to_numpy(grad, cfg)
    theirs = dict(convert.flatten_tree(jax.tree.map(np.asarray, jgrads),
                                       is_leaf=lambda x: isinstance(x, np.ndarray)))
    assert sorted(ours) == sorted(theirs)
    for name, g in theirs.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(ours[name], g, rtol=0, atol=3e-5 * scale, err_msg=name)


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_dsm_outer_step_matches_reference(arch):
    jcfg, cfg, jp, flat = _setup(arch, seed=0)
    topo = load_arch(arch).TOPO
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                               (W, TAU, 1, BM, SEQ)).astype(np.int32)

    jbase = j_get_base_optimizer(topo.base_opt)
    jstep = jax.jit(j_make_dsm_step(lambda p, b: JT.loss_fn(p, b, jcfg, remat=False), jbase,
                                    JDSMConfig(tau=TAU, global_lr=ETA), j_constant(GAMMA)))
    jstate, jm = jstep(j_dsm_init(jp, jbase, n_workers=W), {"tokens": jnp.asarray(tokens)})

    base = B.get_base_optimizer(topo.base_opt)
    lay = T.layout(cfg)
    step = D.make_dsm_step(lambda p, mb: T.loss_fn(p, mb, cfg), base,
                           D.DSMConfig(tau=TAU, global_lr=ETA), S.constant(GAMMA), lay)
    state, m = step(D.dsm_init(flat, base, W), torch.from_numpy(tokens).long())

    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    flip = 2 * np.float32(ETA) * np.float32(GAMMA)
    _assert_close_with_flips(state.x0.numpy(), _flat(jstate.x0), 1e-5, 1e-5, flip,
                             max_flips=lay.numel // 1000, what="x0")
    for ours, theirs in ((state.base_state.m, jstate.base_state.m),
                         (state.base_state.v, jstate.base_state.v)):
        theirs = _flat(theirs, W)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=1e-3 * np.abs(theirs).max())
    _assert_close_with_flips(state.m.numpy(), _flat(jstate.m), 1e-4, 1e-5,
                             (1 - 0.98) * 2 * TAU, max_flips=lay.numel // 100, what="m")
    assert (state.x0 != flat).any()      # the params moved


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise_not_implemented(arch):
    mod = load_arch(arch)
    for cfg in (mod.SMOKE, mod.FULL):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            T.layout(cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            specs.param_count(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.init_params(torch.Generator().manual_seed(0), mod.SMOKE)
