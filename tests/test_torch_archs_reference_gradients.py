"""The port's DSM outer step driven by the reference's loss and gradients,
for every ported arch's SMOKE config, against the reference's step (moved
out of ``test_torch_archs.py``, the tier-1 run's longest file, unchanged;
that file's docstring states the setting and the tolerances)."""

import jax
import pytest

from repro.core import DSMConfig as JDSMConfig
from repro.core import constant as j_constant
from repro.core import dsm_init as j_dsm_init
from repro.core import get_base_optimizer as j_get_base_optimizer
from repro.core import make_dsm_step as j_make_dsm_step
from repro.models import transformer as JT
from repro_torch.configs import load_arch
from repro_torch.core import base_opt as B
from repro_torch.core import dsm as D
from repro_torch.core import schedules as S
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR
from test_torch_archs import (BM, ETA, GAMMA, PORTED, SEQ, TAU, W, _assert_step_close, _batch,
                              _jax_batch, _reference_loss, _setup, _torch_batch)


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    """No TF32 anywhere the tests might reach a card (as run_training sets)."""
    TR.set_matmul_precision()


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_dsm_outer_step_on_reference_gradients(arch):
    """The port's DSM outer step (W=2, tau=2, TOPO.base_opt, the settings of
    ``test_smoke_dsm_outer_step_matches_reference``) driven by the
    reference's loss and gradients, against the reference's step: the
    algorithm alone, without the rounding noise of a second model.  Both
    sides take the same gradients at the same params up to the ulps of the
    optimizer arithmetic, so: loss rtol 1e-6; AdamW moments within 1e-6 of
    each buffer's largest magnitude; x0 within 1e-6 (+ 1e-6 relative) except
    at most N/1000 coordinates whose sign(u) sits within rounding of 0, each
    by at most 2 * eta * gamma; m within 1e-6 (+ 1e-5 relative), where
    Delta = (x0 - x_tau) / gamma scales an ulp of x_tau by 1/gamma."""
    jcfg, cfg, jp, flat = _setup(arch, seed=0)
    topo = load_arch(arch).TOPO
    batch = _batch(cfg, 4, (W, TAU, 1, BM), SEQ)
    jbase = j_get_base_optimizer(topo.base_opt)
    jstep = jax.jit(j_make_dsm_step(lambda p, b: JT.loss_fn(p, b, jcfg, remat=False), jbase,
                                    JDSMConfig(tau=TAU, global_lr=ETA), j_constant(GAMMA)))
    jstate, jm = jstep(j_dsm_init(jp, jbase, n_workers=W), _jax_batch(batch))

    base = B.get_base_optimizer(topo.base_opt)
    lay = T.layout(cfg)
    step = D.make_dsm_step(_reference_loss(jcfg, jp, lay), base,
                           D.DSMConfig(tau=TAU, global_lr=ETA), S.constant(GAMMA), lay)
    state, m = step(D.dsm_init(flat, base, W), _torch_batch(batch))

    _assert_step_close(state, m, jstate, jm, flat, lay)
