"""Algorithm 1 (DSM), its base optimizer and learning-rate schedules."""

from repro_torch.core.base_opt import AdamWState, BaseOptimizer, adamw, get_base_optimizer
from repro_torch.core.dsm import (
    DSMConfig,
    DSMState,
    dsm_init,
    global_sign_momentum_step,
    make_dsm_step,
    make_local_phase,
)
from repro_torch.core.schedules import constant, cosine_with_warmup
