"""Algorithm 1 (DSM), the paper's baselines, the base optimizers and
learning-rate schedules."""

from repro_torch.core.base_opt import (
    AdamWState,
    BaseOptimizer,
    adamw,
    get_base_optimizer,
    lion,
    momentum,
    sgd,
    sophia,
)
from repro_torch.core.dsm import (
    DSMConfig,
    DSMState,
    dsm_init,
    global_sign_momentum_step,
    make_dsm_step,
    make_local_phase,
    masked_worker_mean,
    randomized_sign_pm,
    randomized_sign_zero,
    signed_lookahead_config,
    signsgd_momentum_config,
    worker_finite_mask,
)
from repro_torch.core.schedules import constant, cosine_with_warmup, get_schedule
