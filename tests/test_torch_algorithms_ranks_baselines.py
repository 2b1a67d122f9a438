"""The five local-step baselines (``slowmo``, ``signed_slowmo``,
``lookahead``, ``local_avg``, ``global_adamw``) on the model axis and under
FSDP, on gloo ranks on the CPU, against the JAX package's builders.

The f32 grids of ``test_torch_algorithms_ranks.py``: here minitron_4b over
(2, 1, 2), (1, 1, 4), (1, 1, 3) and under FSDP over (2, 2, 1) and (1, 2, 2);
in ``test_torch_algorithms_ranks_baselines_sp.py`` gemma3_1b with
``attn_seq_shard`` and its attention weights whole over (2, 1, 2) and (1,
1, 4); at SMOKE widths.  Each baseline runs one round (AdamW
local steps, tau 2, gamma 1e-3, each global step at the paper's settings of
``test_torch_baselines.py``) from the same init and batches as the JAX
package's builder with ``mesh=None`` (eagerly; gemma3_1b without
``attn_seq_shard``, which moves no value), and the ranks' blocks, gathered
back to the dense buffers, are held against the reference's:

  * the loss within rtol 1e-5;
  * x0 within 3e-5 of its largest magnitude (the model axis tests' bound),
    except that at most 0.1% of coordinates may differ by the move of a
    flipped sign (``test_torch_baselines.py``: AdamW's first local steps
    are sign-like, so a gradient within rounding of zero moves a worker's
    coordinate by up to 2 gamma);
  * each aux buffer within the x0 tolerance carried through the
    pseudo-gradient (x0 - x_tau) / gamma into it (:func:`aux_atol`: x_tau's
    gaps are x0's, and 1 / gamma turns an ulp of x_tau into ~1e-4 of the
    pseudo-gradient, where the Megatron split's sums in another order
    leave a few ulps on ~1% of the coordinates), with the same 0.1% that
    may differ by up to twice the buffer's largest magnitude (a flipped
    sign);
  * every copy of a leaf held whole on several ranks the same bits on every
    rank;
  * each rank's ``CommStats`` ``tensor_parallel.round_collectives``' of a
    baseline round to the byte: the losses gathered and each group's worker
    mean scattered and all-gathered over the ranks that hold the rank's
    blocks, besides the local phase's model and zero groups.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_arch as j_load_arch
from repro.core import base_opt as JB
from repro.core import baselines as JBL
from repro.core import schedules as JS
from repro.models import transformer as JT
from repro_torch.models import convert
from repro_torch.models import transformer as T
from test_torch_algorithms_ranks import (GAMMA, GRIDS, TAU, expected_round, grid_batches,
                                         grid_case, grid_config, rank_layout, run_grids)
from test_torch_baselines import LOCAL_KW, _close, _flat_jax

METHODS = tuple(LOCAL_KW)
# the f32 grids: a bf16 x0 rounds apart from the reference's by more than
# the tolerance; minitron_4b's here, gemma3_1b's in
# test_torch_algorithms_ranks_baselines_sp.py
F32_GRIDS = [g for g, spec in GRIDS.items() if "param_dtype" not in spec[1]]
HERE = [g for g in F32_GRIDS if GRIDS[g][0] == "minitron_4b"]
CASES = [(g, m) for g in HERE for m in METHODS]


@functools.cache
def init(arch: str) -> tuple:
    """The JAX package's init params of the arch's SMOKE config and the
    port's dense ``(N,)`` row of them."""
    jp = JT.init_params(jax.random.PRNGKey(3), j_load_arch(arch).SMOKE)
    cfg = next(grid_config(g) for g, spec in GRIDS.items() if spec[0] == arch)
    return jp, convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]


def reference(grid: str, method: str) -> tuple:
    """The JAX package's builder, one round of the grid's W workers on its
    batches: (loss, x0 (N,), [aux buffers (N,)]).  Grids of one arch and W
    share their init and batches, so they share the run."""
    return _reference(*GRIDS[grid][0:4:3], method)


@functools.cache
def _reference(arch: str, W: int, method: str) -> tuple:
    grid = next(g for g, spec in GRIDS.items() if spec[0] == arch and spec[3] == W)
    jcfg = j_load_arch(arch).SMOKE
    init_, step = getattr(JBL, method)(lambda p, mb: JT.loss_fn(p, mb, jcfg, remat=False),
                                       JB.adamw(), TAU, JS.constant(GAMMA), **LOCAL_KW[method])
    state = init_(init(arch)[0], W)
    tokens = grid_batches(grid)[0]["tokens"][:, :, 0]
    state, metrics = step(state, {"tokens": jnp.asarray(tokens.astype(np.int32))})
    aux = [state.aux] if not isinstance(state.aux, tuple) else list(state.aux)
    return float(metrics["loss"]), _flat_jax(state.x0), [_flat_jax(a) for a in aux]


X0_RTOL = 3e-5          # of x0's largest magnitude


def aux_atol(method: str, i: int, jx0, jaux: list) -> float:
    """The absolute tolerance of aux buffer ``i`` after one round: x0's
    (X0_RTOL of its largest magnitude, which bounds x_tau's gaps too) over
    gamma is the pseudo-gradient g's, times g's weight in the buffer (1 for
    SlowMo's u, 1 - beta for Lookahead's m, 1 - b1 for global AdamW's m,
    (1 - b2) (2 |g| + its tolerance) for its v, |g| = |m| / (1 - b1));
    signed SlowMo's m moves only where a sign flips."""
    g_tol = X0_RTOL * float(np.abs(jx0).max()) / GAMMA
    if method == "slowmo":
        return g_tol
    if method == "lookahead":
        return (1 - LOCAL_KW[method]["beta"]) * g_tol
    if method == "global_adamw":
        b1, b2 = 0.9, 0.95
        if i == 0:
            return (1 - b1) * g_tol
        return (1 - b2) * (2 * float(np.abs(jaux[0]).max()) / (1 - b1) + g_tol) * g_tol
    return 0.0


def run_baselines(grids: list) -> dict:
    """``{(grid, method): each rank's result}`` of the five baselines on
    ``grids``, from the JAX package's init."""
    return run_grids(lambda grid: {m: grid_case(grid, method=m, kw=LOCAL_KW[m],
                                                row=init(GRIDS[grid][0])[1])
                                   for m in METHODS} if grid in grids else {})


def check_baseline(ranks: list, grid: str, method: str) -> None:
    """One round of ``method`` on ``grid``'s ranks against the reference's."""
    cfg = grid_config(grid)
    lay = T.layout(cfg)
    lays = [rank_layout(grid, r) for r in ranks]
    jloss, jx0, jaux = reference(grid, method)
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0].item(), jloss, rtol=1e-5)
        assert r["comm"] == expected_round(grid, r, dsm=False), r["rank"]
    # a flipped local AdamW step moves the worker mean by 2 gamma / W per
    # local step; each method scales that into x0 and its momentum
    x_flip = {"slowmo": 2 * TAU * GAMMA, "lookahead": 2 * TAU * GAMMA,
              "local_avg": 2 * TAU * GAMMA, "global_adamw": 2 * GAMMA,
              "signed_slowmo": 2 * 0.02 * 0.5}[method]
    x0 = convert.gather_flat([r["x0"][0] for r in ranks], lay, lays)
    _close(x0.numpy(), jx0, 0.0, X0_RTOL, "x0", x_flip)
    assert len(ranks[0]["aux"][0]) == len(jaux)
    for i, theirs in enumerate(jaux):
        ours = convert.gather_flat([r["aux"][0][i] for r in ranks], lay, lays)
        top = np.abs(theirs).max()
        _close(ours.numpy(), theirs, 0.0, aux_atol(method, i, jx0, jaux) / top, f"aux {i}",
               flips=2 * top)
    # every copy of an element on every rank is the same bits
    seen = torch.full((lay.numel,), -1, dtype=torch.int32)
    for r, rl in zip(ranks, lays):
        idx = rl.dense_index()[0][1].long()
        mine = r["x0"][0].view(torch.int32)
        held = seen[idx]
        assert torch.equal(torch.where(held == -1, mine, held), mine), r["rank"]
        seen[idx] = mine


@pytest.fixture(scope="module")
def baseline_runs() -> dict:
    return run_baselines(HERE)


@pytest.mark.parametrize("grid,method", CASES, ids=[f"{g}-{m}" for g, m in CASES])
def test_baseline_over_ranks_matches_reference(baseline_runs, grid, method):
    check_baseline(baseline_runs[(grid, method)], grid, method)
