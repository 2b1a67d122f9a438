"""The five local-step baselines on gemma3_1b with ``attn_seq_shard`` and
its attention weights whole (``TOPO.attn_tp = False``) over (2, 1, 2) and
(1, 1, 4) gloo ranks, against the JAX package's builders, as
``test_torch_algorithms_ranks_baselines.py`` holds minitron_4b's grids (a
file of its own, so that a parallel test run spreads the two)."""

import pytest

from test_torch_algorithms_ranks_baselines import F32_GRIDS, GRIDS, METHODS, check_baseline
from test_torch_algorithms_ranks_baselines import run_baselines

HERE = [g for g in F32_GRIDS if GRIDS[g][0] == "gemma3_1b"]
CASES = [(g, m) for g in HERE for m in METHODS]


@pytest.fixture(scope="module")
def baseline_runs() -> dict:
    return run_baselines(HERE)


@pytest.mark.parametrize("grid,method", CASES, ids=[f"{g}-{m}" for g, m in CASES])
def test_sp_baseline_over_ranks_matches_reference(baseline_runs, grid, method):
    check_baseline(baseline_runs[(grid, method)], grid, method)
