"""Every family that the model axis does not split (``ssm``, ``rglru``,
``encdec``) on 2 gloo model ranks on the CPU: each rank
holds its blocks of every leaf by the reference's placements, gathers them
at use and computes replicated.  The loss and the gathered gradients are
held against the JAX package's ``loss_fn`` and ``jax.grad`` with the
tolerances of ``test_torch_model.py`` (loss rtol 1e-6, each gradient leaf
within 3e-5 of its largest magnitude), and each rank's ``CommStats``
against the gathers its placements give (``test_torch_tensor_parallel.py``
holds the dense, MoE and VLM configs, which compute Megatron-split).
"""

import pytest

from repro_torch.models import transformer as T
from test_torch_tensor_parallel import check_case, run_cases

FAMILIES = ("mamba2_780m", "recurrentgemma_2b", "whisper_large_v3")


@pytest.fixture(scope="module")
def family_runs():
    return run_cases([(a, 2) for a in FAMILIES])


@pytest.mark.parametrize("arch", FAMILIES)
def test_gathered_family_matches_jax(family_runs, arch):
    check_case(family_runs[(arch, 2)], 2)
    assert not T.megatron_split(family_runs[(arch, 2)][2])
