"""The recurrent and encoder-decoder families on 2 and 4 gloo model ranks
on the CPU, computed Megatron-split: mamba2 (``ssm``: its SSD by heads; at
SMOKE its ``in_proj`` is 552 wide, so the placement's blocks at 2 and 4
ranks cut its z / x / B / C / dt segments as at full width, and each rank
slices its heads' columns from the gathered leaf), recurrentgemma
(``rglru``: the RG-LRU by channels, the conv output gathered; its ``swa``
layers by heads) and whisper (the ``encattn`` encoder and the decoder's
cross-attention by heads, the encoder output's gradient all-reduced once).
The loss and the gathered gradients are held against the JAX package's
``loss_fn`` and ``jax.grad`` with the tolerances of
``test_torch_tensor_parallel.py::check_case`` (loss rtol 1e-6, each
gradient leaf within 3e-5 of its largest magnitude), and each rank's
``CommStats`` against ``tensor_parallel.microbatch_collectives``, with and
without remat.

Every leaf is held within 3e-5 of JAX but one: layer 0's Mamba-2
``ssm.norm.scale`` at 4 ranks, within ``GRAD_ATOL["ssm"]`` = 1e-4, the bound
``test_torch_recurrent.py`` holds the ``ssm`` model's gradients to.  It read
1.008 units of 3e-5 from the reference's, whose own gradient of that leaf
lies 1.12 units from a float64 evaluation of the port (the port's dense f32
gradient 0.16): the reference's SSD takes the exp of differences of large
log-decay prefix sums (ROADMAP.md, "Reference caveats").  Each split is also
held within 3e-5 of the port's dense gradients on the same params and batch.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR
from test_torch_recurrent import GRAD_ATOL
from test_torch_tensor_parallel import (B, S, _batch, _configs, _torch, check_case, run_cases,
                                        whole_gather_bytes)

FAMILIES = ("mamba2_780m", "recurrentgemma_2b", "whisper_large_v3")
CASES = [(a, m, False) for m in (2, 4) for a in FAMILIES] + [(a, 2, True) for a in FAMILIES]
IDS = [f"{a}-{m}ranks{'-remat' if r else ''}" for a, m, r in CASES]


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    TR.set_matmul_precision()


@pytest.fixture(scope="module")
def family_runs():
    return run_cases(CASES)


@functools.cache
def dense_grads(arch: str) -> dict:
    """The port's dense ``loss_fn`` gradient on run_cases' params and batch."""
    jcfg, cfg = _configs(arch)
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    row = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
    grad = torch.zeros_like(row)
    loss = T.loss_fn(T.layout(cfg).autograd_leaves(row, grad), _torch(_batch(cfg, 1, (B,), S)),
                     cfg, remat=False)
    loss.backward()
    return convert.to_numpy(grad, cfg)


# the one (case, leaf) shown to need more than 3e-5 against the reference
LOOSE = {("mamba2_780m", 4): {"decoder.blocks.p0.ssm.norm.scale"}}


def _rel(arch: str, M: int):
    loose = LOOSE.get((arch, M), set())
    return lambda name: GRAD_ATOL["ssm"] if name in loose else 3e-5


@pytest.mark.parametrize("arch,M,remat", CASES, ids=IDS)
def test_gathered_family_matches_jax(family_runs, arch, M, remat):
    """Each case against JAX and the port's dense gradients; the rank
    splits the family's mixer (its Mamba-2 heads, RG-LRU channels or
    whisper heads), so it gathers under half the bytes that gathering every
    leaf up front did, and no config reaches a whole-model gather."""
    run = family_runs[(arch, M, remat)]
    ours = check_case(run, M, remat, _rel(arch, M))
    for name, g in dense_grads(arch).items():
        np.testing.assert_allclose(ours[name], g, rtol=0, atol=3e-5 * float(np.abs(g).max()),
                                   err_msg=name)
    cfg = run[2]
    assert not hasattr(T, "_gathered")
    lay = TP.rank_layout(cfg, M, 0)
    comm = TP.microbatch_collectives(cfg, lay, B, S)
    assert comm["all_gather@model"]["bytes"] < 0.5 * whole_gather_bytes(lay)
    assert comm["all_reduce_sum@model"]["calls"] > 0



# 3 model ranks: mamba2 SMOKE's 8 heads and recurrentgemma SMOKE's 128
# RG-LRU channels do not divide, as mamba2 SMOKE's 8 heads do not over the
# pod's 16 (the dry-run's serving records reach it)
UNDIVIDED = [("mamba2_780m", 3, False), ("recurrentgemma_2b", 3, False)]


@pytest.fixture(scope="module")
def undivided_runs():
    return run_cases(UNDIVIDED)


@pytest.mark.parametrize("arch,M,remat", UNDIVIDED, ids=[f"{a}-3ranks" for a, _, _ in UNDIVIDED])
def test_undivided_recurrent_mixer_gathers_per_leaf(undivided_runs, arch, M, remat):
    """Heads or channels that do not divide over the model group: every
    rank computes the whole mixer over its leaves, each gathered at use
    (``transformer._tp_recurrent``), and matches JAX and the port's dense
    gradients as the split does; each rank's ``CommStats`` equals the
    reckoning, which counts one gather per mixer leaf and use."""
    cfg = undivided_runs[(arch, M, remat)][2]
    mixer = "ssm" if arch == "mamba2_780m" else "rglru"
    assert T._rank_width(mixer, cfg, M) is None
    ours = check_case(undivided_runs[(arch, M, remat)], M, remat)
    for name, g in dense_grads(arch).items():
        np.testing.assert_allclose(ours[name], g, rtol=0, atol=3e-5 * float(np.abs(g).max()),
                                   err_msg=name)
