"""The host-sync sanitizer (``repro_torch.analysis.sanitize``) on its own:
a no-op on the CPU, and on the card it raises on a host sync and lets the
port's outer steps through.  No JAX import: the ``gpu`` tests run on the
GPU machine (``-m gpu``, ``--noconftest``).  The sanitizers' parity with
the JAX package is in ``test_torch_obs.py``."""

import pytest
import torch

from repro_torch.analysis import sanitize as SAN
from repro_torch.configs.nano import NANO
from repro_torch.data.pipeline import MarkovCorpus, dsm_batches
from repro_torch.models import transformer as T
from repro_torch.robustness import guards as G
from repro_torch.train import trainer as TR


def test_no_implicit_host_sync_is_a_no_op_on_the_cpu():
    with SAN.no_implicit_host_sync("cpu"):
        assert float(torch.ones(())) == 1.0
    with SAN.no_implicit_host_sync("cuda", enabled=False):
        pass


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_no_implicit_host_sync_raises_on_the_card():
    x = torch.ones(4, device=_card())
    prev = torch.cuda.get_sync_debug_mode()
    with pytest.raises(SAN.SanitizeError, match="implicit host sync"):
        with SAN.no_implicit_host_sync("cuda"):
            float(x.sum())
    assert torch.cuda.get_sync_debug_mode() == prev
    with SAN.no_implicit_host_sync("cuda"):
        y = x * 2 + torch.full((), 3.0, device="cuda")      # no host round trip
    assert float(y.sum()) == 20.0


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm,guarded", [("dsm", False), ("dsm", True), ("slowmo", False)])
def test_outer_steps_make_no_host_sync_on_the_card(algorithm, guarded):
    """Nano outer steps on the card inside the sanitizer: the step (and the
    guard's device half) raise nothing; the guard's verdict is read after."""
    dev = _card()
    TR.set_matmul_precision()
    s = TR.TrainSettings(algorithm=algorithm, n_workers=2, tau=2, b_micro=2, seq=32)
    init, step, _, _ = TR.build_algorithm(lambda p, mb: T.loss_fn(p, mb, NANO), s,
                                          T.layout(NANO))
    state = init(T.init_params(torch.Generator().manual_seed(0), NANO).to(dev), s.n_workers)
    guard = G.init_guard(dev)
    dstep = G.make_guarded_device_step(step, nonfinite=True)
    batches = dsm_batches(MarkovCorpus(NANO.vocab_size, seed=1), 2, 2, 1, 2, 32, seed=0)
    rng = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        batch = {"tokens": torch.as_tensor(next(batches)["tokens"], dtype=torch.long).to(dev)}
        with SAN.no_implicit_host_sync(dev):
            if guarded:
                state, guard, metrics, counters = dstep(state, guard, batch, rng)
            else:
                state, metrics = step(state, batch, rng)
        if guarded:
            G.settle_counters(state, metrics, counters)
    assert torch.isfinite(metrics["loss"]).item()


@pytest.mark.gpu
def test_moe_and_window_steps_make_no_other_host_sync_on_the_card():
    """A bf16 model of sliding-window and MoE blocks (its routers f32: two
    dtype groups) trains two DSM outer steps on the card under
    ``sanitize=True``: the MoE layers' group-size reads are the one
    sanctioned sync, and nothing else in the step syncs."""
    import dataclasses

    from repro_torch.configs import load_arch

    _card()
    cfg = dataclasses.replace(load_arch("granite_moe_3b_a800m").SMOKE, name="swa_moe_bf16",
                              pattern=("swa:moe", "attn:dense"), window=16, dtype="bfloat16",
                              param_dtype="bfloat16")
    assert T.layout(cfg).n_groups == 2
    s = TR.TrainSettings(n_workers=2, tau=2, steps=2, b_micro=2, seq=32, eval_every=2,
                         sanitize=True)
    res = TR.run_training(cfg, s, device="cuda")
    assert all(torch.isfinite(torch.tensor(res["history"])))
