"""The port's arch registry against the JAX package's: every arch module's
FULL / SMOKE / TOPO (and PEAK_LR) field for field, the input shapes and arch
ids, the parameter counts of the archs (dense, sliding-window, MoE and
recurrent), the launcher's resolution of every id, its training of the
sliding-window, MoE and recurrent SMOKE configs and its refusal of a
training state past the device's memory, and ``get_schedule``.  Dtypes are compared by name
(the port's properties return torch dtypes, the reference's numpy ones)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import PAPER_ARCH_IDS as J_PAPER_ARCH_IDS
from repro.configs import arch_supports_shape as j_arch_supports_shape
from repro.configs import load_arch as j_load_arch
from repro.configs import specs as JSPECS
from repro.core import schedules as JS
from repro_torch import configs as C
from repro_torch import core
from repro_torch.configs import specs
from repro_torch.core import schedules as S
from repro_torch.launch import train as launch
from repro_torch.models import transformer as T

ALL_IDS = J_ARCH_IDS + J_PAPER_ARCH_IDS
DENSE_FULL = ("gpt2_small", "gpt2_medium", "gpt2_large", "deepseek_67b", "granite_34b",
              "minitron_4b")
NEW_FULL = ("gemma3_1b", "granite_moe_3b_a800m", "llama4_maverick_400b_a17b")
RECURRENT = ("mamba2_780m", "recurrentgemma_2b")
PROPERTIES = ("hd", "padded_vocab", "d_inner", "ssm_heads", "d_rnn", "n_scan_blocks",
              "n_rem_layers")


def _dtype_name(d) -> str:
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) else np.dtype(d).name


def test_ids_and_input_shapes_match_reference():
    assert C.ARCH_IDS == J_ARCH_IDS
    assert C.PAPER_ARCH_IDS == J_PAPER_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in C.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ALL_IDS)
def test_arch_module_matches_reference(arch):
    ours, theirs = C.load_arch(arch), j_load_arch(arch)
    for name in ("FULL", "SMOKE"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), (arch, name)
        for prop in PROPERTIES:
            assert getattr(a, prop) == getattr(b, prop), (arch, name, prop)
        assert a.layer_kinds() == b.layer_kinds()
        assert _dtype_name(a.act_dtype) == _dtype_name(b.act_dtype) == a.dtype
        assert _dtype_name(a.p_dtype) == _dtype_name(b.p_dtype) == a.param_dtype
    assert dataclasses.asdict(ours.TOPO) == dataclasses.asdict(theirs.TOPO)
    assert getattr(ours, "PEAK_LR", None) == getattr(theirs, "PEAK_LR", None)
    for shape in C.INPUT_SHAPES:
        assert C.arch_supports_shape(ours.FULL, ours.TOPO, shape) == j_arch_supports_shape(
            theirs.FULL, theirs.TOPO, shape)


@pytest.mark.parametrize("arch", DENSE_FULL + NEW_FULL + RECURRENT)
def test_param_count_matches_reference(arch):
    cfg = C.load_arch(arch).FULL
    assert specs.param_count(cfg) == JSPECS.param_count(j_load_arch(arch).FULL)


def test_paper_gpt2_sizes_param_counts():
    """The paper's GPT-2 medium and large at full width, vocab padded to
    50,688: the N that the AdamW and DSM kernels cover."""
    medium, large = C.load_arch("gpt2_medium").FULL, C.load_arch("gpt2_large").FULL
    assert medium.padded_vocab == large.padded_vocab == 50_688
    assert specs.param_count(medium) == 353_944_576
    assert specs.param_count(large) == 772_762_880
    assert 4 * specs.param_count(large) > 2 ** 31     # the (W, N) AdamW buffer at W = 4


@pytest.mark.parametrize("arch", ALL_IDS)
def test_launcher_resolves_every_arch(arch):
    cfg, topo = launch.resolve_arch(arch)
    assert cfg == C.load_arch(arch).FULL and topo == C.load_arch(arch).TOPO
    smoke, _ = launch.resolve_arch(f"{arch}_smoke")
    assert smoke == C.load_arch(arch).SMOKE


@pytest.mark.parametrize("name,kw", [("constant", {}), ("cosine", {}),
                                     ("cosine", dict(warmup_steps=10, final_frac=0.1))])
def test_get_schedule_matches_reference(name, kw):
    ours, theirs = S.get_schedule(name, 3e-4, 100, **kw), JS.get_schedule(name, 3e-4, 100, **kw)
    for step in (0, 1, 9, 10, 57, 99, 150, 2500):
        a, b = ours(step), theirs(jnp.int32(step))
        assert a.dtype == torch.float32
        assert abs(a.item() - float(b)) <= 2 * np.spacing(np.float32(b)), (name, step)
    assert core.get_schedule is S.get_schedule


def test_get_schedule_rejects_unknown_names():
    for get in (S.get_schedule, JS.get_schedule):
        with pytest.raises(ValueError, match="unknown schedule 'linear'"):
            get("linear", 1e-3)


@pytest.mark.parametrize("arch", [f"{a}_smoke" for a in NEW_FULL])
def test_launcher_trains_the_window_and_moe_smokes(arch, capsys):
    """``--arch <id>_smoke`` of the sliding-window and MoE archs trains on
    the CPU with each arch's base optimizer: a finite final eval, printed."""
    res = launch.main(["--device", "cpu", "--arch", arch, "--steps", "2", "--tau", "2",
                       "--n-workers", "2", "--seq", "32", "--b-micro", "1"])
    assert np.isfinite(res["final_eval"]) and len(res["history"]) == 2
    assert "final eval loss:" in capsys.readouterr().out


def test_recurrent_full_param_counts():
    """Both recurrent archs at full size, the reference's counts; a bf16
    model's f32 leaves (``lam``; ``A_log``, ``D``, ``dt_bias``) in a second
    dtype group."""
    rg, mamba = C.load_arch("recurrentgemma_2b").FULL, C.load_arch("mamba2_780m").FULL
    assert specs.param_count(rg) == 2_894_481_920
    assert specs.param_count(mamba) == 780_775_680
    assert T.layout(rg).group_numels == (2_894_481_920 - 18 * 2560, 18 * 2560)
    assert T.layout(mamba).group_numels == (780_775_680 - 48 * 3 * 48, 48 * 3 * 48)


@pytest.mark.parametrize("arch", [f"{a}_smoke" for a in RECURRENT])
def test_launcher_trains_the_recurrent_smokes(arch, capsys):
    """``--arch <id>_smoke`` of Mamba-2 and RecurrentGemma trains on the CPU
    (DSM, AdamW): a finite final eval, printed."""
    res = launch.main(["--device", "cpu", "--arch", arch, "--steps", "2", "--tau", "2",
                       "--n-workers", "2", "--seq", "32", "--b-micro", "1"])
    assert np.isfinite(res["final_eval"]) and len(res["history"]) == 2
    assert "final eval loss:" in capsys.readouterr().out


def test_launcher_refuses_recurrentgemma_full_on_one_card(monkeypatch):
    """recurrentgemma_2b FULL (2,894,481,920 parameters, 156 GB of state at
    the launcher's W=4) is refused on one 80 GB card; the count includes its
    f32 group."""
    monkeypatch.setattr(launch, "device_bytes", lambda device: 80 * 10 ** 9)
    assert launch.state_bytes(C.load_arch("recurrentgemma_2b").FULL, 4) == (
        (2_894_481_920 - 46_080) * (4 * (2 * 2 + 8) + 2 + 4) + 46_080 * (4 * (2 * 4 + 8) + 8))
    with pytest.raises(SystemExit, match="2,894,481,920 parameters need 156.3 GB"):
        launch.main(["--device", "cpu", "--arch", "recurrentgemma_2b", "--steps", "1"])


def test_launcher_refuses_a_state_past_the_device():
    """llama4_maverick_400b_a17b FULL (397,693,916,160 parameters) is refused
    before anything is allocated: its training state exceeds any one
    device's memory."""
    with pytest.raises(SystemExit, match="397,693,916,160 parameters"):
        launch.main(["--device", "cpu", "--arch", "llama4_maverick_400b_a17b", "--steps", "1"])
