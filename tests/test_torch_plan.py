"""The port launcher's ``--plan`` and ``--use-kernel`` against the JAX
package's launcher, on the CPU.

``--plan`` prints the reference's fields with its names and values (arch,
params_B, the two pod meshes, tau, base_opt, grad_accum), parsed from both
launchers' stdout for the 13 arch ids and nano; ``dryrun_cmd`` names the
port's dry-run; ``per_chip_peak_GB`` and ``dominant_roofline_term``, which
the reference reads from its single-pod dry-run record, come from the
port's ``--mesh single`` reckoning, and the port adds its reckoning for one
card (``per_card_peak_GB``, ``dominant_term``, ``card``).  ``--use-kernel`` is accepted, so that the
reference's command lines run unchanged.
"""

import json
import sys

import pytest

from repro.launch import train as JL
from repro_torch.launch import dryrun as DR
from repro_torch.launch import train as L

SHARED = ("arch", "params_B", "mesh_single_pod", "mesh_multi_pod", "tau", "base_opt",
          "grad_accum")


def _reference_plan(arch, capsys, monkeypatch, *extra) -> dict:
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--plan", *extra])
    JL.main()
    return json.loads(capsys.readouterr().out)


def _pod_record(arch, shape_name, multi_pod, tau=None):
    """A stand-in for the single-pod reckoning, which
    ``test_plan_reads_the_single_pod_reckoning`` and ``test_torch_dryrun.py``
    run for real (every FULL arch's takes ~10-25 s on meta)."""
    assert (shape_name, multi_pod) == ("train_4k", False)
    return {"memory": {"peak_bytes": 12_345_678_901}, "dominant": "collective"}


@pytest.mark.parametrize("arch", DR.ALL_ARCHS)
def test_plan_matches_reference(arch, capsys, monkeypatch):
    theirs = _reference_plan(arch, capsys, monkeypatch)
    monkeypatch.setattr(DR, "reckon_pod", _pod_record)
    L.main(["--arch", arch, "--plan"])
    ours = json.loads(capsys.readouterr().out)
    assert {k: ours[k] for k in SHARED} == {k: theirs[k] for k in SHARED}
    assert ours["dryrun_cmd"] == (f"PYTHONPATH=src python -m repro_torch.launch.dryrun "
                                  f"--arch {arch} --shape train_4k")
    assert ours["card"] == DR.CARD and ours["dominant_term"] in ("compute", "memory")
    assert ours["per_card_peak_GB"] > 0
    # the reference's single-pod fields, from the port's --mesh single record
    assert ours["per_chip_peak_GB"] == 12.35
    assert ours["dominant_roofline_term"] == "collective"


def test_plan_reads_the_single_pod_reckoning():
    """The fields come from rank 0 of the reference's single-pod training
    grid: its 16 rows over TOPO.n_workers_single workers, MODEL_PAR 16."""
    from repro_torch.configs import load_arch

    ours = L.plan("gpt2_small")
    pod = DR.reckon_pod("gpt2_small", "train_4k", False)
    assert ours["per_chip_peak_GB"] == round(pod["memory"]["peak_bytes"] / 1e9, 2)
    assert ours["dominant_roofline_term"] == pod["dominant"]
    W = load_arch("gpt2_small").TOPO.n_workers_single
    assert pod["mesh"] == {"worker": W, "zero": 16 // W, "model": 16}


def test_plan_takes_tau_and_smoke_names(capsys, monkeypatch):
    theirs = _reference_plan("granite_moe_3b_a800m_smoke", capsys, monkeypatch, "--tau", "4")
    ours = L.plan("granite_moe_3b_a800m_smoke", tau=4)
    assert {k: ours[k] for k in SHARED} == {k: theirs[k] for k in SHARED}
    assert ours["tau"] == 4


def test_use_kernel_is_accepted(capsys):
    assert L.build_parser().parse_args(["--use-kernel"]).use_kernel
    assert not L.build_parser().parse_args([]).use_kernel
    # the reference's command line, with the port's --device
    res = L.main(["--device", "cpu", "--steps", "2", "--n-workers", "2", "--tau", "2",
                  "--seq", "32", "--b-micro", "2", "--use-kernel"])
    assert len(res["history"]) == 2
    assert "final eval loss" in capsys.readouterr().out
