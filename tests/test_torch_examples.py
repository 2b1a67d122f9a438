"""The port's example scripts run on the CPU, at fewer steps than their
defaults."""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from test_torch_imports import FORBIDDEN, _imported_modules

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_randomized_sign_theory_runs_on_the_cpu():
    """Lemma 1 from 4,000 draws: each coordinate's mean is within ~3.3
    standard errors (at most 1 / sqrt(4000) each) of v / B over 512
    coordinates, so 0.1 holds; DSM trains with both signs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = _load("torch_randomized_sign_theory").main(["--device", "cpu", "--steps", "2"])
    finally:
        torch.set_num_threads(n)
    assert set(out["lemma1"]) == {"eq9 +-sign", "eq10 zero/sign"}
    assert all(err < 0.1 for err in out["lemma1"].values())
    assert all(math.isfinite(out[m]) for m in ("sign", "rand_pm"))


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("torch_*.py")), ids=lambda p: p.name)
def test_port_examples_import_nothing_of_the_reference(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
