"""The port's example scripts run on the CPU, at fewer steps than their
defaults; each counterpart of a reference example runs that example's
config, settings and corpus."""

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
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


class _Stop(Exception):
    """Ends a reference example once its runs' arguments are captured."""


# example -> (the reference's file, its run_training calls)
PAIRS = {"torch_quickstart": ("quickstart", 2), "torch_train_gpt2_dsm": ("train_gpt2_dsm", 1),
         "torch_serve_model": ("serve_model", 1)}


def _reference_runs(monkeypatch, name: str) -> list:
    """``[(cfg, settings, corpus)]`` of each ``run_training`` call the
    reference example makes with its default flags, from the repository's
    root (its corpus path is relative); the training itself is not run."""
    ref, calls = PAIRS[name]
    mod = _load(ref)
    seen = []

    def capture(cfg, s, corpus, **kw):
        seen.append((cfg, s, corpus))
        if len(seen) == calls:
            raise _Stop
        return {"final_eval": 0.0, "comm_rounds": 0, "tokens": 0}

    monkeypatch.setattr(mod, "run_training", capture)
    monkeypatch.setattr(sys, "argv", [ref + ".py"])
    monkeypatch.chdir(EXAMPLES.parent)
    with pytest.raises(_Stop):
        mod.main()
    return seen


def _port_defaults(mod, name: str) -> list:
    """``[(cfg, settings)]`` of the port example's runs at its defaults."""
    if name == "torch_quickstart":
        return [(mod.CFG, s) for s in mod.settings().values()]
    if name == "torch_train_gpt2_dsm":
        return [mod.build(mod.parse([]))]
    return [(mod.CFG, mod.settings())]


def _fields_equal(ours, theirs, skip=()) -> None:
    for f in dataclasses.fields(theirs):
        if f.name not in skip:
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("name", list(PAIRS))
def test_port_example_is_the_reference_example(monkeypatch, name):
    """The port example's model config and TrainSettings equal the
    reference example's, field by field (``use_kernel``, which the port's
    settings lack: its deterministic global step is always the DSM
    kernel's wrapper); its corpus draws the reference's samples; then it
    runs two outer steps on the CPU with finite losses."""
    theirs = _reference_runs(monkeypatch, name)
    mod = _load(name)
    ours = _port_defaults(mod, name)
    assert len(ours) == len(theirs)
    for (cfg, s), (jcfg, js, _) in zip(ours, theirs):
        _fields_equal(cfg, jcfg)
        _fields_equal(s, js, skip=("use_kernel",))
    corpora, run = [], mod.run_training

    def recording(cfg, s, corpus, **kw):
        corpora.append(corpus)
        return run(cfg, s, corpus, **kw)

    monkeypatch.setattr(mod, "run_training", recording)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = mod.main(["--device", "cpu", "--steps", "2"])
    finally:
        torch.set_num_threads(n)
    for corpus, (_, _, jcorpus) in zip(corpora, theirs, strict=True):
        a, b = (c.sample(np.random.default_rng(0), 4, 64) for c in (corpus, jcorpus))
        assert np.array_equal(a, b)
    results = list(out.values()) if name == "torch_quickstart" else [out]
    for r in results:
        assert len(r["history"]) == 2 and all(math.isfinite(x) for x in r["history"])
        assert math.isfinite(r["final_eval"])
    if name == "torch_serve_model":
        assert tuple(out["tokens"].shape) == (len(mod.PROMPTS), mod.NEW_TOKENS)
