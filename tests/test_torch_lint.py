"""The port's RPR lint (``repro_torch.analysis.lint``) against the
reference's (``repro.analysis.lint``): the rules they share give the same
findings on the reference's own snippets, each eager-PyTorch rule has a
positive and a negative case, the CLI keeps the reference's exit codes, and
the port's own source lints clean while a host sync planted in its outer
step or its MoE layer is caught."""

import ast
import json
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint_source as ref_lint_source
from repro_torch.analysis import lint_paths, lint_source
from repro_torch.analysis.__main__ import main

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
DSM = "src/repro_torch/core/dsm.py"     # a path whose step roots the table lists


def _found(src: str, path: str = "<string>") -> list:
    return [(f.rule, f.line, f.col) for f in lint_source(textwrap.dedent(src), path)]


def _rules(src: str, path: str = "<string>") -> list:
    return [rule for rule, _, _ in _found(src, path)]


# the reference's RPR004 snippets (tests/test_analysis.py) and a syntax error
SHARED = {
    "rpr004_positive": """
        import dataclasses
        @dataclasses.dataclass
        class Config:
            layers: list = []
        def f(xs=[]):
            return xs
    """,
    "rpr004_factory_negative": """
        import dataclasses
        @dataclasses.dataclass
        class Config:
            layers: list = dataclasses.field(default_factory=list)
        def f(xs=()):
            return xs
    """,
    "rpr004_call_defaults": """
        def f(a=dict(), *, b=set(), c=None):
            return a, b, c
    """,
    "rpr000_syntax_error": """
        def f(:
            return 1
    """,
}


@pytest.mark.parametrize("name", list(SHARED))
def test_shared_rules_match_the_reference(name):
    src = textwrap.dedent(SHARED[name])
    ours = [(f.rule, f.line, f.col) for f in lint_source(src)]
    theirs = [(f.rule, f.line, f.col) for f in ref_lint_source(src)]
    assert ours == theirs
    assert ours or "negative" in name


# ---------------------------------------------------------------------------
# RPR001: the global generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call,flagged", [
    ("torch.randn(3)", True),
    ("torch.rand_like(x)", True),
    ("torch.randint(0, 4, (2,))", True),
    ("x.uniform_(0, 1)", True),
    ("torch.nn.init.normal_(x)", True),
    ("torch.manual_seed(0)", True),
    ("torch.cuda.manual_seed_all(0)", True),
    ("torch.randn(3, generator=g)", False),
    ("x.uniform_(0, 1, generator=g)", False),
    ("torch.Generator().manual_seed(0)", False),
    ("g.manual_seed(0)", False),
    ("torch.zeros(3)", False),
])
def test_rpr001_global_generator(call, flagged):
    src = f"import torch\ndef helper(x, g):\n    return {call}\n"
    assert _rules(src) == (["RPR001"] if flagged else [])


# ---------------------------------------------------------------------------
# RPR002 / RPR003: step-reachable code
# ---------------------------------------------------------------------------

STEP = """
    import torch
    def make_dsm_step(loss_fn):
        def outer_step(state, batch):
            return state.x0.sum().item()
        return outer_step
    def unreachable_helper(x):
        return x.sum().item()
"""


def test_rpr002_item_in_the_outer_step_not_in_an_unreachable_helper():
    assert _found(STEP, DSM) == [("RPR002", 5, 15)]
    assert _found(STEP) == []       # outside the package: no table roots


@pytest.mark.parametrize("expr", ["float(x.sum())", "x.tolist()", "x.cpu()", "x.numpy()",
                                  'x.to("cpu")', "np.asarray(x)", "torch.cuda.synchronize()"])
def test_rpr002_every_host_sync_form(expr):
    src = f"import numpy as np, torch\ndef worker_grads(x):\n    return {expr}\n"
    assert _rules(src, DSM) == ["RPR002"]


def test_rpr002_negative_host_values():
    src = """
        import torch
        def worker_grads(x, n):
            y = x.to("cuda")
            return float(1.0), y.to(torch.bfloat16), n + 1
    """
    assert _rules(src, DSM) == []


@pytest.mark.parametrize("wrapper", ["torch.utils.checkpoint.checkpoint(body, x)",
                                     "torch.compile(body)(x)", "torch.func.vmap(body)(x)",
                                     "checkpoint(body, x)"])
def test_reachability_through_a_callback(wrapper):
    src = f"""
        import torch
        from torch.utils.checkpoint import checkpoint
        def _read(x):
            return x.item()
        def body(x):
            return _read(x)
        def run(x):
            return {wrapper}
    """
    assert _found(src) == [("RPR002", 5, 11)]


def test_reachability_inside_a_cuda_graph_capture():
    src = """
        import torch
        def step(x):
            return x.item()
        def capture(x, g):
            with torch.cuda.graph(g):
                step(x)
    """
    assert _rules(src) == ["RPR002"]


def test_noqa_suppression():
    src = """
        import torch
        def worker_grads(x):
            a = x.item()  # noqa: RPR002 read once for the log
            b = x.item()  # noqa: RPR003
            return a, b, x.item()  # noqa
    """
    assert _found(src, DSM) == [("RPR002", 5, 8)]


@pytest.mark.parametrize("test,flagged", [
    ("torch.any(x)", True),
    ("bad", True),                  # a local assigned from a torch call
    ("(bad > 0) and n", True),
    ("n > 0", False),
    ("bad is None", False),         # identity reads no value
    ("isinstance(bad, tuple)", False),
    ("torch.cuda.is_available()", False),
    ("torch.is_floating_point(x)", False),
])
def test_rpr003_branch_on_a_tensor(test, flagged):
    src = f"""
        import torch
        def worker_grads(x, n):
            bad = torch.isfinite(x).all()
            if {test}:
                return 1
            while {test}:
                n -= 1
            return 0
    """
    assert _rules(src, DSM) == (["RPR003", "RPR003"] if flagged else [])


# ---------------------------------------------------------------------------
# The CLI and the port's own source
# ---------------------------------------------------------------------------

def test_lint_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\ndef f():\n    return torch.randn(3)\n")
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert main(["lint", str(bad)]) == 1
    assert main(["lint", str(clean)]) == 0
    assert main(["lint", "--select", "RPR999", str(bad)]) == 2
    assert main(["lint", "--select", "RPR004", str(bad)]) == 0
    capsys.readouterr()
    assert main(["lint", "--json", str(bad)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out[0]["rule"] == "RPR001" and out[0]["path"].endswith("bad.py")


def test_port_source_is_clean(capsys):
    """Sanctioned sync points carry ``# noqa`` with their reason."""
    findings = lint_paths([str(PORT)])
    assert findings == [], "\n".join(str(f) for f in findings)
    assert main(["lint", str(PORT)]) == 0
    assert capsys.readouterr().out.strip().endswith("0 finding(s)")
    for path in PORT.rglob("*.py"):
        for line in path.read_text().splitlines():
            if "# noqa: RPR" in line:
                assert len(line.split("# noqa: RPR", 1)[1].split()) > 1, line   # a reason


@pytest.mark.parametrize("rel,anchor,plant", [
    ("core/dsm.py", "        gamma_t = schedule(state.t)",
     "        state.x0.sum().item()\n"),
    ("models/layers.py", "    B, S, d = x.shape\n",
     "    x.sum().item()\n"),
])
def test_planted_host_sync_in_a_copy_of_the_port_is_flagged(tmp_path, rel, anchor, plant):
    """A copy of the module, kept at its path within the package so that the
    root table applies, with a ``.item()`` in the outer step / moe_apply."""
    src = (PORT / rel).read_text()
    assert src.count(anchor) == 1
    at = src.index(anchor)
    planted = src[:at] + plant + src[at:]
    line = planted[:at].count("\n") + 1
    copy = tmp_path / "repro_torch" / rel
    copy.parent.mkdir(parents=True)
    copy.write_text(planted)
    assert [(f.rule, f.line) for f in lint_paths([str(tmp_path)])] == [("RPR002", line)]


def test_lint_imports_neither_torch_nor_the_packages():
    tree = ast.parse((PORT / "analysis" / "lint.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m.split(".")[0] for m in mods} & {"torch", "repro", "repro_torch", "jax"}
