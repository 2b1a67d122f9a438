"""The port stands alone: nothing under src/repro_torch/ and nothing in
chip_smoke.py imports JAX or the JAX package, and the entry points run on
the card unless told otherwise."""

import ast
import inspect
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train as launch
from repro_torch.train import trainer

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks", "flax", "optax")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "dsm.py", "trainer.py", "adamw_update.py"} <= names
    rel = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    assert {f"obs/{m}.py" for m in ("sinks", "tracing", "comm_model", "ledger", "summarize",
                                    "__main__")} | {"analysis/sanitize.py"} <= rel
    # the arch registry (every reference arch id) and serving
    archs = ("gpt2_small", "gpt2_medium", "gpt2_large", "deepseek_67b", "gemma3_1b",
             "granite_34b", "granite_moe_3b_a800m", "llama4_maverick_400b_a17b",
             "llava_next_34b", "mamba2_780m", "minitron_4b", "recurrentgemma_2b",
             "whisper_large_v3")
    assert {f"configs/{a}.py" for a in archs} | {"configs/specs.py", "train/serve.py"} <= rel


def test_entry_points_default_to_the_card():
    assert inspect.signature(trainer.run_training).parameters["device"].default is None
    assert launch.build_parser().parse_args([]).device == "cuda"
    assert trainer.resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert trainer.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.resolve_device()
