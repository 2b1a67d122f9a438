"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc`` for Hopper (``sm_90a``) into ``<repo>/build/kernels/``; the
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  ``build_all`` starts one
``nvcc`` per source, all at once.

``--fmad=false`` keeps every multiply and add separately rounded, so each
kernel agrees bit for bit with its plain PyTorch version.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card usually has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("dsm_update", "adamw_update")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                       "CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, temp path, final path)."""
    out = lib_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    """Wait for nvcc and install its library; raises with nvcc's output."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never leaves half a file
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel; returns nvcc's output (ptxas
    register/spill report) by kernel name ('' when already built).  Every
    nvcc is waited for before a failure is raised."""
    started = {name: _start(name) for name in KERNELS}
    logs, errors = {}, []
    for name in KERNELS:
        try:
            logs[name] = _finish(name, *started[name])
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, *_start(name))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
