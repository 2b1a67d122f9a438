"""One fused AdamW step (paper Alg. 2): a CUDA kernel for the card
(``csrc/adamw_update.cu``) and its plain PyTorch version.

Ported from the TPU kernel ``src/repro/kernels/adamw_update.py::_adamw_kernel``.
Both versions update ``p``, ``m`` and ``v`` IN PLACE; on the training path
they run over the flat ``(W, N)`` worker buffers, so one local step of all
workers is one launch.

``round_direction`` picks the rounding:

  * ``False``: what ``_adamw_kernel`` computes, p' rounded once to p.dtype.
  * ``True``: what the reference training path computes,
    ``base_opt.adamw().direction`` (d rounded to p.dtype) followed by the
    local update ``(p - gamma * d)`` in f32, rounded again.

The two agree for f32 params and differ for bf16.

``adamw_update`` runs the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``adamw_update.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

F32 = torch.float32
PARAM_DTYPES = (torch.float32, torch.bfloat16)


class AdamWConsts(NamedTuple):
    """f32 scalars of one call.  The bias corrections 1 - beta^(step+1) are
    f32 on the host; ``1 - beta`` is folded in double precision and rounded
    to f32, as the reference's Python-float constants are."""

    lr: float
    bc1: float
    bc2: float
    beta1: float
    omb1: float
    beta2: float
    omb2: float
    eps: float
    wd: float


def adamw_consts(gamma, step, *, beta1, beta2, eps, wd) -> AdamWConsts:
    f = np.float32
    c = f(step) + f(1.0)
    bc1 = f(1.0) - f(beta1) ** c
    bc2 = f(1.0) - f(beta2) ** c
    return AdamWConsts(float(f(gamma)), float(bc1), float(bc2),  # noqa: RPR002 np.float32s
                       float(f(beta1)), float(f(1.0 - beta1)),  # noqa: RPR002 np.float32s
                       float(f(beta2)), float(f(1.0 - beta2)),  # noqa: RPR002 np.float32s
                       float(f(eps)), float(f(wd)))  # noqa: RPR002 np.float32s


def moments_and_direction(p, g, m, v, k: AdamWConsts, round_direction: bool):
    """f32 (m', v', d) of one AdamW step; d is not yet rounded to p.dtype."""
    pf, gf = p.to(F32), g.to(F32)
    dev = p.device
    # divide by tensors on the data's device: torch turns division by a
    # host scalar into a product with its reciprocal on the card (filled in
    # there: a copy from the host would synchronise the stream)
    bc1 = torch.full((), k.bc1, dtype=F32, device=dev)
    bc2 = torch.full((), k.bc2, dtype=F32, device=dev)
    m_new = k.beta1 * m + k.omb1 * gf
    if round_direction:
        v_new = k.beta2 * v + k.omb2 * (gf * gf)
    else:
        v_new = k.beta2 * v + (k.omb2 * gf) * gf
    d = (m_new / bc1) / (torch.sqrt(v_new / bc2) + k.eps) + k.wd * pf
    return m_new, v_new, d


def adamw_update_plain(p, g, m, v, gamma, step, *, beta1=0.9, beta2=0.95, eps=1e-8,
                       wd=0.1, round_direction=True):
    """Plain PyTorch version, same arithmetic and order as the kernel."""
    k = adamw_consts(gamma, step, beta1=beta1, beta2=beta2, eps=eps, wd=wd)
    m_new, v_new, d = moments_and_direction(p, g, m, v, k, round_direction)
    if round_direction:
        d = d.to(p.dtype).to(F32)
    p_new = p.to(F32) - k.lr * d
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)
    return p, m, v


def _check(p, g, m, v):
    if p.dtype not in PARAM_DTYPES or g.dtype != p.dtype:
        raise TypeError(f"p / g must share a dtype in {PARAM_DTYPES}; got {p.dtype}, {g.dtype}")
    if m.dtype != F32 or v.dtype != F32:
        raise TypeError(f"m and v must be float32, got {m.dtype}, {v.dtype}")
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"shape mismatch: {p.shape}, {g.shape}, {m.shape}, {v.shape}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("p, g, m and v must be contiguous")
    if not (p.device == g.device == m.device == v.device):
        raise ValueError(f"device mismatch: {p.device}, {g.device}, {m.device}, {v.device}")


def _lib():
    lib = _build.load("adamw_update")
    if not getattr(lib, "_typed", False):
        vp, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        for fn in (lib.adamw_update_f32, lib.adamw_update_bf16):
            fn.argtypes = [vp, vp, vp, vp, i64] + [f32] * 9 + [ctypes.c_int, vp]
            fn.restype = ctypes.c_int
        lib.adamw_update_error_string.argtypes = [ctypes.c_int]
        lib.adamw_update_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def adamw_update(p, g, m, v, gamma, step, *, beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1,
                 round_direction=True):
    """One AdamW step with learning rate ``gamma`` at 0-indexed ``step``, in
    place on p (param dtype), m and v (f32).  Returns (p, m, v)."""
    _check(p, g, m, v)
    if p.device.type == "cpu":
        return adamw_update_plain(p, g, m, v, gamma, step, beta1=beta1, beta2=beta2, eps=eps,
                                  wd=wd, round_direction=round_direction)
    if p.device.type != "cuda":
        raise ValueError(f"adamw_update runs on cpu or cuda tensors, got {p.device}")
    for t in (p, g, m, v):
        if t.data_ptr() % 16:
            raise ValueError("adamw_update needs 16-byte aligned buffers")
    k = adamw_consts(gamma, step, beta1=beta1, beta2=beta2, eps=eps, wd=wd)
    lib = _lib()
    fn = lib.adamw_update_f32 if p.dtype == F32 else lib.adamw_update_bf16
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(), *k,
                 int(round_direction), stream)  # noqa: RPR002 a Python bool
    if err:
        raise RuntimeError(f"adamw_update launch failed: "
                           f"{lib.adamw_update_error_string(err).decode()}")
    adamw_update.launches += 1
    return p, m, v


adamw_update.launches = 0
