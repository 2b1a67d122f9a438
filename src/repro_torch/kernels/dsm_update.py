"""The DSM global sign-momentum step (paper eqs. 6-8): a CUDA kernel for the
card (``csrc/dsm_update.cu``) and its plain PyTorch version.

Ported from the TPU kernel ``src/repro/kernels/dsm_update.py::_dsm_kernel``.
Both versions update ``x0`` and ``m`` IN PLACE over one flat buffer holding
every parameter leaf, so the global step is one launch.

``dsm_update`` runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.  ``dsm_update.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

F32 = torch.float32
PARAM_DTYPES = (torch.float32, torch.bfloat16)


class DsmConsts(NamedTuple):
    """f32 scalars of one call.  ``1 - beta`` is folded in double precision
    and then rounded to f32, as the reference's Python-float constants are;
    ``eta * gamma`` is an f32 product, as in the reference kernel."""

    gamma: float
    eta_gamma: float
    beta1: float
    omb1: float
    beta2: float
    omb2: float
    lam: float


def dsm_consts(gamma, *, eta, beta1, beta2, lam) -> DsmConsts:
    f = np.float32
    g = f(gamma)
    return DsmConsts(float(g), float(f(eta) * g),  # noqa: RPR002 np.float32s
                     float(f(beta1)), float(f(1.0 - beta1)),  # noqa: RPR002 np.float32s
                     float(f(beta2)), float(f(1.0 - beta2)),  # noqa: RPR002 np.float32s
                     float(f(lam)))  # noqa: RPR002 np.float32s


def sign_like_jnp(u: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: sign(0) = 0 keeping the zero's sign, sign(NaN) = NaN.
    (``torch.sign`` maps NaN and -0 to +0, which would hide corruption.)"""
    return torch.where(u > 0, 1.0, torch.where(u < 0, -1.0, u))


def dsm_update_plain(x0, m, x_tau, gamma, *, eta, beta1, beta2, lam, sign=sign_like_jnp):
    """Plain PyTorch version, same arithmetic and order as the kernel.

    ``sign`` maps u to S(u); the kernel computes only the deterministic
    sign, the default, and the randomized signs of eqs. 9/10 pass theirs."""
    k = dsm_consts(gamma, eta=eta, beta1=beta1, beta2=beta2, lam=lam)
    # divide by a tensor on the data's device: torch turns division by a
    # host scalar into a product with its reciprocal on the card (filled in
    # there: a copy from the host would synchronise the stream)
    g = torch.full((), k.gamma, dtype=F32, device=x0.device)
    x0f = x0.to(F32)
    delta = (x0f - x_tau.to(F32)) / g
    u = k.beta1 * m + k.omb1 * delta
    x_new = x0f - k.eta_gamma * (sign(u) + k.lam * x0f)
    m_new = k.beta2 * m + k.omb2 * delta
    x0.copy_(x_new)
    m.copy_(m_new)
    return x0, m


def _check(x0, m, x_tau):
    if x0.dtype not in PARAM_DTYPES or x_tau.dtype != x0.dtype:
        raise TypeError(f"x0 / x_tau must share a dtype in {PARAM_DTYPES}; "
                        f"got {x0.dtype}, {x_tau.dtype}")
    if m.dtype != F32:
        raise TypeError(f"m must be float32, got {m.dtype}")
    if not (x0.shape == m.shape == x_tau.shape):
        raise ValueError(f"shape mismatch: {x0.shape}, {m.shape}, {x_tau.shape}")
    if not (x0.is_contiguous() and m.is_contiguous() and x_tau.is_contiguous()):
        raise ValueError("x0, m and x_tau must be contiguous")
    if not (x0.device == m.device == x_tau.device):
        raise ValueError(f"device mismatch: {x0.device}, {m.device}, {x_tau.device}")


def _lib():
    lib = _build.load("dsm_update")
    if not getattr(lib, "_typed", False):
        vp, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        for fn in (lib.dsm_update_f32, lib.dsm_update_bf16):
            fn.argtypes = [vp, vp, vp, i64] + [f32] * 7 + [vp]
            fn.restype = ctypes.c_int
        lib.dsm_update_error_string.argtypes = [ctypes.c_int]
        lib.dsm_update_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def dsm_update(x0, m, x_tau, gamma, *, eta, beta1, beta2, lam):
    """Global sign-momentum step, in place: x0 <- x_{t+1,0}, m <- m_{t+1}.

    x0 / x_tau: param dtype (f32 or bf16); m: f32; all of one shape.
    Returns (x0, m).
    """
    _check(x0, m, x_tau)
    if x0.device.type == "cpu":
        return dsm_update_plain(x0, m, x_tau, gamma, eta=eta, beta1=beta1, beta2=beta2,
                                lam=lam)
    if x0.device.type != "cuda":
        raise ValueError(f"dsm_update runs on cpu or cuda tensors, got {x0.device}")
    for t in (x0, m, x_tau):
        if t.data_ptr() % 16:
            raise ValueError("dsm_update needs 16-byte aligned buffers")
    k = dsm_consts(gamma, eta=eta, beta1=beta1, beta2=beta2, lam=lam)
    lib = _lib()
    fn = lib.dsm_update_f32 if x0.dtype == F32 else lib.dsm_update_bf16
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = fn(x0.data_ptr(), m.data_ptr(), x_tau.data_ptr(), x0.numel(), *k, stream)
    if err:
        raise RuntimeError(f"dsm_update launch failed: "
                           f"{lib.dsm_update_error_string(err).decode()}")
    dsm_update.launches += 1
    return x0, m


dsm_update.launches = 0
