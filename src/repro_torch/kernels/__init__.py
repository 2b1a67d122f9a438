"""Hand-written Hopper kernels of the port, each beside its plain version.

  dsm_update.py   — fused global sign-momentum step (paper eqs. 6-8)
  adamw_update.py — fused AdamW local step (paper Alg. 2)
  _build.py       — nvcc build of csrc/*.cu at first use, loaded via ctypes
"""

from repro_torch.kernels.adamw_update import adamw_update
from repro_torch.kernels.dsm_update import dsm_update

KERNEL_FNS = (dsm_update, adamw_update)


def reset_launch_counts():
    for fn in KERNEL_FNS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_FNS}
