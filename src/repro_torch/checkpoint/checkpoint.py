"""Tree checkpoints in the reference's format (``repro.checkpoint``): one
``.npz`` of arrays ``a0, a1, ...`` and a ``.json`` sidecar listing each
array's ``/``-joined tree path and dtype, bf16 stored as a ``uint16`` view
tagged ``__bf16__``.  Either package restores the other's files.

A tree is nested dicts (keys may themselves hold ``/``) whose leaves are
torch tensors on any device.

Crash safety: ``save`` writes both files to temporaries and ``os.replace``s
them into place, npz first and json last, so the json is the commit marker:
a checkpoint is complete iff both files exist.  The rotated manager
(``save_checkpoint`` / ``latest_checkpoint`` / ``restore_latest``) keeps a
``latest`` pointer and the newest ``keep`` complete checkpoints.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Optional

import numpy as np
import torch

_BF16_TAG = "__bf16__"
_CKPT_PREFIX = "ckpt_"
_LATEST = "latest"

def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` with dict keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return [(prefix, tree)]


def _unflatten_like(like: Any, values: dict, prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten_like(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    return values[prefix]


def _dtype_tag(leaf: torch.Tensor) -> str:
    """The reference's name of the leaf's dtype (numpy's, or ``__bf16__``)."""
    if leaf.dtype == torch.bfloat16:
        return _BF16_TAG
    return str(leaf.dtype).removeprefix("torch.")


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """The leaf as numpy, bf16 as its uint16 bit pattern (bit-exact)."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _atomic_replace(target: str, write_fn, mode: str) -> None:
    """Write via a same-directory temp file + ``os.replace`` (atomic on
    POSIX): readers never observe a torn ``target``."""
    tmp = f"{target}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save(path: str, tree: Any, step: int = 0, extra: Optional[dict] = None) -> None:
    """Atomically save ``tree`` as ``path.npz`` + ``path.json``; ``extra``
    is JSON metadata kept in the sidecar (:func:`load_meta`)."""
    arrays, meta = {}, {"step": step, "keys": []}
    if extra is not None:
        meta["extra"] = extra
    for i, (p, leaf) in enumerate(flatten(tree)):
        arrays[f"a{i}"] = _to_numpy(leaf)
        meta["keys"].append([p, _dtype_tag(leaf)])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # npz first, json last: the json is the commit marker
    _atomic_replace(path + ".npz", lambda f: np.savez(f, **arrays), "wb")
    _atomic_replace(path + ".json", lambda f: json.dump(meta, f), "w")


def is_complete(path: str) -> bool:
    return os.path.exists(path + ".npz") and os.path.exists(path + ".json")


def load_meta(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)


def restore(path: str, like: Any) -> tuple[Any, int]:
    """Restore the paths of ``like`` (a tree of the same form; only its
    leaves' dtypes and shapes are read) as CPU torch tensors.  A dtype or
    shape that differs from ``like``'s, or a missing path, raises."""
    meta = load_meta(path)
    saved = {k: i for i, (k, _) in enumerate(meta["keys"])}
    values = {}
    with np.load(path + ".npz") as data:
        for pstr, leaf in flatten(like):
            if pstr not in saved:
                raise KeyError(f"checkpoint missing leaf {pstr}")
            i = saved[pstr]
            got, want = meta["keys"][i][1], _dtype_tag(leaf)
            if got != want:
                raise ValueError(f"dtype mismatch for {pstr}: checkpoint has {got}, "
                                 f"expected {want}")
            arr = data[f"a{i}"]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {pstr}: {arr.shape} vs {tuple(leaf.shape)}")
            t = torch.from_numpy(arr)
            values[pstr] = t.view(torch.bfloat16) if got == _BF16_TAG else t
    return _unflatten_like(like, values), meta["step"]


# ---------------------------------------------------------------------------
# Rotated checkpoint directory: ckpt_<step> files, a `latest` pointer, and
# retention of the last `keep` complete checkpoints.
# ---------------------------------------------------------------------------

def step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_CKPT_PREFIX}{step:08d}")


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    """Sorted ``(step, base_path)`` for every COMPLETE checkpoint."""
    out = []
    for j in glob.glob(os.path.join(directory, f"{_CKPT_PREFIX}*.json")):
        base = j[: -len(".json")]
        if not os.path.exists(base + ".npz"):
            continue  # torn write: npz landed, json (commit marker) did not
        try:
            step = int(os.path.basename(base)[len(_CKPT_PREFIX):])
        except ValueError:
            continue
        out.append((step, base))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[str]:
    """Base path of the newest complete checkpoint (``latest`` pointer with
    a scan fallback for a stale or missing pointer), or None."""
    ptr = os.path.join(directory, _LATEST)
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        base = os.path.join(directory, name)
        if name and is_complete(base):
            return base
    cks = list_checkpoints(directory)
    return cks[-1][1] if cks else None


def save_checkpoint(directory: str, tree: Any, step: int, keep: int = 3,
                    extra: Optional[dict] = None) -> str:
    """Atomic rotated save: write ``ckpt_<step>``, repoint ``latest``, prune
    all but the newest ``keep`` complete checkpoints.  Returns the base path."""
    base = step_path(directory, step)
    save(base, tree, step=step, extra=extra)
    _atomic_replace(os.path.join(directory, _LATEST),
                    lambda f: f.write(os.path.basename(base)), "w")
    if keep and keep > 0:
        for _, old in list_checkpoints(directory)[:-keep]:
            for suffix in (".npz", ".json"):
                try:
                    os.remove(old + suffix)
                except OSError:
                    pass
    return base


def restore_latest(directory: str, like: Any) -> Optional[tuple[Any, int, dict]]:
    """Restore the newest complete checkpoint: ``(tree, step, extra)``, or
    None when the directory holds no complete checkpoint."""
    base = latest_checkpoint(directory)
    if base is None:
        return None
    tree, step = restore(base, like)
    return tree, step, load_meta(base).get("extra") or {}
