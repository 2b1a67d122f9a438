"""Placement rules: which mesh axis each dim of each parameter, batch and
cache leaf lies on, ported from the reference's ``distributed/sharding.py``.

Training mesh axes: ``("worker", "zero", "model")``
  worker — the paper's n workers (local-step isolation; pod*data rows)
  zero   — FSDP/ZeRO shard *within* a worker
  model  — tensor parallel within a worker

Serving mesh axes: ``("data", "model")``.

Rules are name-aware (Megatron-style column/row parallel) with a generic
divisibility fallback; dims that don't divide are replicated.

A placement is a tuple with one entry per dim of the leaf: ``None``, an axis
name, or a tuple of axis names, exactly the entries of the reference's
``PartitionSpec``.  Leaves are keyed by the port's dotted leaf names
(``"decoder.blocks.p0.attn.wq"``), the reference's tree paths; the rules
read only names and shapes, so this module is pure Python.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.convert import flatten_tree

# leaf-name -> which dim (from the end, ignoring stacked prefixes) is the
# model-parallel one. "col": last dim; "row": second-to-last dim.
_COL = ("wq", "wk", "wv", "w1", "w3", "in_proj", "in_x", "in_gate",
        "w_a", "w_x", "lm_head", "patch_proj", "we1", "we3")
_ROW = ("wo", "w2", "out_proj", "out", "we2")


def _model_dim(name: str, shape: tuple, i0: int, model: int) -> Optional[int]:
    nd = len(shape)
    if nd - i0 < 1:
        return None
    if name == "embed":
        # vocab-parallel: logits shard over V; the lookup becomes a masked
        # gather and a small all-reduce of (B, S, d)
        cands = [i0, nd - 1]
    elif name in _COL:
        cands = [nd - 1, nd - 2]
    elif name in _ROW:
        cands = [nd - 2, nd - 1]
    else:
        cands = [nd - 1, nd - 2]
    for c in cands:
        if c >= i0 and shape[c] % model == 0 and shape[c] >= model:
            return c
    return None


def _pick_dim(shape: tuple, i0: int, size: int, taken: set) -> Optional[int]:
    """Largest eligible dim divisible by ``size``."""
    best = None
    for i in range(i0, len(shape)):
        if i in taken or shape[i] % size != 0 or shape[i] < size:
            continue
        if best is None or shape[i] > shape[best]:
            best = i
    return best


def _leaf_name(path: str) -> str:
    """The last key of a dotted path that is a dict key (a tuple index is
    not, as in the reference's ``_leaf_name``)."""
    for key in reversed(path.split(".")):
        if not key.isdigit():
            return key
    return ""


def _joined(path: str) -> str:
    """The reference's ``"/".join`` of the path's keys."""
    return path.replace(".", "/")


def param_pspecs(shapes: dict, *, model: int, zero: int = 1, worker_axis: bool = False,
                 zero_axes=("zero",), model_axis: str = "model",
                 replicate_names: tuple = ()) -> dict:
    """``{path: placement}`` for ``{path: shape}`` of a parameter tree.

    ``worker_axis``: leaves carry a leading per-worker dim -> "worker".
    ``zero_axes``: mesh axes for the FSDP dim (e.g. ("zero",) or
    ("worker","zero") for fully-sharded global buffers)."""

    def spec_for(path: str, shape: tuple) -> tuple:
        shape = tuple(shape)
        name = _leaf_name(path)
        spec = [None] * len(shape)
        i0 = 0
        if worker_axis:
            if len(shape) == 0:
                return ()
            spec[0] = "worker"
            i0 = 1
        # stacked-layer dim (scan) right after worker dim: leave unsharded
        if "blocks" in _joined(path) and len(shape) > i0:
            i0 += 1
        taken = set()
        md = (_model_dim(name, shape, i0, model)
              if model > 1 and name not in replicate_names else None)
        if md is not None:
            spec[md] = model_axis
            taken.add(md)
        if zero > 1:
            zd = _pick_dim(shape, i0, zero, taken)
            if zd is not None:
                spec[zd] = tuple(zero_axes) if len(zero_axes) > 1 else zero_axes[0]
        return tuple(spec)

    return {path: spec_for(path, shape) for path, shape in shapes.items()}


def _is_float(dtype) -> bool:
    return dtype.is_floating_point if isinstance(dtype, torch.dtype) else (
        str(dtype).startswith(("float", "bfloat")))


def _shape_dtype(leaf) -> tuple:
    """(shape, dtype) of a tensor (any device, ``meta`` included) or a
    ``(shape, dtype)`` pair."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    return tuple(leaf[0]), leaf[1]


def train_batch_pspecs(batch: dict, zero: int = 1, model: int = 1) -> dict:
    """Batch leaves (W, tau, accum, B_micro, ...): worker on W, zero on B.

    Float leaves (stub frame/patch embeddings) also shard their trailing
    feature dim over model — they are the dominant input bytes for
    audio/VLM archs."""

    def spec_for(leaf) -> tuple:
        shape, dtype = _shape_dtype(leaf)
        spec = [None] * len(shape)
        spec[0] = "worker"
        if len(shape) > 3 and zero > 1 and shape[3] % zero == 0 and shape[3] >= zero:
            spec[3] = "zero"
        if (model > 1 and len(shape) > 4 and _is_float(dtype)
                and shape[-1] % model == 0 and shape[-1] >= model):
            spec[-1] = "model"
        return tuple(spec)

    return {k: spec_for(v) for k, v in batch.items()}


def serve_batch_pspecs(batch: dict, data: int, model: int) -> dict:
    """Prefill batch (B, S, ...): B over data (fallback: S)."""

    def spec_for(leaf) -> tuple:
        shape, _ = _shape_dtype(leaf)
        spec = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % data == 0 and shape[0] >= data:
            spec[0] = "data"
        elif len(shape) >= 2 and shape[1] % data == 0:
            spec[1] = "data"
        return tuple(spec)

    return {k: spec_for(v) for k, v in batch.items()}


def cache_pspecs(cache, data: int, model: int) -> dict:
    """KV/state cache sharding: batch dim over data (fallback: seq), last
    divisible dim over model.  ``cache``: the nested cache tree
    (``models.transformer.init_cache``, e.g. on ``meta``); returns
    ``{dotted path: placement}``."""

    def spec_for(path: str, leaf) -> tuple:
        shape, _ = _shape_dtype(leaf)
        spec = [None] * len(shape)
        i0 = 1 if ("blocks" in _joined(path) and len(shape) > 1) else 0
        taken = set()
        # data axis: prefer batch dim (i0), else next dims
        dd = None
        for i in range(i0, len(shape)):
            if shape[i] % data == 0 and shape[i] >= data:
                dd = i
                break
        if dd is not None and data > 1:
            spec[dd] = "data"
            taken.add(dd)
        # model axis: last divisible dim
        if model > 1:
            for i in range(len(shape) - 1, i0 - 1, -1):
                if i not in taken and shape[i] % model == 0 and shape[i] >= model:
                    spec[i] = "model"
                    break
        return tuple(spec)

    leaves = flatten_tree(cache, is_leaf=lambda x: isinstance(x, torch.Tensor))
    return {path: spec_for(path, leaf) for path, leaf in leaves}


def model_dim(spec: tuple, axis: str = "model") -> Optional[int]:
    """The dim of a placement that lies on ``axis`` (alone or among other
    axes), or None."""
    for i, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i
    return None
