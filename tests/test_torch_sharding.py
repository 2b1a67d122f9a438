"""The port's placement rules and pod meshes against the JAX package's
``distributed/sharding.py`` and ``launch/mesh.py``, on the CPU.

  * ``param_pspecs``: for every arch id of ``ARCH_IDS`` and
    ``PAPER_ARCH_IDS`` on both pod meshes, the port's placement of each leaf
    equals ``tuple(PartitionSpec)`` of the reference's, in every role its
    dry-run gives it: the worker params and the base state
    (``worker_axis``), x0 and m (``zero_axes=("worker", "zero")``), the
    serving params (``zero_axes=("data",)``), and each with
    ``replicate_names=ATTN_NAMES``.
  * ``train_batch_pspecs``, ``serve_batch_pspecs`` and ``cache_pspecs``
    equal the reference's on the spec'd shapes of every admitted input
    shape.
  * The port's grids equal the reference's ``training_mesh`` /
    ``serving_mesh`` device grids as index arrays (the reference runs in a
    subprocess with 512 forced host devices, as its dry-run sets them).
  * ``shard_leaf`` then ``gather_leaf`` is the identity, bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import load_arch as j_load_arch
from repro.configs import specs as JS
from repro.distributed import sharding as JSH
from repro.launch.dryrun import ATTN_NAMES
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, PAPER_ARCH_IDS, arch_supports_shape
from repro_torch.configs import load_arch, specs
from repro_torch.distributed import mesh as M
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.groups import parts
from repro_torch.launch.train import resolve_arch
from repro_torch.models import convert
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
ARCHS = PAPER_ARCH_IDS + ARCH_IDS
PODS = {"single": False, "multi": True}


def _ref_specs(tree) -> dict:
    """``{dotted path: tuple(PartitionSpec)}`` of a reference spec tree."""
    flat = convert.flatten_tree(tree, is_leaf=lambda x: isinstance(x, P))
    return {k: tuple(v) for k, v in flat}


def _with_workers(tree, W):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct((W,) + tuple(x.shape), x.dtype), tree)


@pytest.mark.parametrize("multi", PODS.values(), ids=PODS.keys())
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_match_reference(arch, multi):
    jm = j_load_arch(arch)
    cfg = load_arch(arch).FULL
    W = jm.TOPO.n_workers_multi if multi else jm.TOPO.n_workers_single
    rows = 32 if multi else 16
    zero, data = rows // W, rows
    aps = JS.abstract_params(jm.FULL)
    shapes = dict(zip(T.layout(cfg).names, T.layout(cfg).shapes))
    assert sorted(shapes) == sorted(_ref_specs(jax.tree.map(lambda x: P(), aps)))
    worker_shapes = {k: (W,) + s for k, s in shapes.items()}
    for rep in ((), ATTN_NAMES):
        roles = {
            "worker": (_with_workers(aps, W), worker_shapes,
                       dict(zero=zero, worker_axis=True)),
            "global": (aps, shapes, dict(zero=zero * W, zero_axes=("worker", "zero"))),
            "serve": (aps, shapes, dict(zero=data, zero_axes=("data",))),
        }
        for role, (tree, ours, kw) in roles.items():
            theirs = _ref_specs(JSH.param_pspecs(tree, model=M.MODEL_PAR,
                                                 replicate_names=rep, **kw))
            got = SH.param_pspecs(ours, model=M.MODEL_PAR, replicate_names=rep, **kw)
            assert got == theirs, (arch, role, rep)


def _admitted(arch):
    jm, m = j_load_arch(arch), load_arch(arch)
    for name in INPUT_SHAPES:
        if arch_supports_shape(m.FULL, m.TOPO, name):
            yield jm, m, name


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_placements_match_reference(arch):
    for multi in PODS.values():
        rows = 32 if multi else 16
        for jm, m, name in _admitted(arch):
            shape, jshape = INPUT_SHAPES[name], J_SHAPES[name]
            if shape.kind == "train":
                W = jm.TOPO.n_workers_multi if multi else jm.TOPO.n_workers_single
                want = _ref_specs(JSH.train_batch_pspecs(
                    JS.train_batch_specs(jm.FULL, jm.TOPO, jshape, W), rows // W, M.MODEL_PAR))
                got = SH.train_batch_pspecs(specs.train_batch_specs(m.FULL, m.TOPO, shape, W),
                                            rows // W, M.MODEL_PAR)
            elif shape.kind == "prefill":
                want = _ref_specs(JSH.serve_batch_pspecs(
                    JS.prefill_batch_specs(jm.FULL, jshape), rows, M.MODEL_PAR))
                got = SH.serve_batch_pspecs(specs.prefill_batch_specs(m.FULL, shape), rows,
                                            M.MODEL_PAR)
            else:
                want = _ref_specs(JSH.cache_pspecs(
                    JS.decode_specs(jm.FULL, jshape)["cache"], rows, M.MODEL_PAR))
                got = SH.cache_pspecs(specs.decode_specs(m.FULL, shape)["cache"], rows,
                                      M.MODEL_PAR)
            assert got == want, (arch, name, multi)


_REF_GRIDS = """
import json, numpy as np
from repro.configs import load_arch
from repro.launch.mesh import make_production_mesh, training_mesh, serving_mesh, mesh_dims
ids = np.vectorize(lambda d: d.id)
out = {}
for mp in (False, True):
    base = make_production_mesh(multi_pod=mp)
    for W in (1, 2, 4, 8, 16, 32):
        try:
            t = training_mesh(base, W)
            out[f"train.{mp}.{W}"] = [ids(t.devices).tolist(), list(t.axis_names)]
        except ValueError as e:
            out[f"train.{mp}.{W}"] = str(e)
    s = serving_mesh(base)
    out[f"serve.{mp}"] = [ids(s.devices).tolist(), list(s.axis_names)]
    out[f"base.{mp}"] = [ids(base.devices).tolist(), list(base.axis_names), mesh_dims(base)]
print(json.dumps(out))
"""


def test_grids_match_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    theirs = json.loads(subprocess.run([sys.executable, "-c", _REF_GRIDS], env=env,
                                       check=True, capture_output=True, text=True,
                                       timeout=300).stdout)
    for mp in (False, True):
        base = M.make_production_mesh(multi_pod=mp)
        want = theirs[f"base.{mp}"]
        assert base.devices.tolist() == want[0] and list(base.axis_names) == want[1]
        assert M.mesh_dims(base) == want[2]
        for W in (1, 2, 4, 8, 16, 32):
            want = theirs[f"train.{mp}.{W}"]
            if isinstance(want, str):
                with pytest.raises(ValueError) as e:
                    M.training_mesh(base, W)
                assert str(e.value) == want
                continue
            got = M.training_mesh(base, W)
            assert got.devices.tolist() == want[0] and list(got.axis_names) == want[1]
        s = M.serving_mesh(base)
        assert [s.devices.tolist(), list(s.axis_names)] == theirs[f"serve.{mp}"]


def test_topology_rank_order_is_the_reference_reshape():
    """Rank r = (w * Z + z) * M + m, the reshape of the rows of the
    reference's ``training_mesh``; with M = 1 it is r = w * Z + z."""
    base = M.make_production_mesh()
    grid = M.training_mesh(base, 4).devices          # (4, 4, 16)
    for r in range(grid.size):
        t = M.Topology(n_workers=4, worker=4, zero=4, rank=r, model=16)
        assert grid[t.worker_index, t.zero_index, t.model_index] == r
        assert t.dp.rank == t.worker_index * 4 + t.zero_index and t.dp.world == 16
        assert t.mp.rank == t.model_index and t.mp.world == 16
    flat = M.Topology(n_workers=4, worker=2, zero=2, rank=3)
    assert (flat.worker_index, flat.zero_index, flat.model_index) == (1, 1, 0)
    assert flat.dp is flat


@pytest.mark.parametrize("arch", ["nano", "minitron_4b", "granite_34b", "granite_moe_3b_a800m",
                                  "mamba2_780m", "whisper_large_v3"])
@pytest.mark.parametrize("model", [2, 4])
def test_shard_then_gather_is_the_identity(arch, model):
    cfg = resolve_arch(arch if arch == "nano" else f"{arch}_smoke")[0]
    lay = T.layout(cfg)
    specs_ = SH.param_pspecs(dict(zip(lay.names, lay.shapes)), model=model)
    gen = torch.Generator().manual_seed(0)
    for name, shape in zip(lay.names, lay.shapes):
        leaf = torch.randn(shape, generator=gen).to(torch.bfloat16)
        blocks = [TP.shard_leaf(leaf, specs_[name], model, m) for m in range(model)]
        back = TP.gather_leaf(blocks, specs_[name])
        assert torch.equal(back.view(torch.int16), leaf.view(torch.int16)), name
    row = T.init_params(gen, cfg)
    lays = [TP.rank_layout(cfg, model, m) for m in range(model)]
    flats = [convert.shard_flat(row, lay, r) for r in lays]
    assert [sum(p.numel() for p in parts(f)) for f in flats] == [r.numel for r in lays]
    back = convert.gather_flat(flats, lay, lays)
    for a, b in zip(parts(back), parts(row), strict=True):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("model", [2, 4])
def test_from_jax_numpy_cuts_a_ranks_blocks(model):
    """``from_jax_numpy(..., rank=)`` is the dense conversion cut to the
    rank's blocks by the placements, and the ranks' rows gather back to the
    reference's leaves."""
    from repro.models import transformer as JT

    jcfg, cfg = j_load_arch("minitron_4b").SMOKE, load_arch("minitron_4b").SMOKE
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    dense = convert.from_jax_numpy(tree, cfg, n_workers=2)
    lay = T.layout(cfg)
    lays = [TP.rank_layout(cfg, model, m) for m in range(model)]
    rows = [convert.from_jax_numpy(tree, cfg, n_workers=2, rank=r) for r in lays]
    for r, row in zip(lays, rows):
        assert row.shape == (2, r.numel)
        assert torch.equal(row, convert.shard_flat(dense, lay, r))
    back = convert.to_numpy(convert.gather_flat([row[0] for row in rows], lay, lays), cfg)
    want = dict(convert.flatten_tree(tree, is_leaf=lambda x: isinstance(x, np.ndarray)))
    assert all(np.array_equal(back[k], want[k]) for k in want)
