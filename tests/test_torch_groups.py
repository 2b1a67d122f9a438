"""Dtype groups (``repro_torch.groups``): a mixed-dtype model's buffers, one
per dtype, through every algorithm and base optimizer of the dense path.

* The group machinery alone: granite_moe SMOKE (f32) laid out as ONE group
  and as TWO (its routers in a second f32 group), the same params and
  batches, one outer step of every deterministic algorithm and of DSM with
  every base optimizer: every leaf of params, x0 and the optimizer state
  bit-equal between the two layouts (each step is elementwise, so a split
  buffer computes the same numbers), and the losses equal.
* The mixed-dtype model itself: granite_moe SMOKE with bf16 parameters (its
  routers f32) trains with every algorithm and base optimizer, and with
  DSM under faults and guards, through ``run_training`` on the CPU: finite
  losses, every group in its dtype, x0 moved.  Over the ZeRO-sharded and
  device-parallel ranks it runs group by group: ``tests/test_torch_zero_groups.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import load_arch
from repro_torch.core.base_opt import AdamWState
from repro_torch.groups import Groups, each, join, parts, pick
from repro_torch.models import transformer as T
from repro_torch.models.convert import FlatLayout
from repro_torch.train import trainer as TR

F32 = torch.float32
SMOKE = load_arch("granite_moe_3b_a800m").SMOKE
MIXED = dataclasses.replace(SMOKE, param_dtype="bfloat16", name="granite_moe_smoke_bf16_params")
W, TAU, BM, SEQ = 2, 2, 1, 16
SPLIT_RUNS = [dict(algorithm=a) for a in (
    "dsm", "slowmo", "signed_slowmo", "lookahead", "signed_lookahead", "global_adamw",
    "local_avg", "perstep")] + [dict(algorithm="dsm", base_opt=b)
                                for b in ("sgd", "momentum", "lion", "sophia")]
MIXED_RUNS = SPLIT_RUNS + [dict(algorithm="mv_signsgd"), dict(algorithm="dsm",
                                                                sign_mode="rand_pm"),
                           dict(algorithm="dsm", n_workers=4,
                                faults="drop=0.25,straggle=0.25,nan=0.25,seed=0",
                                guard_nonfinite=True, guard_spike_factor=3.0)]


def _name(run: dict) -> str:
    return "+".join(str(v).split(",")[0] for k, v in run.items() if k != "n_workers")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Bit-equality of the two layouts needs each elementwise op to take the
    same path on every element: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_group_layout(cfg) -> FlatLayout:
    """cfg's leaves with its routers in a second group (both f32)."""
    def mark(tree, path=""):
        if T._is_spec_leaf(tree):
            return tree[:2] + ("second" if path.endswith("router") else tree[2],)
        if isinstance(tree, dict):
            return {k: mark(v, f"{path}.{k}") for k, v in tree.items()}
        return tuple(mark(v, f"{path}.{i}") for i, v in enumerate(tree))

    return FlatLayout.from_tree(mark(T.param_spec(cfg)), is_leaf=T._is_spec_leaf,
                                dtype_of=lambda leaf: leaf[2], first=cfg.p_dtype)


def _regroup(flat, src: FlatLayout, dst: FlatLayout):
    """The same leaves in ``dst``'s buffers (leading dims kept)."""
    lead = parts(flat)[0].shape[:-1]
    out = Groups(torch.empty(lead + (n,), dtype=F32) for n in dst.group_numels)
    if dst.n_groups == 1:
        out = out[0]
    s_views = _lead_views(src, flat)
    for name, view in _lead_views(dst, out).items():
        view.copy_(s_views[name])
    return out


def _lead_views(lay, flat) -> dict:
    bufs = parts(flat)
    return {name: bufs[g][..., off:off + n] for name, _, off, n, g in lay._spans()}


def _buffers(state, lay):
    """{field path: {leaf: tensor}} of every layout-shaped buffer of a state."""
    out = {}

    def walk(v, path):
        if isinstance(v, Groups) or (isinstance(v, torch.Tensor) and v.dim() > 0):
            out[path] = _lead_views(lay, v)
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                if f.name not in getattr(v, "SCRATCH", ()):
                    walk(getattr(v, f.name), f"{path}.{f.name}")
        elif isinstance(v, tuple):
            for k, x in zip(getattr(v, "_fields", range(len(v))), v):
                walk(x, f"{path}.{k}")

    walk(state, "")
    return out


@pytest.mark.parametrize("run", SPLIT_RUNS, ids=[_name(r) for r in SPLIT_RUNS])
def test_two_groups_step_like_one(run):
    one, two = T.layout(SMOKE), _two_group_layout(SMOKE)
    assert one.n_groups == 1 and two.n_groups == 2 and two.group_numels[1] > 0
    s = TR.TrainSettings(n_workers=W, tau=TAU, steps=2, b_micro=BM, seq=SEQ, peak_lr=1e-3,
                         warmup=1, **run)
    x0 = T.init_params(torch.Generator().manual_seed(0), SMOKE)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, SMOKE.vocab_size, (W, TAU, 1, BM, SEQ)))}
    states, losses = [], []
    for lay, start in ((one, x0), (two, _regroup(x0, one, two))):
        init, step, _, _ = TR.build_algorithm(lambda p, mb: T.loss_fn(p, mb, SMOKE), s, lay)
        state = init(start, W)
        rng = torch.Generator().manual_seed(0)
        for _ in range(2):
            state, metrics = step(state, batch, rng)
            losses.append(metrics["loss"].item())
        states.append(_buffers(state, lay))
    assert losses[:2] == losses[2:]
    assert sorted(states[0]) == sorted(states[1]) and states[0]
    for field, leaves in states[0].items():
        for name, ours in leaves.items():
            assert torch.equal(ours, states[1][field][name]), f"{field} {name}"


@pytest.mark.parametrize("run", MIXED_RUNS, ids=[_name(r) for r in MIXED_RUNS])
def test_mixed_dtype_model_trains(run):
    lay = T.layout(MIXED)
    assert lay.dtypes == (torch.bfloat16, F32)
    s = TR.TrainSettings(**{**dict(n_workers=W, tau=TAU, steps=2, b_micro=BM, seq=SEQ,
                                   peak_lr=1e-3, warmup=1, eval_every=2, eval_batch=2), **run})
    x0 = T.init_params(torch.Generator().manual_seed(0), MIXED)
    res = TR.run_training(MIXED, s, device="cpu", params=x0)
    assert all(np.isfinite(res["history"])) and np.isfinite(res["final_eval"])
    st = res["state"]
    final = st.x if run["algorithm"] == "mv_signsgd" else (
        st.params if run["algorithm"] == "perstep" else st.x0)
    assert isinstance(final, Groups) and [t.dtype for t in final] == list(lay.dtypes)
    assert all((a != b).any() for a, b in zip(final, x0))


def test_pick_join_and_each():
    a = AdamWState(Groups([torch.zeros(2), torch.ones(3)]), Groups([torch.ones(2),
                                                                     torch.zeros(3)]))
    picked = [pick(a, i) for i in range(2)]
    assert isinstance(picked[1], AdamWState) and picked[1].m.shape == (3,)
    back = join(picked)
    assert isinstance(back.m, Groups) and all(x is y for x, y in zip(back.v, a.v))
    assert join([(), ()]) == () and pick((), 1) == ()
    t = torch.arange(3.0)
    assert pick(t, 0) is t and each(torch.neg, t).tolist() == [-0.0, -1.0, -2.0]
    assert [x.tolist() for x in each(lambda x, y: x + y, a.m, a.v)] == [[1, 1], [1, 1, 1]]
    assert parts(t) == (t,) and parts(a.m) == tuple(a.m)
