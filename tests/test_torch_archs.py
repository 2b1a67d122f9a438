"""The paper's other GPT-2 sizes, the dense GQA/MQA archs, the
sliding-window arch, the MoE archs, the encoder-decoder and the VLM in the
port, against the JAX package, on the CPU (the pattern of the reference's
``tests/test_smoke_archs.py``, held element for element).

For the SMOKE configs of gpt2_medium, gpt2_large, deepseek_67b (GQA 8/2,
gated SiLU, untied head), granite_34b (MQA, one kv head, GELU, untied),
minitron_4b (GQA, gated SiLU, untied SMOKE head), gemma3_1b (sliding-window
and global attention, MQA, gated GELU), granite_moe_3b_a800m (4 experts top
2), llama4_maverick_400b_a17b (dense and MoE blocks alternating, top 1
with a shared expert, SGD local steps), whisper_large_v3 (an encoder over
frame embeddings, cross-attention in every decoder block),
llava_next_34b (GQA 8/2, projected patches before the text, the loss on
the text positions), mamba2_780m (Mamba-2 SSD blocks without an FFN) and
recurrentgemma_2b (an RG-LRU and a sliding-window block, gated GELU), all
f32, from the reference's ``init_params`` through
``convert.from_jax_numpy``, on the reference's batch dicts (the
reference's ``_smoke_batch`` shapes: frames (enc_len, d_model) beside the
tokens, or n_patches patches before S - n_patches tokens):

  * loss rtol 1e-6 and every gradient leaf within 3e-5 of that leaf's
    largest magnitude (the tolerances of ``test_torch_model.py``);
  * one DSM outer step (W=2, tau=2, the arch's ``TOPO.base_opt``, constant
    gamma 1e-3, eta 0.5) from the same params and batch: the loss rtol 1e-5;
    each AdamW moment buffer within 1e-3 of its largest magnitude (the
    second local step's gradients are taken at params that differ on the
    coordinates the first step flipped, by 2 * gamma, so they differ by more
    than the gradient test's 3e-5: measured 2.5e-4); x0 elementwise (rtol
    1e-5, atol 1e-5)
    except at most N/1000 coordinates whose sign(u) flipped, each by at most
    2 * eta * gamma (``test_torch_dsm.py`` explains why such flips occur);
    the global momentum m = (1 - beta2) * Delta elementwise (rtol 1e-4,
    atol 1e-5) except at most N/100 coordinates, each within
    (1 - beta2) * 2 * tau.  AdamW's direction m_hat / (sqrt(v_hat) + eps) is
    scale-free: on its first step it is sign(g), and on the second the
    bias-corrected first moment can cancel (g1 against g2), so a coordinate
    whose gradients sit within the two packages' f32 rounding of such a
    point moves Delta by up to 2 * tau / W.  Measured: 0.44% of the
    coordinates of the gated SiLU archs (deepseek, minitron), 0.10% of
    granite's, under 0.1% of the GPT-2 sizes', each under 0.015.

    gemma3_1b and granite_moe_3b_a800m leave this end-to-end comparison:
    their x0 holds, but m differs at 9.0% and 3.5% of the coordinates.  Their
    first local step flips the sign of a few gradients of ~5e-7 of their
    leaf's largest magnitude (two packages' rounding of ~0: in an attention
    projection of gemma3's layers 0 and 1, in an expert of granite's layer
    0); AdamW moves those by 2 * gamma, and through a value projection or
    an expert that moves every second-step gradient by ~1e-3 relative (a
    2e-3 change of one such weight moves 47-70% of m's coordinates past the
    bound in either package, measured).  whisper_large_v3 and
    llava_next_34b leave it too, measured on the same batch layout: whisper's
    m differs at 2.2% of the coordinates (17,227 of 787,900), and one of
    llava's 3,410,432 AdamW moment entries sits 1.4% past the moment bound.
  * the same outer step driven by the reference's loss and gradients
    (``_reference_loss``), for every ported arch, within the same
    tolerances: the port's local steps, worker mean and global step on the
    arch's leaves, without the second model's rounding
    (``test_torch_archs_reference_gradients.py``).

For granite_moe_3b_a800m SMOKE with bf16 parameters, the routers stay f32
(two dtype groups, every leaf's dtype the reference's), and one DSM outer
step from the same params holds within bounds stated in its test.  Every
arch's layout has the reference's leaves, dtypes and order, one group per
dtype (a bf16 model's f32 routers, ``lam``, ``A_log``, ``D`` and
``dt_bias`` in the second), and a model whose leaves share one dtype has
one group.

Every arch id of the reference is ported; a block kind that the reference
does not build either raises ``ValueError`` in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_arch as j_load_arch
from repro.core import DSMConfig as JDSMConfig
from repro.core import constant as j_constant
from repro.core import dsm_init as j_dsm_init
from repro.core import get_base_optimizer as j_get_base_optimizer
from repro.core import make_dsm_step as j_make_dsm_step
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, load_arch, specs
from repro_torch.core import base_opt as B
from repro_torch.core import dsm as D
from repro_torch.core import schedules as S
from repro_torch.groups import Groups
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR

DENSE = ("gpt2_medium", "gpt2_large", "deepseek_67b", "granite_34b", "minitron_4b")
PORTED = DENSE + ("gemma3_1b", "granite_moe_3b_a800m", "llama4_maverick_400b_a17b",
                  "llava_next_34b", "whisper_large_v3", "mamba2_780m", "recurrentgemma_2b")
# the end-to-end DSM comparison: gemma3, granite_moe, llava and whisper
# leave it (see the module docstring) for the step on the reference's
# gradients
END_TO_END = DENSE + ("llama4_maverick_400b_a17b", "mamba2_780m", "recurrentgemma_2b")
W, TAU, BM, SEQ = 2, 2, 2, 32
GAMMA, ETA = 1e-3, 0.5


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    """No TF32 anywhere the tests might reach a card (as run_training sets)."""
    TR.set_matmul_precision()


def _flat(tree, n_workers=None) -> np.ndarray:
    """A JAX param-shaped tree in the port's flat layout ((W, N) or (N,))."""
    leaves = [np.asarray(v, np.float32) for _, v in convert.flatten_tree(
        jax.tree.map(np.asarray, tree), is_leaf=lambda x: isinstance(x, np.ndarray))]
    if n_workers is None:
        return np.concatenate([v.ravel() for v in leaves])
    return np.concatenate([v.reshape(n_workers, -1) for v in leaves], axis=1)


def _batch(cfg, seed, lead, S):
    """The reference's batch dict for ``cfg`` (numpy; leading dims ``lead``):
    int32 tokens, and f32 patches before S - n_patches tokens (vlm) or f32
    frames (encdec)."""
    rng = np.random.default_rng(seed)
    n_text = S - cfg.n_patches if cfg.family == "vlm" else S
    batch = {"tokens": rng.integers(0, cfg.vocab_size, lead + (n_text,)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(lead + (cfg.n_patches, cfg.d_model),
                                               dtype=np.float32)
    elif cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(lead + (cfg.enc_len, cfg.d_model),
                                              dtype=np.float32)
    return batch


def _jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


def _setup(arch, seed):
    jcfg, cfg = j_load_arch(arch).SMOKE, load_arch(arch).SMOKE
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    flat = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
    return jcfg, cfg, jp, flat


def _assert_close_with_flips(ours, theirs, rtol, atol, flip_size, max_flips, what):
    diff = np.abs(ours - theirs)
    bad = diff > atol + rtol * np.abs(theirs)
    assert bad.sum() <= max_flips, f"{what}: {bad.sum()} coordinates differ"
    assert (diff[bad] <= flip_size * 1.001).all(), f"{what}: max diff {diff.max()}"


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_loss_and_grads_match_reference(arch):
    jcfg, cfg, jp, flat = _setup(arch, seed=3)
    assert cfg.n_layers <= 2 and cfg.d_model <= 512
    batch = _batch(cfg, 1, (2,), 40 + cfg.n_patches)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, _jax_batch(batch), jcfg, remat=False)))(jp)
    grad = torch.zeros_like(flat)
    loss = T.loss_fn(T.layout(cfg).autograd_leaves(flat, grad), _torch_batch(batch), cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    ours = convert.to_numpy(grad, cfg)
    theirs = dict(convert.flatten_tree(jax.tree.map(np.asarray, jgrads),
                                       is_leaf=lambda x: isinstance(x, np.ndarray)))
    assert sorted(ours) == sorted(theirs)
    for name, g in theirs.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(ours[name], g, rtol=0, atol=3e-5 * scale, err_msg=name)


@pytest.mark.parametrize("arch", END_TO_END)
def test_smoke_dsm_outer_step_matches_reference(arch):
    jcfg, cfg, jp, flat = _setup(arch, seed=0)
    topo = load_arch(arch).TOPO
    batch = _batch(cfg, 4, (W, TAU, 1, BM), SEQ)

    jbase = j_get_base_optimizer(topo.base_opt)
    jstep = jax.jit(j_make_dsm_step(lambda p, b: JT.loss_fn(p, b, jcfg, remat=False), jbase,
                                    JDSMConfig(tau=TAU, global_lr=ETA), j_constant(GAMMA)))
    jstate, jm = jstep(j_dsm_init(jp, jbase, n_workers=W), _jax_batch(batch))

    base = B.get_base_optimizer(topo.base_opt)
    lay = T.layout(cfg)
    step = D.make_dsm_step(lambda p, mb: T.loss_fn(p, mb, cfg), base,
                           D.DSMConfig(tau=TAU, global_lr=ETA), S.constant(GAMMA), lay)
    state, m = step(D.dsm_init(flat, base, W), _torch_batch(batch))

    _assert_step_close(state, m, jstate, jm, flat, lay)


def _assert_step_close(state, m, jstate, jm, flat, lay):
    """The module docstring's DSM outer-step tolerances."""
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    flip = 2 * np.float32(ETA) * np.float32(GAMMA)
    _assert_close_with_flips(state.x0.numpy(), _flat(jstate.x0), 1e-5, 1e-5, flip,
                             max_flips=lay.numel // 1000, what="x0")
    for ours, theirs in _moments(state, jstate):
        theirs = _flat(theirs, W)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=1e-3 * np.abs(theirs).max())
    _assert_close_with_flips(state.m.numpy(), _flat(jstate.m), 1e-4, 1e-5,
                             (1 - 0.98) * 2 * TAU, max_flips=lay.numel // 100, what="m")
    assert (state.x0 != flat).any()      # the params moved


def _moments(state, jstate) -> list:
    """(port, reference) AdamW moment buffers; none for SGD."""
    if isinstance(state.base_state, tuple) and not state.base_state:
        return []
    return [(state.base_state.m, jstate.base_state.m), (state.base_state.v, jstate.base_state.v)]


def _reference_loss(jcfg, jp, lay):
    """The reference's loss as the port's ``loss_fn(params, microbatch)``:
    the leaves' values go to ``JT.loss_fn`` and ``jax.grad``, and backward
    hands each leaf the reference's gradient."""
    treedef = jax.tree.structure(jp)
    vg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, b, jcfg, remat=False)))

    def loss_fn(p, mb):
        stacked = [isinstance(p[n], list) for n in lay.names]
        parts = [p[n] if st else [p[n]] for n, st in zip(lay.names, stacked)]

        class Bridge(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *ts):
                vals, i = [], 0
                for ps, st in zip(parts, stacked):
                    arr = [t.detach().numpy() for t in ts[i:i + len(ps)]]
                    vals.append(np.stack(arr) if st else arr[0])
                    i += len(ps)
                loss, grads = vg(jax.tree.unflatten(treedef, vals),
                                 {k: jnp.asarray(v.numpy()) for k, v in mb.items()})
                ctx.grads = [np.asarray(g) for g in jax.tree.leaves(grads)]
                return torch.tensor(float(loss), dtype=torch.float32)

            @staticmethod
            def backward(ctx, go):
                return tuple(go * torch.from_numpy(np.array(x)) for g, st in zip(ctx.grads, stacked)
                             for x in (list(g) if st else [g]))

        return Bridge.apply(*(t for ps in parts for t in ps))

    return loss_fn


@pytest.mark.parametrize("part", ["mixer", "ffn"])
def test_unported_families_raise_not_implemented(part):
    """Every arch id of the reference is ported; a block kind that the
    reference does not build either, an unknown mixer or FFN, raises
    ``ValueError`` in both packages (the reference's ``_init_block``), from
    the port's layout, parameter count and init alike."""
    assert set(ARCH_IDS) <= set(PORTED)
    kind = "lstm:dense" if part == "mixer" else "attn:glu"
    jcfg = dataclasses.replace(j_load_arch("gpt2_small").SMOKE, pattern=(kind,))
    with pytest.raises(ValueError, match=f"unknown {part}"):
        JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(load_arch("gpt2_small").SMOKE, pattern=(kind,))
    for build in (T.layout, specs.param_count,
                  lambda c: T.init_params(torch.Generator().manual_seed(0), c)):
        with pytest.raises(ValueError, match=f"unknown family 'lm' or block kinds \\['{kind}'\\]"):
            build(cfg)


def _mixed_dtype_granite():
    """granite_moe SMOKE with bf16 parameters (activations f32)."""
    from repro.configs.granite_moe_3b_a800m import SMOKE as J_SMOKE

    kw = dict(param_dtype="bfloat16", name="granite_moe_smoke_bf16_params")
    return (dataclasses.replace(J_SMOKE, **kw),
            dataclasses.replace(load_arch("granite_moe_3b_a800m").SMOKE, **kw))


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("size", ["SMOKE", "FULL"])
def test_layout_has_the_reference_leaves_and_dtypes(arch, size):
    """Names, shapes and dtypes of every leaf equal the reference's
    ``init_params`` (by ``jax.eval_shape``: nothing allocated); the layout
    lists the param dtype's group first, each group in ``jax.tree.leaves``
    order, at contiguous offsets; one group per dtype, so one when the
    leaves share a dtype, and then exactly the order of
    ``jax.tree.leaves``."""
    jcfg, cfg = getattr(j_load_arch(arch), size), getattr(load_arch(arch), size)
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    ref = convert.flatten_tree(shapes, is_leaf=lambda x: hasattr(x, "shape"))
    lay = T.layout(cfg)
    ref_dtypes = {k: str(v.dtype) for k, v in ref}
    dtypes = [lay.dtypes[g] for g in lay.groups]
    assert {k: str(d).removeprefix("torch.") for k, d in zip(lay.names, dtypes)} == ref_dtypes
    assert lay.dtypes[0] == cfg.p_dtype and len(set(lay.dtypes)) == lay.n_groups
    for g, dt in enumerate(lay.dtypes):
        names = [k for k, _ in ref if ref_dtypes[k] == str(dt).removeprefix("torch.")]
        assert [n for n, gg in zip(lay.names, lay.groups) if gg == g] == names
    sizes = [int(np.prod(s)) for s in lay.shapes]
    for g, n in enumerate(lay.group_numels):
        offs = [(o, k) for o, k, gg in zip(lay.offsets, sizes, lay.groups) if gg == g]
        assert [o for o, _ in offs] == list(np.cumsum([0] + [k for _, k in offs])[:-1])
        assert sum(k for _, k in offs) == n
    assert lay.numel == sum(sizes) == specs.param_count(cfg)
    if len(set(ref_dtypes.values())) == 1:
        assert lay.n_groups == 1 and list(lay.names) == [k for k, _ in ref]
    assert lay.n_groups == len(set(ref_dtypes.values()))


def test_bf16_granite_moe_keeps_routers_f32_and_steps_like_the_reference():
    """granite_moe SMOKE with bf16 parameters: ``from_jax_numpy`` gives two
    groups, every leaf in the reference's dtype (the routers f32, bit-equal
    to the reference's values), and one DSM outer step (W=2, tau=2, AdamW,
    gamma 1e-3, eta 0.5) from those params against the reference's.
    Bounds, stated before the reading: the loss rtol 1e-4 (the bf16
    parameters are the same numbers, the activations f32); x0 in each dtype
    within one ulp of its dtype (2^-8 relative for bf16, 1e-5 for f32)
    except at most N/100 coordinates, each by at most 2 * eta * gamma plus
    one ulp (the AdamW and sign flips of the f32 test, and bf16 x_tau values
    that round the other way); m (f32, both groups) within 1e-4 relative +
    1e-5 except at most N/20 coordinates, each within (1 - beta2) * 2 * tau
    (a bf16 rounding of x_tau moves Delta by up to an ulp / gamma)."""
    jcfg, cfg = _mixed_dtype_granite()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    lay = T.layout(cfg)
    flat = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)
    assert isinstance(flat, Groups) and [t.dtype for t in flat] == [torch.bfloat16,
                                                                     torch.float32]
    flat = Groups(t[0] for t in flat)
    views = lay.views(flat)
    for name, leaf in convert.flatten_tree(jax.tree.map(np.asarray, jp),
                                           is_leaf=lambda x: isinstance(x, np.ndarray)):
        assert str(views[name].dtype).removeprefix("torch.") == str(leaf.dtype), name
        if name.endswith("router"):
            np.testing.assert_array_equal(views[name].numpy(), leaf)
    assert {n for n, g in zip(lay.names, lay.groups) if g == 1} == {
        n for n in lay.names if n.endswith("moe.router")}

    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                               (W, TAU, 1, BM, SEQ)).astype(np.int32)
    jbase = j_get_base_optimizer("adamw")
    jstep = jax.jit(j_make_dsm_step(lambda p, b: JT.loss_fn(p, b, jcfg, remat=False), jbase,
                                    JDSMConfig(tau=TAU, global_lr=ETA), j_constant(GAMMA)))
    jstate, jm = jstep(j_dsm_init(jp, jbase, n_workers=W), {"tokens": jnp.asarray(tokens)})
    base = B.get_base_optimizer("adamw")
    step = D.make_dsm_step(lambda p, mb: T.loss_fn(p, mb, cfg), base,
                           D.DSMConfig(tau=TAU, global_lr=ETA), S.constant(GAMMA), lay)
    state, m = step(D.dsm_init(flat, base, W), {"tokens": torch.from_numpy(tokens).long()})

    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
    theirs_x0, theirs_m = (dict(convert.flatten_tree(jax.tree.map(np.asarray, t),
                                                     is_leaf=lambda x: isinstance(x, np.ndarray)))
                           for t in (jstate.x0, jstate.m))
    flip = 2 * np.float32(ETA) * np.float32(GAMMA)
    for g, dt in enumerate(lay.dtypes):
        names = [n for n, gg in zip(lay.names, lay.groups) if gg == g]
        ours_x0, ours_m = lay.views(state.x0), lay.views(state.m)
        x0a = np.concatenate([ours_x0[n].float().numpy().ravel() for n in names])
        x0b = np.concatenate([np.asarray(theirs_x0[n], np.float32).ravel() for n in names])
        ulp = 2.0 ** -8 if dt == torch.bfloat16 else 1e-5
        _assert_close_with_flips(x0a, x0b, ulp, 1e-6, flip * (1 + ulp) + ulp * np.abs(x0b).max(),
                                 max_flips=x0a.size // 100, what=f"x0 {dt}")
        ma = np.concatenate([ours_m[n].numpy().ravel() for n in names])
        mb = np.concatenate([np.asarray(theirs_m[n], np.float32).ravel() for n in names])
        _assert_close_with_flips(ma, mb, 1e-4, 1e-5, (1 - 0.98) * 2 * TAU,
                                 max_flips=max(ma.size // 20, 1), what=f"m {dt}")
    assert state.m[1].dtype == torch.float32 and state.x0[1].dtype == torch.float32
