"""The port's model against the JAX package's, on the CPU.

Params come from the reference's ``T.init_params`` through
``convert.from_jax_numpy``; tokens are drawn with numpy.  Loss and every
gradient are held against ``T.loss_fn(..., remat=False)`` and ``jax.grad``.
Tolerances (f32 throughout, sums in other orders through two or three
layers of backward): loss rtol 1e-6; each gradient leaf within 3e-5 of
that leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.tables import NANO as J_NANO
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.gpt2_small import SMOKE as J_SMOKE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gpt2_small import SMOKE
from repro_torch.configs.nano import NANO
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import trainer as TR

# GQA (2 kv heads for 4 query heads), a gated SiLU MLP, an untied head, a
# two-block pattern with a remainder layer, and query tiles shorter than S
_GQA = dict(name="gqa_gated", family="lm", n_layers=3, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=48, vocab_size=80, head_dim=8,
            pattern=("attn:dense", "attn:dense"), mlp_gated=True, act="silu",
            tie_embeddings=False, dtype="float32", param_dtype="float32",
            vocab_pad_to=32, q_block=16)
# sliding-window and MoE blocks in one pattern, a windowed remainder layer,
# a window and query tiles shorter than S, a shared expert, the ksum combine
_SWA_MOE = dict(_GQA, name="swa_moe", pattern=("swa:moe", "attn:dense"), window=12,
                n_experts=5, top_k=2, n_shared_experts=1, moe_combine="ksum", d_ff=24)
CASES = [(J_NANO, NANO), (J_SMOKE, SMOKE), (JModelConfig(**_GQA), ModelConfig(**_GQA)),
         (JModelConfig(**_SWA_MOE), ModelConfig(**_SWA_MOE))]
IDS = ["nano", "gpt2_small_smoke", "gqa_gated_untied", "swa_moe_ksum"]


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    """No TF32 anywhere the tests might reach a card (as run_training sets)."""
    TR.set_matmul_precision()


def _jax_numpy(params):
    return dict(convert.flatten_tree(jax.tree.map(np.asarray, params),
                                     is_leaf=lambda x: isinstance(x, np.ndarray)))


@pytest.mark.parametrize("jcfg,cfg", CASES, ids=IDS)
def test_config_copy_matches_reference(jcfg, cfg):
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size", "hd",
              "padded_vocab", "pattern", "mlp_gated", "act", "tie_embeddings", "rope_theta",
              "norm_eps", "dtype", "param_dtype", "vocab_pad_to", "q_block"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("jcfg,cfg", CASES, ids=IDS)
def test_layout_follows_jax_leaves(jcfg, cfg):
    params = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    flat = convert.flatten_tree(params, is_leaf=lambda x: hasattr(x, "shape"))
    lay = T.layout(cfg)
    assert list(lay.names) == [k for k, _ in flat]
    assert list(lay.shapes) == [tuple(v.shape) for _, v in flat]
    assert lay.numel == sum(int(np.prod(v.shape)) for _, v in flat)
    assert lay.shapes[lay.names.index("decoder.blocks.p0.attn.wq")] == (
        cfg.n_scan_blocks, cfg.d_model, cfg.n_heads * cfg.hd)


@pytest.mark.parametrize("jcfg,cfg", CASES, ids=IDS)
def test_loss_and_grads_match_jax(jcfg, cfg):
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    flat = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg, remat=False)))(jp)
    grad = torch.zeros_like(flat)
    lay = T.layout(cfg)
    loss = T.loss_fn(lay.autograd_leaves(flat, grad), {"tokens": torch.from_numpy(tokens).long()},
                     cfg)
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    ours = convert.to_numpy(grad, cfg)
    theirs = _jax_numpy(jgrads)
    assert sorted(ours) == sorted(theirs)
    for name, g in theirs.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(ours[name], g, rtol=0, atol=3e-5 * scale, err_msg=name)


def test_stacked_and_per_layer_params_agree():
    """The forward reads stacked leaves or per-layer leaf lists alike, and
    backward into per-layer leaves fills the flat gradient buffer."""
    gen = torch.Generator().manual_seed(0)
    flat = T.init_params(gen, NANO)
    lay = T.layout(NANO)
    tokens = torch.randint(0, NANO.vocab_size, (2, 16), generator=gen)
    stacked = {k: v.clone().requires_grad_(True) for k, v in lay.views(flat).items()}
    l1 = T.loss_fn(stacked, {"tokens": tokens}, NANO)
    l1.backward()
    grad = torch.zeros_like(flat)
    l2 = T.loss_fn(lay.autograd_leaves(flat, grad), {"tokens": tokens}, NANO)
    l2.backward()
    assert l1.item() == l2.item()
    for name, g in lay.views(grad).items():
        torch.testing.assert_close(g, stacked[name].grad, rtol=1e-6, atol=1e-8)


def test_init_draws_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    views = T.layout(SMOKE).views(T.init_params(gen, SMOKE))
    assert torch.equal(views["final_norm.scale"], torch.ones(SMOKE.d_model))
    assert abs(views["embed"].std().item() - 0.02) < 1e-3
    wq = views["decoder.blocks.p0.attn.wq"]
    assert abs(wq.std().item() - SMOKE.d_model ** -0.5) < 2e-3
    assert views["embed"].shape == (SMOKE.padded_vocab, SMOKE.d_model)


def test_unported_mixers_raise():
    """Every mixer of the reference is ported (an ``ssm`` block with a dense
    FFN builds the reference's leaves); a mixer that neither package
    builds raises ``ValueError``, as the reference's ``_init_block``."""
    kw = dict(name="x", family="lm", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
              d_ff=64, vocab_size=64, ssm_state=8, ssm_head_dim=16)
    shapes = jax.eval_shape(lambda: JT.init_params(
        jax.random.PRNGKey(0), JModelConfig(**kw, pattern=("ssm:dense",))))
    ref = convert.flatten_tree(shapes, is_leaf=lambda x: hasattr(x, "shape"))
    lay = T.layout(ModelConfig(**kw, pattern=("ssm:dense",)))
    assert dict(zip(lay.names, lay.shapes)) == {k: tuple(v.shape) for k, v in ref}
    for build, cfg in ((JT.init_params, JModelConfig(**kw, pattern=("lstm:dense",))),
                       (lambda _, c: T.layout(c), ModelConfig(**kw, pattern=("lstm:dense",)))):
        with pytest.raises(ValueError, match="unknown"):
            build(jax.random.PRNGKey(0), cfg)


# (S, q_block, window): whole key tiles skipped wherever q_start - window
# >= q_block; a window as wide as S; a ragged last query tile
WINDOW_CASES = [(64, 8, 16), (37, 4, 5), (40, 16, 24), (24, 8, 24), (33, 33, 7)]


@pytest.mark.parametrize("S,q_block,window", WINDOW_CASES,
                         ids=[f"S{s}_qb{q}_w{w}" for s, q, w in WINDOW_CASES])
def test_sliding_window_attention_matches_reference(S, q_block, window):
    """``causal_attention`` with ``window`` against the reference's (GQA, 8
    query heads on 2 kv heads, f32): outputs within 1e-6; and the same
    blockwise path with ``window=None`` is the plain causal one."""
    rng = np.random.default_rng(S + window)
    q = rng.standard_normal((2, S, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, 16)).astype(np.float32) for _ in range(2))
    theirs = JL.causal_attention(*(jnp.asarray(a) for a in (q, k, v)), window=window,
                                 q_block=q_block)
    ours = L.causal_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=window,
                              q_block=q_block)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)
    full = L.causal_attention(*(torch.from_numpy(a) for a in (q, k, v)), q_block=q_block)
    np.testing.assert_allclose(full.numpy(), np.asarray(JL.causal_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_block=q_block)), rtol=1e-6, atol=1e-6)
