"""The port's mixture of experts (``layers.moe_apply``) against the JAX
package's, on the CPU.

Params come from the reference's ``init_moe``; inputs are drawn with numpy.
Every option of the config: ``moe_impl`` ragged (a stable sort by expert
and one product per expert) or dense, ``moe_combine`` scatter or ksum, with
and without a shared expert.  The chosen experts are compared first, so a
flipped route fails as such.  Tolerances (f32, sums in other orders):
output within 1e-6 absolute plus 1e-5 relative, the aux loss rtol 1e-6,
the gradient of sum(out * c) + aux with respect to x and every leaf within
3e-5 of that leaf's largest magnitude.

bf16 (the activation and parameter dtype of the FULL configs, the router
f32): the products round to bf16 in both packages, each at its own
accumulation order, and the scatter combine adds a token's K products in
the same order with one rounding per add; the bound, stated before the
reading, is 2^-6 of the largest |output| (two bf16 roundings of a
product, 2^-8 each, carried through the gated product and the combine).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import layers as JL
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_BASE = dict(name="moe", family="lm", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
             d_ff=24, vocab_size=64, pattern=("attn:moe",), n_experts=6, top_k=3,
             mlp_gated=True, act="silu", dtype="float32", param_dtype="float32")
OPTIONS = [(impl, combine, shared) for impl in ("ragged", "dense")
           for combine in ("scatter", "ksum") for shared in (0, 1)]


def _cfgs(**kw):
    d = dict(_BASE, **kw)
    return JModelConfig(**d), ModelConfig(**d)


def _torch_tree(p):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32), p)


def _chosen(router, x, k):
    """Each package's top-k experts of its own routing of x."""
    xt = x.reshape(-1, x.shape[-1])
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xt, jnp.float32) @ router), k)
    _, idx = torch.topk(torch.softmax(torch.from_numpy(xt).float()
                                      @ torch.from_numpy(np.array(router)), -1), k)
    return np.asarray(jidx), idx.numpy()


@pytest.mark.parametrize("impl,combine,shared", OPTIONS,
                         ids=[f"{i}-{c}-shared{s}" for i, c, s in OPTIONS])
def test_moe_apply_matches_reference(impl, combine, shared):
    jcfg, cfg = _cfgs(moe_impl=impl, moe_combine=combine, n_shared_experts=shared)
    jp = JL.init_moe(jax.random.PRNGKey(shared), jcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    c = rng.standard_normal((2, 9, 32)).astype(np.float32)

    jidx, idx = _chosen(jp["router"], x, cfg.top_k)
    np.testing.assert_array_equal(idx, jidx)

    def jobj(p, xx):
        out, aux = JL.moe_apply(p, xx, jcfg)
        return jnp.sum(out * c) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(jobj, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    p = jax.tree.map(lambda t: t.requires_grad_(True), _torch_tree(jp))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = L.moe_apply(p, xt, cfg)
    (torch.sum(out * torch.from_numpy(c)) + aux).backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    assert aux.dtype == torch.float32
    grads = [("x", xt.grad, jgx)] + [
        (jax.tree_util.keystr(path), leaf.grad, g) for (path, leaf), g in zip(
            jax.tree_util.tree_flatten_with_path(p)[0], jax.tree.leaves(jgp))]
    assert len(grads) == 1 + len(jax.tree.leaves(jp))
    for name, ours, theirs in grads:
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=3e-5 * np.abs(theirs).max(), err_msg=name)


@pytest.mark.parametrize("combine", ["scatter", "ksum"])
def test_moe_apply_bf16_matches_reference(combine):
    """bf16 activations and experts, the router f32: the chosen experts
    equal, the output within 2^-6 of its largest magnitude, the aux loss
    (f32 routing of the same bf16 input) rtol 1e-6."""
    jcfg, cfg = _cfgs(moe_combine=combine, n_shared_experts=1, dtype="bfloat16",
                      param_dtype="bfloat16")
    jp = JL.init_moe(jax.random.PRNGKey(4), jcfg)
    assert jp["router"].dtype == jnp.float32 and jp["we1"].dtype == jnp.bfloat16
    x = jnp.asarray(np.random.default_rng(8).standard_normal((3, 7, 32)), jnp.bfloat16)
    jidx, idx = _chosen(jp["router"], np.asarray(x, np.float32), cfg.top_k)
    np.testing.assert_array_equal(idx, jidx)
    jout, jaux = JL.moe_apply(jp, x, jcfg)
    out, aux = L.moe_apply(_torch_tree(jp), torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16), cfg)
    assert out.dtype == torch.bfloat16
    theirs = np.asarray(jout, np.float32)
    np.testing.assert_allclose(out.float().numpy(), theirs, rtol=0,
                               atol=2.0 ** -6 * np.abs(theirs).max())
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


def test_grouped_mm_is_ragged_dot_with_empty_groups():
    """``grouped_mm`` against ``jax.lax.ragged_dot`` with groups of 0 rows
    (f32, within 1e-6), and its gradients against a dense per-row product."""
    rng = np.random.default_rng(9)
    sizes = [3, 0, 5, 0, 1]
    x = rng.standard_normal((9, 4)).astype(np.float32)
    w = rng.standard_normal((5, 4, 6)).astype(np.float32)
    theirs = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes, jnp.int32))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    ours = L.grouped_mm(xt, wt, sizes)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)
    ours.sum().backward()
    group = np.repeat(np.arange(5), sizes)
    dense = lambda xx, ww: jnp.einsum("td,tdf->tf", xx, ww[group]).sum()
    jgx, jgw = jax.grad(dense, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=1e-6, atol=1e-6)
    assert not wt.grad[1].any() and not wt.grad[3].any()
