"""The port's optimizer kernels against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions; they are held
against ``repro.kernels.ref`` and against ``repro.kernels.ops.*_tree``
(whose Pallas kernels run in interpret mode on the CPU), with the same
SHAPES x DTYPES grid and tolerances as tests/test_kernels.py: x / p
rtol = atol = 1e-5, m / v rtol 1e-5, atol 1e-6.  Inputs are drawn with
numpy; bf16 inputs are rounded once in torch and handed to JAX exactly.

The ``gpu`` test holds each CUDA kernel against its plain version on the
card and skips where there is none.  JAX is imported lazily, so that test
also runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw_update, dsm_update
from repro_torch.kernels.adamw_update import adamw_update_plain
from repro_torch.kernels.dsm_update import dsm_update_plain, sign_like_jnp

SHAPES = [(7,), (128,), (129,), (1000,), (33, 77), (4, 128, 130), (2, 3, 5, 64)]
DTYPES = [torch.float32, torch.bfloat16]
DSM_HP = dict(eta=0.8, beta1=0.95, beta2=0.98, lam=0.1)
ADAMW_HP = dict(beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1)


def _jax():
    import jax.numpy as jnp

    from repro.kernels import ops, ref

    return jnp, ops, ref


def _tensor(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _j(t: torch.Tensor):
    """The same values as a JAX array of the same dtype (bf16 via f32: exact)."""
    jnp, _, _ = _jax()
    jdt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.to(torch.float32).numpy()).astype(jdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close_x(a, b):
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


def _close_mv(a, b):
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def _dsm_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x0 = _tensor(rng.standard_normal(shape), dtype)
    m = _tensor(rng.standard_normal(shape), torch.float32)
    xt = (x0.to(torch.float32) - 0.01 * _tensor(rng.standard_normal(shape), torch.float32))
    return x0, m, xt.to(dtype)


def _adamw_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    p = _tensor(rng.standard_normal(shape), dtype)
    g = _tensor(rng.standard_normal(shape), dtype)
    m = _tensor(rng.standard_normal(shape), torch.float32)
    v = _tensor(np.abs(rng.standard_normal(shape)), torch.float32)
    return p, g, m, v


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dsm_update_plain_matches_reference_and_pallas(shape, dtype):
    jnp, ops, ref = _jax()
    x0, m, xt = _dsm_inputs(shape, dtype, seed=len(shape) * 1000 + shape[-1])
    gamma = 0.02
    xr, mr = ref.dsm_update_ref(_j(x0), _j(m), _j(xt), jnp.float32(gamma), **DSM_HP)
    xk, mk = ops.dsm_update_tree({"a": _j(x0)}, {"a": _j(m)}, {"a": _j(xt)},
                                 jnp.float32(gamma), **DSM_HP)
    x_out, m_out = dsm_update(x0.clone(), m.clone(), xt, gamma, **DSM_HP)
    assert x_out.dtype == dtype and m_out.dtype == torch.float32
    _close_x(x_out, xr)
    _close_mv(m_out, mr)
    _close_x(x_out, xk["a"])
    _close_mv(m_out, mk["a"])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_adamw_update_plain_matches_reference_and_pallas(shape, dtype):
    jnp, ops, ref = _jax()
    p, g, m, v = _adamw_inputs(shape, dtype, seed=len(shape) * 1000 + shape[-1] + 7)
    gamma, step = 1e-3, 11
    args = (_j(p), _j(g), _j(m), _j(v), jnp.float32(gamma), jnp.float32(step))
    pr, mr, vr = ref.adamw_update_ref(*args, **ADAMW_HP)
    pk, mk, vk = ops.adamw_update_tree(*({"a": a} for a in args[:4]), args[4], args[5])
    p_out, m_out, v_out = adamw_update(p.clone(), g, m.clone(), v.clone(), gamma, step,
                                       round_direction=False, **ADAMW_HP)
    for ours, theirs in ((p_out, pr), (p_out, pk["a"])):
        _close_x(ours, theirs)
    for ours, theirs in ((m_out, mr), (m_out, mk["a"]), (v_out, vr), (v_out, vk["a"])):
        _close_mv(ours, theirs)


@pytest.mark.parametrize("dtype", DTYPES)
def test_adamw_round_direction_matches_training_path(dtype):
    """round_direction=True is base_opt.adamw().direction (d rounded to the
    param dtype) followed by the local update (x - gamma * d) in f32."""
    import jax.numpy as jnp

    from repro.core.base_opt import adamw

    p, g, m, v = _adamw_inputs((33, 77), dtype, seed=5)
    gamma, step = 3e-3, 4
    opt = adamw()
    state = opt.init({"a": _j(p)})._replace(m={"a": _j(m)}, v={"a": _j(v)})
    d, new_state = opt.direction({"a": _j(g)}, state, {"a": _j(p)}, jnp.int32(step))
    p_ref = (_j(p).astype(jnp.float32) - gamma * d["a"].astype(jnp.float32)).astype(_j(p).dtype)

    p_out, m_out, v_out = adamw_update(p.clone(), g, m.clone(), v.clone(), gamma, step,
                                       round_direction=True)
    _close_x(p_out, p_ref)
    _close_mv(m_out, new_state.m["a"])
    _close_mv(v_out, new_state.v["a"])
    if dtype == torch.bfloat16:
        # the two roundings are different functions in bf16
        single = adamw_update_plain(p.clone(), g, m.clone(), v.clone(), gamma, step,
                                    round_direction=False)[0]
        assert not torch.equal(single, p_out)


def test_sign_matches_jnp_sign_on_zeros_and_nan():
    jnp, _, _ = _jax()
    u = np.array([0.0, -0.0, np.nan, 1.5, -2.0, 1e-30, -1e-30], np.float32)
    ours = sign_like_jnp(torch.from_numpy(u)).numpy()
    theirs = np.asarray(jnp.sign(jnp.asarray(u)))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(np.signbit(ours), np.signbit(theirs))
    assert np.isnan(ours[2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_dsm_update_zero_and_nan_propagation(dtype):
    """u = 0 gives sign 0 (only the weight decay moves x), keeping the sign of
    a zero u as the reference does; a NaN in x_tau reaches x and m as NaN,
    as in the reference kernel."""
    jnp, _, ref = _jax()
    x0, m, xt = _dsm_inputs((64,), dtype, seed=9)
    m[:4] = 0.0
    m[1] = -0.0
    xt[:4] = x0[:4]                          # delta = 0 -> u = +0
    xt[5] = float("nan")
    m[6] = float("nan")
    x0[7], xt[7], m[7] = -0.0, 0.0, -0.0     # delta = -0 - +0 = -0 -> u = -0, x' = +0
    x0[8], xt[8], m[8] = -0.0, -0.0, -0.0    # delta = +0 -> u = +0, x' = -0
    gamma = 0.05
    xr, mr = ref.dsm_update_ref(_j(x0), _j(m), _j(xt), jnp.float32(gamma), **DSM_HP)
    x_out, m_out = dsm_update(x0.clone(), m.clone(), xt, gamma, **DSM_HP)
    np.testing.assert_allclose(_np(x_out), _np(xr), rtol=1e-5, atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(_np(m_out), _np(mr), rtol=1e-5, atol=1e-6, equal_nan=True)
    assert torch.isnan(x_out[[5, 6]]).all() and torch.isnan(m_out[[5, 6]]).all()
    fin = ~np.isnan(_np(xr))
    np.testing.assert_array_equal(np.signbit(_np(x_out))[fin], np.signbit(_np(xr))[fin])
    np.testing.assert_array_equal(np.signbit(_np(m_out))[fin], np.signbit(_np(mr))[fin])
    assert not torch.signbit(x_out[7]) and torch.signbit(x_out[8]) and torch.signbit(m_out[7])
    decay_only = (x0[:4].float() - np.float32(DSM_HP["eta"]) * np.float32(gamma)
                  * (np.float32(DSM_HP["lam"]) * x0[:4].float())).to(dtype)
    torch.testing.assert_close(x_out[:4], decay_only, rtol=0, atol=0)


def test_flat_multi_leaf_call_matches_leafwise_jax():
    """One call over a flat buffer of several leaves equals the reference's
    leafwise calls (no per-leaf padding or state in the flat layout)."""
    jnp, ops, _ = _jax()
    rng = np.random.default_rng(3)
    shapes = {"b": (48,), "emb": (100, 16), "w": (64, 48)}
    leaves = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    flat = np.concatenate([leaves[k].ravel() for k in sorted(leaves)])
    sizes = [leaves[k].size for k in sorted(leaves)]

    def split(a):
        parts = np.split(_np(a), np.cumsum(sizes)[:-1])
        return {k: p.reshape(shapes[k]) for k, p in zip(sorted(leaves), parts)}

    x0 = torch.from_numpy(flat)
    m = torch.from_numpy(rng.standard_normal(flat.size).astype(np.float32))
    xt = x0 - 0.01 * torch.from_numpy(rng.standard_normal(flat.size).astype(np.float32))
    jx = {k: jnp.asarray(v) for k, v in split(x0).items()}
    jm = {k: jnp.asarray(v) for k, v in split(m).items()}
    jt = {k: jnp.asarray(v) for k, v in split(xt).items()}
    xk, mk = ops.dsm_update_tree(jx, jm, jt, jnp.float32(0.01), **DSM_HP)
    x_out, m_out = dsm_update(x0.clone(), m.clone(), xt, 0.01, **DSM_HP)
    for k, v in split(x_out).items():
        _close_x(v, xk[k])
    for k, v in split(m_out).items():
        _close_mv(v, mk[k])

    g = torch.from_numpy(rng.standard_normal(flat.size).astype(np.float32))
    v0 = torch.from_numpy(np.abs(rng.standard_normal(flat.size)).astype(np.float32))
    jg = {k: jnp.asarray(a) for k, a in split(g).items()}
    jv = {k: jnp.asarray(a) for k, a in split(v0).items()}
    pk, mk2, vk = ops.adamw_update_tree(jx, jg, jm, jv, jnp.float32(1e-3), jnp.float32(3))
    p_out, m_out, v_out = adamw_update(x0.clone(), g, m.clone(), v0.clone(), 1e-3, 3,
                                       round_direction=False)
    for ours, theirs, close in ((p_out, pk, _close_x), (m_out, mk2, _close_mv),
                                (v_out, vk, _close_mv)):
        for k, v in split(ours).items():
            close(v, theirs[k])


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(8)
    with pytest.raises(TypeError):
        dsm_update(x, torch.zeros(8, dtype=torch.bfloat16), x.clone(), 0.1, **DSM_HP)
    with pytest.raises(ValueError):
        dsm_update(x, torch.zeros(9), x.clone(), 0.1, **DSM_HP)
    with pytest.raises(ValueError):
        adamw_update(torch.zeros(4, 4).t(), torch.zeros(4, 4), torch.zeros(4, 4),
                     torch.zeros(4, 4), 1e-3, 0)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> None:
    """NaN where NaN; every other entry the same bit pattern."""
    assert a.dtype == b.dtype
    assert torch.equal(a.isnan(), b.isnan())
    fin = ~b.isnan()
    as_int = torch.int32 if a.dtype == torch.float32 else torch.int16
    assert torch.equal(a.view(as_int)[fin], b.view(as_int)[fin])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernels_match_plain_on_card(dtype):
    """Each CUDA kernel against its plain version on the card, on a ragged
    size with +0, -0 and NaN in u.  The kernels are built with --fmad=false
    and take the same f32 constants, so they agree bit for bit (compared as
    integers, so that +0 and -0 differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 1_000_003
    x0 = torch.randn(n, generator=gen, device="cuda").to(dtype)
    m = torch.randn(n, generator=gen, device="cuda")
    xt = (x0.float() - 0.01 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
    x0[:2], m[:2] = -0.0, -0.0
    xt[0], xt[1] = 0.0, -0.0                 # u = -0 and u = +0
    xt[2] = float("nan")
    ka, kb = (x0.clone(), m.clone()), (x0.clone(), m.clone())
    before = dsm_update.launches
    dsm_update(*ka, xt, 0.02, **DSM_HP)
    dsm_update_plain(*kb, xt, 0.02, **DSM_HP)
    torch.cuda.synchronize()
    assert dsm_update.launches == before + 1
    for a, b in zip(ka, kb):
        _same_bits(a, b)

    p = torch.randn(2, n, generator=gen, device="cuda").to(dtype)
    g = torch.randn(2, n, generator=gen, device="cuda").to(dtype)
    mm = torch.randn(2, n, generator=gen, device="cuda")
    v = torch.rand(2, n, generator=gen, device="cuda")
    for rd in (False, True):
        ka = (p.clone(), mm.clone(), v.clone())
        kb = (p.clone(), mm.clone(), v.clone())
        adamw_update(ka[0], g, ka[1], ka[2], 1e-3, 11, round_direction=rd)
        adamw_update_plain(kb[0], g, kb[1], kb[2], 1e-3, 11, round_direction=rd)
        torch.cuda.synchronize()
        for a, b in zip(ka, kb):
            _same_bits(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_dsm_kernel_on_a_zero_shard_view(dtype):
    """The ZeRO call site: the DSM kernel through ``zero.dsm_update_shard``
    on one rank's shard, a view at a 128-aligned offset into the flat
    buffers (rank 2 of 4 over the ragged 1,000,003).  Bit-equal to the plain
    version on the same view; the rest of the buffers untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    from repro_torch.core.dsm import DSMConfig
    from repro_torch.distributed import zero

    n = 1_000_003
    a, b = zero.shard_bounds(n, 4)[2]
    assert a % 128 == 0
    gen = torch.Generator(device="cuda").manual_seed(1)
    x0 = torch.randn(n, generator=gen, device="cuda").to(dtype)
    m = torch.randn(n, generator=gen, device="cuda")
    xt = (x0.float() - 0.01 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
    cfg = DSMConfig(global_lr=DSM_HP["eta"], beta1=DSM_HP["beta1"], beta2=DSM_HP["beta2"],
                    weight_decay=DSM_HP["lam"])
    ka, kb = (x0.clone(), m.clone()), (x0.clone(), m.clone())
    before = dsm_update.launches
    zero.dsm_update_shard(ka[0][a:b], ka[1][a:b], xt[a:b], 0.02, cfg)
    dsm_update_plain(kb[0][a:b], kb[1][a:b], xt[a:b], 0.02, **DSM_HP)
    torch.cuda.synchronize()
    assert dsm_update.launches == before + 1
    for new, plain, old in zip(ka, kb, (x0, m)):
        _same_bits(new, plain)
        _same_bits(torch.cat([new[:a], new[b:]]), torch.cat([old[:a], old[b:]]))
    assert not torch.equal(ka[0][a:b], x0[a:b])
