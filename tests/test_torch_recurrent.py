"""The recurrent mixers in the port, against the JAX package, on the CPU: the
causal depthwise conv, Mamba-2's chunked SSD (``ssm``) and RecurrentGemma's
RG-LRU (``rglru``), their one-token steps and final states, and the models
built of them.

Inputs are drawn with numpy from fixed seeds; block parameters come from
the reference's ``init_mamba2`` / ``init_rglru`` (the tree the port's
``_mixer_params`` builds), model parameters from its ``init_params``
through ``convert.from_jax_numpy``.  The models are the ``ssm`` and
``rglru`` configs of the reference's ``tests/test_models.py`` (3 layers,
width 64, f32; the RG-LRU pattern two recurrent layers and one
sliding-window layer of window 8).  Everything is f32 and torch runs with
no TF32.  Tolerances, stated per test: elementwise code within 1e-6 (a few
f32 ulps of values of order 1); the scan and the SSD, sums of many terms
in another order, within 1e-5 relative plus 1e-5 of the largest
magnitude; the models' loss rtol 1e-6 and every gradient leaf within 3e-5
of its largest magnitude (``test_torch_model.py``'s); decode against the
full forward within the reference's own 2e-3 (``tests/test_models.py``).

Mamba-2's blocks take 1e-4 in place of 1e-5 and 3e-5: the reference's
SSD takes the exp of differences of log-decay prefix sums, which reach
~10^3 within a 128-position chunk at the arch's decay rates (A up to 16),
where an f32 ulp is ~1e-4; the port sums each segment from its start
(``layers._segsum``, ``_suffix_sums``).  Measured against a float64
evaluation of the port: the reference's f32 ``mamba2_apply`` is off by up
to 2.6e-5 of the largest magnitude at S=256, the port's by 7.4e-7; on the
``ssm`` model's gradients the reference is off by up to 4.0e-5 of a leaf's
largest magnitude (``A_log``), the port by 7.5e-6.

The reference has two defects on these paths (ROADMAP.md, "Reference
caveats"), pinned here without hiding them: its prefill keeps only S conv
inputs of a prompt shorter than the conv's width - 1, and its decode then
raises, where the port zero-pads them; and Mamba-2 asserts on a sequence
longer than 128 that is not a multiple of 128, which the port refuses too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_arch as j_load_arch
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import serve as JS
from repro_torch.configs import load_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import serve as S
from repro_torch.train import trainer as TR

# the reference's tests/test_models.py configs
_BASE = dict(name="t", family="lm", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab_size=500, head_dim=16, dtype="float32", param_dtype="float32")
MODELS = {"ssm": dict(_BASE, pattern=("ssm:none",), d_ff=0, ssm_state=16, ssm_head_dim=16),
          "rglru": dict(_BASE, n_kv_heads=1, pattern=("rglru:dense", "rglru:dense",
                                                     "swa:dense"), window=8)}
ELEM = dict(rtol=1e-6, atol=1e-6)
SSD_REL = 1e-4                       # Mamba-2 blocks: see the module docstring
GRAD_ATOL = {"rglru": 3e-5, "ssm": 1e-4}  # per unit of a leaf's largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    """No TF32 anywhere the tests might reach a card (as run_training sets)."""
    TR.set_matmul_precision()


def _pair(name):
    return JModelConfig(**MODELS[name]), ModelConfig(**MODELS[name])


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_to_scale(ours, theirs, rel, what=""):
    """Within ``rel`` relative plus ``rel`` of the largest magnitude."""
    theirs = _np(theirs)
    np.testing.assert_allclose(_np(ours), theirs, rtol=rel,
                               atol=rel * max(float(np.abs(theirs).max()), 1e-30),
                               err_msg=what)


def _block_params(mixer, jcfg, seed=0):
    init = JL.init_mamba2 if mixer == "ssm" else JL.init_rglru
    jp = init(jax.random.PRNGKey(seed), jcfg)
    return jp, _torch_tree(jp)


# ---------------------------------------------------------------------------
# The conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 3, 9])
def test_conv1d_apply_matches_reference(S):
    """Width 4 over (2, S, 6): f32 within 1e-6 (the same four products and
    adds in the same order)."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 6)).astype(np.float32)
    p = {"w": rng.standard_normal((4, 6)).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    theirs = JL.conv1d_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    ours = L.conv1d_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ours), _np(theirs), **ELEM)


def test_conv1d_step_matches_reference():
    """One decode step from a random (2, 3, 6) state: the f32 output within
    1e-6, the new state (the window's last three rows) equal."""
    rng = np.random.default_rng(1)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    x_t = rng.standard_normal((2, 6)).astype(np.float32)
    p = {"w": rng.standard_normal((4, 6)).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    jy, jst = JL.conv1d_step(jax.tree.map(jnp.asarray, p), jnp.asarray(state), jnp.asarray(x_t))
    y, st = L.conv1d_step({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(state), torch.from_numpy(x_t))
    np.testing.assert_allclose(_np(y), _np(jy), **ELEM)
    np.testing.assert_array_equal(_np(st), _np(jst))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def test_rglru_coeffs_match_reference():
    """a and b of the recurrence from a conv output (2, 5, d_rnn): within
    1e-6."""
    jcfg, cfg = _pair("rglru")
    jp, p = _block_params("rglru", jcfg)
    xc = np.random.default_rng(2).standard_normal((2, 5, cfg.d_rnn)).astype(np.float32)
    ja, jb = JL._rglru_coeffs(jp, jnp.asarray(xc))
    a, b = L._rglru_coeffs(p, torch.from_numpy(xc))
    np.testing.assert_allclose(_np(a), _np(ja), **ELEM)
    np.testing.assert_allclose(_np(b), _np(jb), **ELEM)


@pytest.mark.parametrize("S", [1, 2, 7, 37, 128])
def test_linear_scan_matches_associative_scan(S):
    """``linear_scan`` against ``jax.lax.associative_scan`` with the
    reference's combine, a in (0, 1), b standard normal, (2, S, 5): the same
    recursion, so the same association order; f32 within 1e-6 relative plus
    1e-6 of the largest magnitude (XLA may contract a product and a sum into
    one rounding)."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.05, 0.999, (2, S, 5)).astype(np.float32)
    b = rng.standard_normal((2, S, 5)).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], r[1] + r[0] * l[1]

    _, theirs = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ours = L.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close_to_scale(ours, theirs, 1e-6)
    # and it is the recurrence h_t = a_t h_{t-1} + b_t (float64, loose: the
    # association order differs)
    h, seq = np.zeros((2, 5)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(_np(ours), np.stack(seq, 1), rtol=1e-5, atol=1e-5)


def test_rglru_apply_and_final_state_match_reference():
    """``rglru_apply`` over (2, 11, d) and the state after it (``h`` f32,
    the conv's last three inputs) against the reference's
    ``rglru_apply`` and ``_rglru_final_state``: within 1e-5 relative plus
    1e-5 of the largest magnitude; the conv tail equal."""
    jcfg, cfg = _pair("rglru")
    jp, p = _block_params("rglru", jcfg)
    x = np.random.default_rng(3).standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    _close_to_scale(L.rglru_apply(p, torch.from_numpy(x), cfg),
                    JL.rglru_apply(jp, jnp.asarray(x), jcfg), 1e-5)
    theirs = JT._rglru_final_state(jp, jnp.asarray(x), jcfg)
    ours = T._rglru_final_state(p, torch.from_numpy(x), cfg)
    assert sorted(ours) == sorted(theirs)
    _close_to_scale(ours["h"], theirs["h"], 1e-5)
    np.testing.assert_allclose(_np(ours["conv"]), _np(theirs["conv"]), **ELEM)


def test_rglru_decode_matches_reference():
    """One step from a random cache (h, conv): output and new cache within
    1e-6 relative plus 1e-6 of the largest magnitude."""
    jcfg, cfg = _pair("rglru")
    jp, p = _block_params("rglru", jcfg)
    rng = np.random.default_rng(4)
    cache = {"h": rng.standard_normal((2, cfg.d_rnn)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, cfg.d_rnn)).astype(np.float32)}
    x_t = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    jy, jc = JL.rglru_decode(jp, jax.tree.map(jnp.asarray, cache), jnp.asarray(x_t), jcfg)
    y, c = L.rglru_decode(p, _torch_tree(cache), torch.from_numpy(x_t), cfg)
    _close_to_scale(y, jy, 1e-6)
    for k in jc:
        _close_to_scale(c[k], jc[k], 1e-6, k)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, B=2, S=32, H=3, P=8, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = np.exp(rng.uniform(-1.0, 1.0, H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    return x, dt, A, Bm, Cm


def _recurrence(x, dt, A, Bm, Cm):
    """The SSD as the sequential recurrence of ``tests/test_property.py``,
    in float64: h_t = h_{t-1} exp(-A dt_t) + dt_t x_t B_t^T, y_t = h_t C_t."""
    B, S, H, P = x.shape
    h, ys = np.zeros((B, H, P, Bm.shape[-1])), []
    for t in range(S):
        dA = np.exp(-A[None] * dt[:, t])
        h = h * dA[..., None, None] + np.einsum("bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    """(2, 32, 3, 8) heads, state 8, chunks of 4 to 32: against the
    reference's ``ssd_chunked`` within 1e-5 relative plus 1e-5 of the
    largest magnitude; against the float64 recurrence within the
    reference's own property-test bound, 2e-3 (rtol and atol)."""
    x, dt, A, Bm, Cm = _ssd_inputs(chunk)
    theirs = JL.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk)
    ours = L.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk)
    _close_to_scale(ours, theirs, 1e-5)
    np.testing.assert_allclose(_np(ours), _recurrence(x, dt, A, Bm, Cm)[0], rtol=2e-3,
                               atol=2e-3)


def test_ssd_chunked_refuses_a_ragged_sequence():
    """S not a multiple of the chunk: the reference asserts, the port raises."""
    args = _ssd_inputs(0, S=12)
    with pytest.raises(AssertionError, match="divisible by ssd chunk"):
        JL.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=8)
    with pytest.raises(ValueError, match="divisible by ssd chunk"):
        L.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk=8)


def test_segsum_matches_reference_and_float64():
    """``_segsum`` of log-decays (-A dt, prefix sums reaching ~1,400 over 128
    positions): the same -inf above the diagonal as the reference's; below
    it within 2e-4 absolute of the reference's (its prefix-sum differences
    carry ~1e-4 of rounding) and within a few f32 ulps of each segment's
    own size of a float64 evaluation (1e-6 relative plus 1e-6)."""
    rng = np.random.default_rng(8)
    x = (-16.0 * np.log1p(np.exp(rng.standard_normal((2, 3, 128)))) * 0.6).astype(np.float32)
    theirs = _np(JL._segsum(jnp.asarray(x)))
    ours = _np(L._segsum(torch.from_numpy(x)))
    below = np.tril(np.ones((128, 128), bool))
    assert np.isneginf(ours[..., ~below]).all() and np.isneginf(theirs[..., ~below]).all()
    cs = np.cumsum(x.astype(np.float64), axis=-1)
    exact = (cs[..., :, None] - cs[..., None, :])[..., below]
    np.testing.assert_allclose(ours[..., below], theirs[..., below], rtol=0, atol=2e-4)
    np.testing.assert_allclose(ours[..., below], exact, rtol=1e-6, atol=1e-6)


def test_ssd_backward_is_finite():
    """``_segsum``'s -inf above the diagonal gives zero gradient there: the
    SSD's gradients are finite."""
    args = [torch.from_numpy(a).requires_grad_(True) for a in _ssd_inputs(1, S=16)]
    L.ssd_chunked(*args, chunk=8).square().sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in args)


@pytest.mark.parametrize("S", [2, 24, 128, 256])
def test_mamba2_apply_and_final_state_match_reference(S):
    """``mamba2_apply`` over (2, S, d) (one chunk of S up to 128, two of 128
    at 256) against the reference's, within SSD_REL relative plus SSD_REL
    of the largest magnitude; the final state in closed form against the
    reference's ``_mamba2_final_state``, a sequential scan over S, within
    the same; the conv tail (rows of the in-projection) within 1e-6 where
    S >= 3, and zero-padded on the left of the reference's S rows where S <
    3."""
    jcfg, cfg = _pair("ssm")
    jp, p = _block_params("ssm", jcfg)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    _close_to_scale(L.mamba2_apply(p, torch.from_numpy(x), cfg),
                    JL.mamba2_apply(jp, jnp.asarray(x), jcfg), SSD_REL)
    theirs = JT._mamba2_final_state(jp, jnp.asarray(x), jcfg)
    ours = T._mamba2_final_state(p, torch.from_numpy(x), cfg)
    assert sorted(ours) == sorted(theirs)
    _close_to_scale(ours["state"], theirs["state"], SSD_REL)
    tail = _np(theirs["conv"])
    assert ours["conv"].shape == (2, cfg.conv_width - 1, tail.shape[-1])
    np.testing.assert_allclose(_np(ours["conv"])[:, cfg.conv_width - 1 - tail.shape[1]:],
                               tail, **ELEM)
    assert not ours["conv"][:, :cfg.conv_width - 1 - tail.shape[1]].any()


def test_mamba2_decode_matches_reference():
    """One step from a random cache (state, conv): output and new cache
    within 1e-6 relative plus 1e-6 of the largest magnitude."""
    jcfg, cfg = _pair("ssm")
    jp, p = _block_params("ssm", jcfg)
    rng = np.random.default_rng(5)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    cache = {"state": rng.standard_normal((2, H, P, N)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, cfg.d_inner + 2 * N)).astype(np.float32)}
    x_t = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    jy, jc = JL.mamba2_decode(jp, jax.tree.map(jnp.asarray, cache), jnp.asarray(x_t), jcfg)
    y, c = L.mamba2_decode(p, _torch_tree(cache), torch.from_numpy(x_t), cfg)
    _close_to_scale(y, jy, 1e-6)
    for k in jc:
        _close_to_scale(c[k], jc[k], 1e-6, k)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

def _model(name, seed=3):
    jcfg, cfg = _pair(name)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    flat = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
    return jcfg, cfg, jp, flat


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_grads_match_reference(name):
    """Loss rtol 1e-6 and every gradient leaf within GRAD_ATOL of its largest
    magnitude (3e-5, the ``ssm`` model 1e-4: see the module docstring), (3,
    40) tokens (the ``ssm`` model's SSD in one chunk of 40)."""
    jcfg, cfg, jp, flat = _model(name)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg, remat=False)))(jp)
    grad = torch.zeros_like(flat)
    loss = T.loss_fn(T.layout(cfg).autograd_leaves(flat, grad),
                     {"tokens": torch.from_numpy(tokens).long()}, cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    ours = convert.to_numpy(grad, cfg)
    theirs = dict(convert.flatten_tree(jax.tree.map(np.asarray, jgrads),
                                       is_leaf=lambda x: isinstance(x, np.ndarray)))
    assert sorted(ours) == sorted(theirs)
    for k, g in theirs.items():
        np.testing.assert_allclose(ours[k], g, rtol=0, atol=GRAD_ATOL[name] * np.abs(g).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_decode_matches_full_forward(name):
    """The reference's ``test_decode_matches_forward`` on the port: from an
    empty cache, each of 24 tokens decoded at its position against the full
    forward's logits there, within the reference's 2e-3."""
    _, cfg, _, flat = _model(name, seed=1)
    params = T.layout(cfg).views(flat)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        full = T._logits(params, T.hidden_states(params, {"tokens": tokens}, cfg)[0], cfg)
        cache = T.init_cache(cfg, 2, 24)
        errs = [(T.decode_step(params, cache, tokens[:, i], i, cfg)[0] - full[:, i]).abs().max()
                for i in range(24)]
    assert max(errs) < 2e-3, max(errs)


def test_decode_updates_every_stacked_layer_in_place():
    """``decode_step`` writes each recurrent layer's state into its slice of
    the stacked cache leaves (a layer's entry is a dict of views): after one
    step from zeros every layer's state moved."""
    _, cfg, _, flat = _model("ssm")
    params = T.layout(cfg).views(flat)
    cache = T.init_cache(cfg, 2, 4)
    with torch.no_grad():
        out, same = T.decode_step(params, cache, torch.tensor([3, 7]), 0, cfg)
    assert same is cache
    state = cache["blocks"]["p0"]["state"]
    assert state.shape[0] == cfg.n_layers
    assert all(state[i].abs().max() > 0 for i in range(cfg.n_layers))
    assert all(cache["blocks"]["p0"]["conv"][i, :, -1].abs().max() > 0
               for i in range(cfg.n_layers))


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_2b"])
def test_two_token_prompt_reference_raises_port_serves(arch):
    """A 2-token prompt, shorter than the conv's width - 1: the reference's
    ``generate`` raises (its decode's conv window has 3 rows, not 4); the
    port's serves it, and each of its tokens is the argmax of its own
    full forward over the prompt and the tokens before it (the forward's
    causal conv pads with the zeros the port's cache holds)."""
    jcfg, cfg = j_load_arch(arch).SMOKE, load_arch(arch).SMOKE
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.layout(cfg).views(convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg,
                                                        1)[0])
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    with pytest.raises(ValueError, match="does not match"):
        JS.generate(jp, jcfg, jnp.asarray(prompt), max_new_tokens=4)
    toks, _ = S.generate(params, cfg, torch.from_numpy(prompt), max_new_tokens=4, device="cpu")
    with torch.no_grad():
        for i in range(4):
            seq = torch.cat([torch.from_numpy(prompt).long(), toks[:, :i]], dim=1)
            h = T.hidden_states(params, {"tokens": seq}, cfg)[0][:, -1:]
            full = T._logits(params, h, cfg)[:, 0, :cfg.vocab_size]
            top2 = torch.topk(full, 2, dim=-1).values
            assert (top2[:, 0] - top2[:, 1]).min() > 1e-4      # far from a tie
            assert torch.equal(full.argmax(-1), toks[:, i]), i


def test_both_packages_refuse_a_ragged_mamba2_prompt():
    """A 200-token Mamba-2 prompt (past 128, not a multiple of it): the
    reference asserts in ``ssd_chunked``; the port raises ValueError."""
    jcfg, cfg = j_load_arch("mamba2_780m").SMOKE, load_arch("mamba2_780m").SMOKE
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 200)).astype(np.int32)
    with pytest.raises(AssertionError, match="divisible by ssd chunk"):
        JS.generate(jp, jcfg, jnp.asarray(prompt), max_new_tokens=2)
    flat = T.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="divisible by ssd chunk"):
        S.generate(flat, cfg, torch.from_numpy(prompt), max_new_tokens=2, device="cpu")
