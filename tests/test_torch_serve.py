"""The port's serving path (KV cache, prefill, one-token decode, ``generate``)
against the JAX package's, on the CPU.

Params come from the reference's ``T.init_params`` through
``convert.from_jax_numpy``; prompts are drawn with numpy.  Configs: nano,
gpt2_small_smoke (MHA, tied), granite_34b_smoke (MQA, one kv head, untied
head), two sliding-window models (the 19-token prompt inside a 32-token
window, and past an 8-token window: the ring's splice rolls), and the
SMOKE configs of gemma3_1b, granite_moe_3b_a800m and
llama4_maverick_400b_a17b (MoE in prefill and decode), mamba2_780m and
recurrentgemma_2b (the recurrent states: prefill's final state, decode's
step, the splice copying them through), all f32, at most two layers.  A decode of 14 tokens wraps an 8-slot ring twice.
Tolerances (f32, sums in other orders through two layers):
``decode_attention`` alone within 1e-6; logits within 2e-5 absolute plus
1e-5 relative, cache keys, values and recurrent states within 1e-5
absolute plus 1e-5 relative (mamba2's within 1e-4 of each leaf's largest
magnitude: ``SSD_CACHE_REL``); greedy tokens equal (every
step's top-2 logit margin in these cases is far above the logit tolerance,
which the test checks); the splice copies, so its leaves are bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro_torch.models as PM
from benchmarks.tables import NANO as J_NANO
from repro.configs import load_arch as j_load_arch
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import serve as JS
from repro_torch.configs import load_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.nano import NANO
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import serve as S
from repro_torch.train import trainer as TR

def _pair(**kw):
    return JModelConfig(**kw), ModelConfig(**kw)


# a sliding-window layer with the prompt shorter than the window (one
# windowed remainder layer) and longer (a stacked windowed layer beside a
# global one): prefill keeps the last min(window, S) positions, the splice
# rolls them into the ring
_SWA = dict(family="lm", d_model=32, n_heads=4, n_kv_heads=2, d_ff=48, vocab_size=80,
            head_dim=8, pattern=("swa:dense", "attn:dense"), act="gelu", dtype="float32",
            param_dtype="float32", vocab_pad_to=32, q_block=8)
CASES = {"nano": (J_NANO, NANO),
         "gpt2_small_smoke": (j_load_arch("gpt2_small").SMOKE, load_arch("gpt2_small").SMOKE),
         "granite_34b_smoke": (j_load_arch("granite_34b").SMOKE, load_arch("granite_34b").SMOKE),
         "swa_prompt_in_window": _pair(name="swa_w32", n_layers=1, window=32, **_SWA),
         "swa_prompt_past_window": _pair(name="swa_w8", n_layers=2, window=8, **_SWA),
         **{f"{a.split('_')[0]}_smoke": (j_load_arch(a).SMOKE, load_arch(a).SMOKE)
            for a in ("gemma3_1b", "granite_moe_3b_a800m", "llama4_maverick_400b_a17b",
                      "mamba2_780m", "recurrentgemma_2b")}}
B, S_PROMPT, NEW = 2, 19, 6
LOGIT_TOL = dict(rtol=1e-5, atol=2e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
# The reference's Mamba-2 SSD takes the exp of differences of log-decay
# prefix sums, with ~1e-4 of rounding where the port sums each segment from
# its start (tests/test_torch_recurrent.py's SSD_REL): its cache leaves (the
# SSD state and, from the second layer on, the conv's inputs) within 1e-4
# of each leaf's largest magnitude (measured here up to 2.9e-6)
SSD_CACHE_REL = 1e-4


def _cache_tol(name: str, leaf: np.ndarray) -> dict:
    if name == "mamba2_smoke":
        return dict(rtol=0, atol=SSD_CACHE_REL * float(np.abs(leaf).max()))
    return CACHE_TOL


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    """No TF32 anywhere the tests might reach a card (as run_training sets)."""
    TR.set_matmul_precision()


def _setup(name, seed=0):
    jcfg, cfg = CASES[name]
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    flat = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S_PROMPT))
    return jcfg, cfg, jp, T.layout(cfg).views(flat), prompt.astype(np.int32)


def _leaves(cache) -> dict:
    """``{path: f32 numpy}`` of a cache of either package."""
    as_np = lambda x: np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x,
                                 np.float32)
    return {k: as_np(v) for k, v in convert.flatten_tree(
        cache, is_leaf=lambda x: isinstance(x, (torch.Tensor, jax.Array)))}


def _assert_caches_close(ours, theirs, name):
    a, b = _leaves(ours), _leaves(theirs)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **_cache_tol(name, b[k]))


@pytest.mark.parametrize("per_row", [False, True], ids=["mask_S", "mask_BS"])
def test_decode_attention_matches_reference(per_row):
    """GQA (8 query heads on 2 kv heads), the valid mask per position or per
    batch row: f32 outputs within 1e-6."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, 11, 2, 16)).astype(np.float32) for _ in range(2))
    valid = (np.arange(11)[None, :] <= np.array([[4], [10], [0]])) if per_row else (
        np.arange(11) <= 6)
    theirs = JL.decode_attention(*(jnp.asarray(a) for a in (q, k, v, valid)))
    ours = L.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, valid)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_matches_reference(name):
    jcfg, cfg, jp, params, prompt = _setup(name)
    jlogits, jcache = JT.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg, remat=False)
    with torch.no_grad():
        logits, cache = T.prefill(params, {"tokens": torch.from_numpy(prompt).long()}, cfg)
    assert logits.shape == (B, cfg.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
    _assert_caches_close(cache, jcache, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_step_matches_reference(name):
    """A spliced prefill cache, then two decode steps at positions S and
    S + 1 from the same tokens: logits and every cache leaf."""
    jcfg, cfg, jp, params, prompt = _setup(name, seed=1)
    max_len = S_PROMPT + 4
    _, jsmall = JT.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg, remat=False)
    jcache = JS._splice_cache(JT.init_cache(jcfg, B, max_len, jcfg.act_dtype), jsmall, jcfg,
                              S_PROMPT)
    with torch.no_grad():
        _, small = T.prefill(params, {"tokens": torch.from_numpy(prompt).long()}, cfg)
        cache = S._splice_cache(T.init_cache(cfg, B, max_len), small, cfg, S_PROMPT)
        toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, B)).astype(np.int32)
        for i, tok in enumerate(toks):
            jlogits, jcache = JT.decode_step(jp, jcache, jnp.asarray(tok),
                                             jnp.int32(S_PROMPT + i), jcfg)
            logits, cache = T.decode_step(params, cache, torch.from_numpy(tok).long(),
                                          S_PROMPT + i, cfg)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
            _assert_caches_close(cache, jcache, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_splice_cache_leaf_equal(name):
    jcfg, cfg, jp, params, prompt = _setup(name, seed=2)
    _, jsmall = JT.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg, remat=False)
    small = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jsmall)
    big = T.init_cache(cfg, B, S_PROMPT + 5)
    ours = S._splice_cache(big, small, cfg, S_PROMPT)
    theirs = JS._splice_cache(JT.init_cache(jcfg, B, S_PROMPT + 5, jcfg.act_dtype), jsmall,
                              jcfg, S_PROMPT)
    a, b = _leaves(ours), _leaves(theirs)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a prompt as long as the cache: full-attention leaves copy straight
    # through, a sliding-window ring is rolled as the reference rolls it
    same = S._splice_cache(T.init_cache(cfg, B, S_PROMPT), small, cfg, S_PROMPT)
    theirs = _leaves(JS._splice_cache(JT.init_cache(jcfg, B, S_PROMPT, jcfg.act_dtype), jsmall,
                                      jcfg, S_PROMPT))
    for k, v in _leaves(same).items():
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)
        if "swa" not in cfg.pattern[int(k.split(".")[1][1:]) if k.startswith("blocks")
                                    else int(k.split(".")[1])]:
            np.testing.assert_array_equal(v, _leaves(small)[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_generate_matches_reference(name):
    jcfg, cfg, jp, params, prompt = _setup(name, seed=3)
    jtoks, jstats = JS.generate(jp, jcfg, jnp.asarray(prompt), max_new_tokens=NEW)
    toks, stats = S.generate(params, cfg, torch.from_numpy(prompt), max_new_tokens=NEW,
                             device="cpu")
    assert toks.shape == (B, NEW) and toks.device.type == "cpu"
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert set(stats) == set(jstats) and stats["tok_per_s"] > 0
    # the tokens are far from ties: each step's top-2 margin (teacher-forced
    # reference logits) exceeds the logit tolerance many times over
    cur = jnp.asarray(prompt)
    for i in range(NEW):
        lg = np.asarray(JT.prefill(jp, {"tokens": cur}, jcfg, remat=False)[0])[:, :cfg.vocab_size]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 10 * LOGIT_TOL["atol"]
        cur = jnp.concatenate([cur, jnp.asarray(toks.numpy()[:, i:i + 1], jnp.int32)], axis=1)


def test_generate_takes_the_flat_buffer_and_samples_with_a_generator():
    """``params`` as the flat (N,) buffer gives the dict's tokens; temperature
    sampling follows its generator (same seed, same tokens) and stays in
    the unpadded vocabulary."""
    cfg = NANO
    flat = T.init_params(torch.Generator().manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (3, 7), generator=torch.Generator().manual_seed(1))
    a, _ = S.generate(flat, cfg, prompt, max_new_tokens=5, device="cpu")
    b, _ = S.generate(T.layout(cfg).views(flat), cfg, prompt, max_new_tokens=5, device="cpu")
    assert torch.equal(a, b)
    draws = [S.generate(flat, cfg, prompt, max_new_tokens=5, temperature=1.5, device="cpu",
                        rng=torch.Generator().manual_seed(7))[0] for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert draws[0].min() >= 0 and draws[0].max() < cfg.vocab_size


def test_bf16_decode_follows_the_full_forward():
    """The card's serve check in miniature: a bf16 model, each decode step's
    logits against a full forward over prompt + generated[:i] at its last
    position.  The two paths round bf16 activations at other shapes, so the
    bound is a bf16 one: 0.05 absolute on logits of magnitude ~1."""
    cfg = ModelConfig(name="bf16", family="lm", n_layers=3, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=96, head_dim=16, mlp_gated=False,
                      act="gelu", vocab_pad_to=32)
    flat = T.init_params(torch.Generator().manual_seed(0), cfg)
    params = T.layout(cfg).views(flat)
    prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    toks, _ = S.generate(params, cfg, prompt, max_new_tokens=6, device="cpu")
    with torch.no_grad():
        logits, small = T.prefill(params, {"tokens": prompt}, cfg)
        cache = S._splice_cache(T.init_cache(cfg, 2, 18), small, cfg, 12)
        for i in range(6):
            if i:
                logits, cache = T.decode_step(params, cache, toks[:, i - 1], 11 + i, cfg)
            seq = torch.cat([prompt, toks[:, :i]], dim=1)
            h = T.hidden_states(params, {"tokens": seq}, cfg)[0][:, -1:]
            full = T._logits(params, h, cfg)[:, 0]
            assert (logits - full).abs().max().item() < 0.05, i
            assert torch.equal(logits[:, :cfg.vocab_size].argmax(-1), toks[:, i])


def test_models_package_exports_the_reference_names():
    names = ("init_params", "loss_fn", "hidden_states", "init_cache", "decode_step", "prefill")
    for n in names:
        assert callable(getattr(PM, n)) and callable(getattr(JM, n)), n
        assert getattr(PM, n) is getattr(T, n)


def test_unported_mixers_and_extra_batch_raise():
    """Cross-attention in a decoder-only model (no encoder to attend to)
    raises.  The recurrent mixers are served: their zero cache has the
    reference's structure, shapes and dtypes (the state f32, the conv's
    inputs in the activation dtype), stacked on the scanned blocks.
    Whisper and ``extra_batch`` (frames, patches) are served since the
    encdec / VLM port: ``tests/test_torch_encdec_vlm.py``."""
    xattn = dataclasses.replace(load_arch("gpt2_small").SMOKE, name="x",
                                pattern=("attn:dense", "xattn:dense"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.init_cache(xattn, 1, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        S.generate({}, xattn, torch.zeros(1, 4, dtype=torch.long), device="cpu")
    for arch in ("mamba2_780m", "recurrentgemma_2b"):
        cfg = dataclasses.replace(load_arch(arch).SMOKE, dtype="bfloat16")
        jcfg = dataclasses.replace(j_load_arch(arch).SMOKE, dtype="bfloat16")
        ours = convert.flatten_tree(T.init_cache(cfg, 3, 8),
                                    is_leaf=lambda x: isinstance(x, torch.Tensor))
        theirs = convert.flatten_tree(JT.init_cache(jcfg, 3, 8),
                                      is_leaf=lambda x: isinstance(x, jax.Array))
        assert [(k, tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in ours] == [
            (k, tuple(v.shape), str(v.dtype)) for k, v in theirs]
        assert not any(v.any() for _, v in ours)


def test_decode_wraps_the_ring():
    """A sliding-window model (window 8) prompted with 5 tokens decodes 14
    more against a cache of 8 ring slots: positions 8..18 overwrite slots 0..2
    and the ring wraps twice.  Every step's logits and cache leaves against
    the reference's (the module's tolerances)."""
    jcfg, cfg = CASES["swa_prompt_past_window"]
    jp = JT.init_params(jax.random.PRNGKey(4), jcfg)
    params = T.layout(cfg).views(convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, 1)[0])
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 5)).astype(np.int32)
    max_len = 5 + 14
    _, jsmall = JT.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg, remat=False)
    jcache = JS._splice_cache(JT.init_cache(jcfg, B, max_len, jcfg.act_dtype), jsmall, jcfg, 5)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (14, B)).astype(np.int32)
    with torch.no_grad():
        _, small = T.prefill(params, {"tokens": torch.from_numpy(prompt).long()}, cfg)
        cache = S._splice_cache(T.init_cache(cfg, B, max_len), small, cfg, 5)
        assert cache["blocks"]["p0"]["k"].shape[2] == cfg.window   # the ring
        assert cache["blocks"]["p1"]["k"].shape[2] == max_len      # the global layer
        for i, tok in enumerate(toks):
            jlogits, jcache = JT.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(5 + i), jcfg)
            logits, cache = T.decode_step(params, cache, torch.from_numpy(tok).long(), 5 + i,
                                          cfg)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
            _assert_caches_close(cache, jcache, "swa_prompt_past_window")
