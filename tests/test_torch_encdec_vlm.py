"""The encoder-decoder (whisper_large_v3) and VLM (llava_next_34b) families in
the port, against the JAX package, on the CPU.

Params come from the reference's ``init_params`` through
``convert.from_jax_numpy``; batches are the reference's dicts, drawn with
numpy: ``tokens`` beside ``frames`` (B, enc_len, d_model) for whisper,
after ``patches`` (B, n_patches, d_model) for llava.  Both SMOKE configs
are f32 with two layers (whisper's encoder two more); torch runs with no
TF32.  Loss and gradients of both are held in ``test_torch_archs.py``
(``PORTED``); here the pieces the two families add.  Tolerances (f32, sums
in other orders through two layers): ``full_attention`` within 1e-6; the
loss within 1e-5 relative; hidden states and cache leaves within 1e-5
relative plus 1e-5 of the array's largest magnitude, logits 2e-5 of it
(``test_torch_serve.py``'s bounds scaled: the frames and patches are
standard normal, so activations reach ~5, where 1e-5 absolute is ~40 f32
ulps; measured up to 2.6e-5 absolute); greedy tokens equal, each step's
top-2 margin far above the logit tolerance (checked).

The reference's ``generate`` sizes a VLM's cache ``S + max_new_tokens``
though prefill fills ``n_patches + S`` positions: it raises when
``max_new_tokens < n_patches``, and from decode step ``max_new_tokens -
n_patches`` on it writes a clamped slot.  Its tokens are held only where it
is right; every token of the port is held against the port's own
teacher-forced full forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_arch as j_load_arch
from repro.configs import specs as j_specs
from repro.core import DSMConfig as JDSMConfig
from repro.core import constant as j_constant
from repro.core import dsm_init as j_dsm_init
from repro.core import get_base_optimizer as j_get_base_optimizer
from repro.core import make_dsm_step as j_make_dsm_step
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import serve as JS
from repro_torch.configs import load_arch, specs
from repro_torch.core import base_opt as B
from repro_torch.core import dsm as D
from repro_torch.core import schedules as SC
from repro_torch.distributed import spawn
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import serve as S
from repro_torch.train import trainer as TR

import torch_ranks

ARCHS = ("whisper_large_v3", "llava_next_34b")
B_, S_PROMPT, NEW = 2, 12, 6
RTOL, ATOL, LOGIT_ATOL = 1e-5, 1e-5, 2e-5     # atol per unit of the largest magnitude
FULL_COUNTS = {"whisper_large_v3": 1_535_060_480, "llava_next_34b": 34_440_297_472}


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    """No TF32 anywhere the tests might reach a card (as run_training sets)."""
    TR.set_matmul_precision()


def _extra(cfg, rng, lead) -> dict:
    """The family's leaf beside the tokens, f32 numpy."""
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(lead + (cfg.n_patches, cfg.d_model),
                                               dtype=np.float32)}
    return {"frames": rng.standard_normal(lead + (cfg.enc_len, cfg.d_model), dtype=np.float32)}


def _batch(cfg, seed, lead, n_text) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, lead + (n_text,)).astype(np.int32)
    return {"tokens": tokens, **_extra(cfg, rng, lead)}


def _jax(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).long() if k == "tokens"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _setup(arch, seed=0):
    jcfg, cfg = j_load_arch(arch).SMOKE, load_arch(arch).SMOKE
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    flat = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
    return jcfg, cfg, jp, flat


def _leaves(cache) -> dict:
    as_np = lambda x: np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x,
                                 np.float32)
    return {k: as_np(v) for k, v in convert.flatten_tree(
        cache, is_leaf=lambda x: isinstance(x, (torch.Tensor, jax.Array)))}


def _close(ours, theirs, atol=ATOL, what=""):
    """Within RTOL relative plus ``atol`` times the largest |theirs| (at
    least 1)."""
    theirs = np.asarray(theirs, np.float32)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=atol * scale, err_msg=what)


def _assert_caches_close(ours, theirs):
    a, b = _leaves(ours), _leaves(theirs)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].shape == b[k].shape, k
        _close(a[k], b[k], what=k)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_full_attention_matches_reference(masked):
    """GQA (8 query heads on 2 kv heads), 7 queries over 11 keys, with no
    mask or a (Sq, Sk) mask that leaves every query a key: f32 within
    1e-6."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 7, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 11, 2, 16)).astype(np.float32) for _ in range(2))
    mask = None
    if masked:
        mask = rng.random((7, 11)) < 0.5
        mask[np.arange(7), np.arange(7)] = True
    theirs = JL.full_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               None if mask is None else jnp.asarray(mask))
    ours = L.full_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_states_and_loss_match_reference(arch):
    """``hidden_states`` returns the reference's (h, aux, n_prefix): h at
    every position (patches included), aux 0, n_prefix the patch count (0
    for whisper); the loss on the text positions within 1e-5 relative."""
    jcfg, cfg, jp, flat = _setup(arch, seed=2)
    batch = _batch(cfg, 5, (2,), 20)
    jh, jaux, jn = JT.hidden_states(jp, _jax(batch), jcfg, remat=False)
    params = T.layout(cfg).views(flat)
    with torch.no_grad():
        h, aux, n = T.hidden_states(params, _torch(batch), cfg)
        loss = T.loss_fn(params, _torch(batch), cfg)
    assert n == jn == (cfg.n_patches if cfg.family == "vlm" else 0)
    assert h.shape == jh.shape and aux.item() == float(jaux) == 0.0
    _close(h.numpy(), jh)
    jloss = JT.loss_fn(jp, _jax(batch), jcfg, remat=False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_dsm_outer_step_with_accumulation_matches_reference(arch):
    """One DSM outer step (W=2, tau=2, accum=2, AdamW, gamma 1e-3, eta 0.5)
    on a batch dict whose every leaf carries the accumulation axis, driven
    by the reference's loss and gradients (``test_torch_archs.py``'s
    bridge, which hands the reference each microbatch dict the port
    indexes): each worker's microbatches must take tokens and frames /
    patches alike, or the reference's loss sees other inputs than its own
    step.  The bounds of ``test_torch_archs.py::_assert_step_close``."""
    from test_torch_archs import _assert_step_close, _reference_loss

    jcfg, cfg, jp, flat = _setup(arch)
    batch = _batch(cfg, 6, (2, 2, 2, 1), 16)
    jbase = j_get_base_optimizer("adamw")
    jstep = jax.jit(j_make_dsm_step(lambda p, b: JT.loss_fn(p, b, jcfg, remat=False), jbase,
                                    JDSMConfig(tau=2, global_lr=0.5), j_constant(1e-3)))
    jstate, jm = jstep(j_dsm_init(jp, jbase, n_workers=2), _jax(batch))
    base = B.adamw()
    lay = T.layout(cfg)
    step = D.make_dsm_step(_reference_loss(jcfg, jp, lay), base,
                           D.DSMConfig(tau=2, global_lr=0.5), SC.constant(1e-3), lay)
    state, m = step(D.dsm_init(flat, base, 2), _torch(batch))
    _assert_step_close(state, m, jstate, jm, flat, lay)


def _prompt_batch(cfg, seed, n_text=S_PROMPT):
    return _batch(cfg, seed, (B_,), n_text)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """Last-position logits and every cache leaf, the cross-attention's
    ``kx`` / ``vx`` of whisper's decoder blocks included."""
    jcfg, cfg, jp, flat = _setup(arch, seed=1)
    batch = _prompt_batch(cfg, 7)
    jlogits, jcache = JT.prefill(jp, _jax(batch), jcfg, remat=False)
    with torch.no_grad():
        logits, cache = T.prefill(T.layout(cfg).views(flat), _torch(batch), cfg)
    assert logits.shape == (B_, cfg.padded_vocab)
    _close(logits.numpy(), jlogits, LOGIT_ATOL)
    _assert_caches_close(cache, jcache)
    if cfg.family == "encdec":
        assert cache["blocks"]["p0"]["kx"].shape == (cfg.n_layers, B_, cfg.enc_len,
                                                     cfg.n_kv_heads, cfg.hd)
    else:
        assert cache["blocks"]["p0"]["k"].shape[2] == cfg.n_patches + S_PROMPT


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """A prefill cache spliced into one of ``n_prefix + S + 3`` positions in
    both packages (the splice copies ``kx`` / ``vx`` through), then three
    decode steps at positions ``n_prefix + S + i`` from the same tokens:
    logits and every cache leaf."""
    jcfg, cfg, jp, flat = _setup(arch, seed=3)
    batch = _prompt_batch(cfg, 8)
    n0 = (cfg.n_patches if cfg.family == "vlm" else 0) + S_PROMPT
    max_len = n0 + 3
    _, jsmall = JT.prefill(jp, _jax(batch), jcfg, remat=False)
    jcache = JS._splice_cache(JT.init_cache(jcfg, B_, max_len, jcfg.act_dtype), jsmall, jcfg, n0)
    params = T.layout(cfg).views(flat)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (3, B_)).astype(np.int32)
    with torch.no_grad():
        _, small = T.prefill(params, _torch(batch), cfg)
        cache = S._splice_cache(T.init_cache(cfg, B_, max_len), small, cfg, n0)
        for i, tok in enumerate(toks):
            jlogits, jcache = JT.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(n0 + i),
                                             jcfg)
            logits, cache = T.decode_step(params, cache, torch.from_numpy(tok).long(), n0 + i,
                                          cfg)
            _close(logits.numpy(), jlogits, LOGIT_ATOL)
            _assert_caches_close(cache, jcache)


def _teacher_forced(params, cfg, batch, toks):
    """Each generated token's f32 logits by a full forward over the prompt
    (after the patches) and the tokens before it, at the last position."""
    out = []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            b = dict(batch, tokens=torch.cat([batch["tokens"], toks[:, :i]], dim=1))
            h = T.hidden_states(params, b, cfg)[0][:, -1:]
            out.append(T._logits(params, h, cfg)[:, 0, :cfg.vocab_size])
    return out


def _assert_follows_full_forward(params, cfg, batch, toks):
    """Every generated token is the argmax of the teacher-forced full
    forward, with a top-2 margin above ten times the logit tolerance."""
    for i, lg in enumerate(_teacher_forced(params, cfg, batch, toks)):
        assert torch.equal(lg.argmax(-1), toks[:, i]), i
        top2 = torch.topk(lg, 2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min().item() > 10 * LOGIT_ATOL * max(
            1.0, lg.abs().max().item()), i


def test_whisper_generate_matches_reference():
    """Greedy tokens equal to the reference's and to the teacher-forced full
    forward; ``extra_batch`` carries the frames."""
    jcfg, cfg, jp, flat = _setup("whisper_large_v3", seed=4)
    batch = _prompt_batch(cfg, 10)
    jtoks, jstats = JS.generate(jp, jcfg, jnp.asarray(batch["tokens"]), max_new_tokens=NEW,
                                extra_batch={"frames": jnp.asarray(batch["frames"])})
    tb = _torch(batch)
    params = T.layout(cfg).views(flat)
    toks, stats = S.generate(flat, cfg, tb["tokens"], max_new_tokens=NEW,
                             extra_batch={"frames": tb["frames"]}, device="cpu")
    assert toks.shape == (B_, NEW) and set(stats) == set(jstats)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    _assert_follows_full_forward(params, cfg, tb, toks)


def test_llava_generate_matches_reference_where_it_is_right():
    """24 new tokens after 16 patches and a 12-token prompt: the
    reference's cache (12 + 24 slots) holds the prefill's 28 positions and
    8 more, so its first 24 - 16 = 8 tokens are right, and those equal the
    port's; every one of the port's 24 follows its own teacher-forced full
    forward."""
    jcfg, cfg, jp, flat = _setup("llava_next_34b", seed=5)
    batch = _prompt_batch(cfg, 11)
    new = 24
    jtoks, _ = JS.generate(jp, jcfg, jnp.asarray(batch["tokens"]), max_new_tokens=new,
                           extra_batch={"patches": jnp.asarray(batch["patches"])})
    tb = _torch(batch)
    toks, _ = S.generate(flat, cfg, tb["tokens"], max_new_tokens=new,
                         extra_batch={"patches": tb["patches"]}, device="cpu")
    right = new - cfg.n_patches
    np.testing.assert_array_equal(toks.numpy()[:, :right], np.asarray(jtoks)[:, :right])
    _assert_follows_full_forward(T.layout(cfg).views(flat), cfg, tb, toks)


def test_llava_generate_fewer_new_tokens_than_patches():
    """``max_new_tokens`` = 6 < n_patches = 16: the reference's splice pads
    its cache by a negative amount and raises; the port's cache holds every
    position, and its tokens follow the teacher-forced full forward."""
    jcfg, cfg, jp, flat = _setup("llava_next_34b", seed=6)
    batch = _prompt_batch(cfg, 12)
    assert NEW < cfg.n_patches
    with pytest.raises(ValueError, match="negative"):
        JS.generate(jp, jcfg, jnp.asarray(batch["tokens"]), max_new_tokens=NEW,
                    extra_batch={"patches": jnp.asarray(batch["patches"])})
    tb = _torch(batch)
    toks, _ = S.generate(flat, cfg, tb["tokens"], max_new_tokens=NEW,
                         extra_batch={"patches": tb["patches"]}, device="cpu")
    assert toks.shape == (B_, NEW)
    _assert_follows_full_forward(T.layout(cfg).views(flat), cfg, tb, toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_count_matches_reference(arch):
    full = load_arch(arch).FULL
    assert specs.param_count(full) == j_specs.param_count(j_load_arch(arch).FULL) == FULL_COUNTS[
        arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_refuses_the_family(arch):
    """The reference's trainer feeds tokens only; the port's says so and
    names the way to train these families."""
    s = TR.TrainSettings(n_workers=2, tau=2, steps=1, b_micro=1, seq=16)
    with pytest.raises(ValueError, match="make_dsm_step with a batch dict"):
        TR.run_training(load_arch(arch).SMOKE, s, device="cpu")


def test_xattn_needs_the_encdec_family():
    """A decoder-only config with an xattn block has no encoder to attend to."""
    cfg = dataclasses.replace(load_arch("gpt2_small").SMOKE, name="x",
                              pattern=("attn:dense", "xattn:dense"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.layout(cfg)


def test_zero_ranks_match_the_dense_path_on_a_batch_dict(tmp_path):
    """whisper SMOKE, two DSM outer steps (W=2, tau=2) on batch dicts of
    tokens and frames, over two gloo ranks on the CPU with the ZeRO-sharded
    global step and the device-parallel local phase (each rank slices every
    leaf to its worker's rows): losses, x0 and m bit-equal to the dense
    path in one process (every process on one torch thread, so that the
    CPU's matmuls split their sums alike)."""
    cfg = load_arch("whisper_large_v3").SMOKE
    x0 = T.init_params(torch.Generator().manual_seed(0), cfg)
    batches = [_batch(cfg, 20 + t, (2, 2, 1, 1), 16) for t in range(2)]
    flags = dict(zero_sharded=True, device_parallel_local=True)
    ranks = spawn.run_ranks(torch_ranks.batch_dict_steps_rank, 2, (cfg, 2, flags, x0, batches),
                            timeout_s=120, group_timeout_s=120, work_dir=str(tmp_path))
    threads = torch.get_num_threads()
    try:
        dense = torch_ranks.batch_dict_steps_rank(0, 0, cfg, 2, {}, x0, batches)
    finally:
        torch.set_num_threads(threads)
    for res in ranks:
        assert [x.item() for x in res["losses"]] == [x.item() for x in dense["losses"]]
        for k in ("x0", "m"):
            assert torch.equal(res[k].view(torch.int32), dense[k].view(torch.int32)), k
    assert (dense["x0"] != x0).any()
