"""Activation checkpointing in the port (``remat``, ``remat_policy``,
``unroll`` of ``models.transformer``) against its own path without it and
against the JAX package's ``jax.checkpoint``, on the CPU.

One SMOKE config per family: ``attn`` dense (gpt2_medium), ``swa``
(gemma3_1b at 3 layers: one pattern repeat and one remainder layer, which
neither package checkpoints), MoE (granite_moe_3b_a800m), ``ssm``
(mamba2_780m), ``rglru`` (recurrentgemma_2b at 3 layers), ``encdec``
(whisper_large_v3: the encoder is checkpointed too) and ``vlm``
(llava_next_34b); all f32, params from the reference's ``init_params``
through ``convert.from_jax_numpy``, batches drawn with numpy.

  * With ``remat=True`` under ``"full"`` and ``"dots"`` the port's loss and
    every gradient are bit for bit those of ``remat=False``: the recompute
    runs the same operations on the same inputs.
  * Each is held against the reference's ``jax.value_and_grad(loss_fn)``
    with the same ``remat`` / ``remat_policy``, at ``test_torch_archs.py``'s
    tolerances (loss rtol 1e-6, every gradient leaf within 3e-5 of its
    largest magnitude).
  * ``prefill(remat=True)``, ``unroll=True`` and the reference's call forms
    (``loss_fn(p, b, cfg, remat=False)``, ``decode_step(..., unroll=False)``)
    give bit for bit what the defaults give.
  * ``"dots"`` saves, for each block kind, as many products as
    ``jax.make_jaxpr`` of the reference block has ``dot_general``
    equations without batch dims (what ``dots_with_no_batch_dims_saveable``
    saves); a MoE block saves none of its per-expert products, which stand
    for the reference's ``ragged_dot``.
"""

import dataclasses

import jax
import jax.numpy as jnp
from jax.extend import core as jex_core
import numpy as np
import pytest
import torch

from repro.configs import load_arch as j_load_arch
from repro.models import transformer as JT
from repro_torch.configs import load_arch
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import serve as S
from repro_torch.train import trainer as TR

# arch -> layers (None: the SMOKE's own)
FAMILIES = {"gpt2_medium": None, "gemma3_1b": 3, "granite_moe_3b_a800m": None,
            "mamba2_780m": None, "recurrentgemma_2b": 3, "whisper_large_v3": None,
            "llava_next_34b": None}
MODES = [(False, "full"), (True, "full"), (True, "dots")]
SEQ, BATCH = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _full_f32_matmuls():
    TR.set_matmul_precision()


def _configs(arch):
    jcfg, cfg = j_load_arch(arch).SMOKE, load_arch(arch).SMOKE
    if FAMILIES[arch]:
        jcfg = dataclasses.replace(jcfg, n_layers=FAMILIES[arch])
        cfg = dataclasses.replace(cfg, n_layers=FAMILIES[arch])
    return jcfg, cfg


def _batch(cfg, seed, S_text=SEQ) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, S_text)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((BATCH, cfg.n_patches, cfg.d_model),
                                               dtype=np.float32)
    elif cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((BATCH, cfg.enc_len, cfg.d_model),
                                              dtype=np.float32)
    return batch


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


_SETUP: dict = {}


def _setup(arch):
    """(jcfg, cfg, reference params, flat port params, batch), once per arch."""
    if arch not in _SETUP:
        jcfg, cfg = _configs(arch)
        jp = JT.init_params(jax.random.PRNGKey(5), jcfg)
        flat = convert.from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, n_workers=1)[0]
        _SETUP[arch] = (jcfg, cfg, jp, flat, _batch(cfg, 7))
    return _SETUP[arch]


def _port_loss_and_grad(cfg, flat, batch, **kw):
    grad = torch.zeros_like(flat)
    loss = T.loss_fn(T.layout(cfg).autograd_leaves(flat, grad), _torch(batch), cfg, **kw)
    loss.backward()
    return loss.detach(), grad


@pytest.mark.parametrize("remat,policy", MODES, ids=["no_remat", "full", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_is_bit_equal_and_matches_reference(arch, remat, policy):
    jcfg, cfg, jp, flat, batch = _setup(arch)
    loss0, grad0 = _port_loss_and_grad(cfg, flat, batch, remat=False)
    loss, grad = _port_loss_and_grad(cfg, flat, batch, remat=remat, remat_policy=policy)
    assert torch.equal(loss, loss0)
    assert torch.equal(grad, grad0)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg, remat=remat, remat_policy=policy)))(jp)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    ours = convert.to_numpy(grad, cfg)
    theirs = dict(convert.flatten_tree(jax.tree.map(np.asarray, jgrads),
                                       is_leaf=lambda x: isinstance(x, np.ndarray)))
    assert sorted(ours) == sorted(theirs)
    for name, g in theirs.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(ours[name], g, rtol=0, atol=3e-5 * scale, err_msg=name)


def _leaves(tree) -> list:
    return [v for _, v in convert.flatten_tree(tree, is_leaf=torch.is_tensor)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_remat_and_unroll_equal_the_defaults(arch):
    _, cfg, _, flat, batch = _setup(arch)
    params = T.layout(cfg).views(flat)
    tb = _torch(batch)
    with torch.no_grad():
        base_logits, base_cache = T.prefill(params, tb, cfg)
        h0 = T.hidden_states(params, tb, cfg)[0]
        for kw in (dict(remat=False), dict(remat=True, unroll=True), dict(unroll=False)):
            logits, cache = T.prefill(params, tb, cfg, **kw)
            assert torch.equal(logits, base_logits), kw
            assert all(torch.equal(a, b) for a, b in zip(_leaves(cache), _leaves(base_cache),
                                                         strict=True))
        for kw in (dict(remat=False), dict(remat=True, unroll=True, remat_policy="dots")):
            assert torch.equal(T.hidden_states(params, tb, cfg, **kw)[0], h0), kw
    # with grad on, prefill's checkpoint still returns the same values
    logits, _ = T.prefill(params, tb, cfg, remat=True)
    assert torch.equal(logits.detach(), base_logits)


@pytest.mark.parametrize("arch", FAMILIES)
def test_reference_call_forms_run(arch):
    """``loss_fn(p, b, cfg, remat=False)`` (the reference trainer's) and
    ``decode_step(..., unroll=False)`` / ``unroll=True`` (the reference's
    scan and loop) run and agree with the defaults bit for bit."""
    _, cfg, _, flat, batch = _setup(arch)
    params = T.layout(cfg).views(flat)
    tb = _torch(batch)
    with torch.no_grad():
        assert torch.equal(T.loss_fn(params, tb, cfg, remat=False), T.loss_fn(params, tb, cfg))
        n = tb["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
        outs = []
        for unroll in (False, True, None):
            _, small = T.prefill(params, tb, cfg)     # decode writes into its states
            cache = S._splice_cache(T.init_cache(cfg, BATCH, n + 2), small, cfg, n)
            kw = {} if unroll is None else dict(unroll=unroll)
            logits, _ = T.decode_step(params, cache, tb["tokens"][:, -1], n, cfg, **kw)
            outs.append(logits)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# What "dots" saves, block kind by block kind
# ---------------------------------------------------------------------------

BLOCKS = [("gpt2_medium", "attn:dense"), ("gemma3_1b", "swa:dense"),
          ("granite_moe_3b_a800m", "attn:moe"), ("mamba2_780m", "ssm:none"),
          ("recurrentgemma_2b", "rglru:dense"), ("whisper_large_v3", "xattn:dense"),
          ("whisper_large_v3", "encattn:dense"), ("llava_next_34b", "attn:dense")]


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for item in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(item, jex_core.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jex_core.Jaxpr):
                yield item


def _count_prims(jaxpr) -> dict:
    """{"dots": dot_general equations with no batch dims, "ragged": ragged
    dots}, through every sub-jaxpr."""
    out = {"dots": 0, "ragged": 0}
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (_, _), (lhs_batch, _) = eqn.params["dimension_numbers"]
            out["dots"] += not lhs_batch
        elif name.startswith("ragged_dot"):
            out["ragged"] += 1
        for sub in _sub_jaxprs(eqn):
            for k, n in _count_prims(sub).items():
                out[k] += n
    return out


def _first_layer(params, cfg, kind):
    stack = "encoder" if kind.startswith("encattn") else "decoder"
    return next(p for _, k, p in T._layers(params, cfg, stack) if k == kind)


@pytest.mark.parametrize("arch,kind", BLOCKS, ids=[f"{a}-{k}" for a, k in BLOCKS])
def test_dots_saves_the_reference_policys_products(arch, kind, monkeypatch):
    jcfg, cfg, jp, flat, batch = _setup(arch)
    rng = np.random.default_rng(11)
    S_len = cfg.enc_len if kind.startswith("encattn") else SEQ
    x = rng.standard_normal((BATCH, S_len, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((BATCH, cfg.enc_len, cfg.d_model), dtype=np.float32) \
        if kind.startswith("xattn") else None

    stack = "encoder" if kind.startswith("encattn") else "decoder"
    jblock = (jp[stack]["blocks"]["p0"] if jp[stack]["blocks"] else jp[stack]["rem"][0])
    jblock = jax.tree.map(lambda a: a[0], jblock) if jp[stack]["blocks"] else jblock
    jaxpr = jax.make_jaxpr(lambda p, x, e: JT._apply_block(
        p, kind, x, jnp.arange(S_len), jcfg, e))(jblock, jnp.asarray(x),
                                                  None if enc is None else jnp.asarray(enc))
    want = _count_prims(jaxpr.jaxpr)

    saved = {"dots": 0, "ragged": 0}
    policy = T._save_dots

    def counting(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
                saved["dots"] += 1
            elif op in T._DOT_OPS and L.in_ragged_dot():
                saved["ragged"] += 1
        return decision

    monkeypatch.setattr(T, "_save_dots", counting)
    leaves = T.layout(cfg).autograd_leaves(flat, torch.zeros_like(flat))
    p = _first_layer(leaves, cfg, kind)
    xt = torch.from_numpy(x).requires_grad_(True)
    et = None if enc is None else torch.from_numpy(enc)
    out, _ = T._checkpointed(lambda x: T._apply_block(p, kind, x, torch.arange(S_len), cfg, et),
                             "dots", xt)
    out.sum().backward()
    assert saved["dots"] == want["dots"] > 0
    # the per-expert products run (as the reference's ragged dots) and are
    # left to the recompute
    assert (saved["ragged"] > 0) == (want["ragged"] > 0) == (kind.endswith("moe"))


def test_unknown_policy_is_full():
    """Any policy string but "dots" recomputes the whole repeat, as the
    reference's ``_run_stack`` reads it."""
    _, cfg, _, flat, batch = _setup("gpt2_medium")
    loss0, grad0 = _port_loss_and_grad(cfg, flat, batch, remat=True, remat_policy="full")
    loss, grad = _port_loss_and_grad(cfg, flat, batch, remat=True, remat_policy="anything")
    assert torch.equal(loss, loss0) and torch.equal(grad, grad0)
