"""The port's tri-modal pretrain step held against the JAX package on the CPU.

The pretrain path adds the fusion tower (``CrossModalTransformer``), the
reconstruction and MLM heads, the Swin mask token with the embed / encode
split and the device space-to-depth embeds, the pretrain losses,
``CloverPretrain`` and ``make_pretrain_train_step``; its FFN halves can take
the masked post-LN MLP (K3M, the JAX ``_forward_postln_mask``) on training
passes (``BertConfig.fused_mlp_train``). On the CPU every wrapper runs its
plain version; these tests feed the same seeded numpy inputs to it and to
the JAX function, in fp32, with the tolerance each states:

- the masked post-LN MLP: plain forward against ``_xla_reference_postln_mask``
  and the interpret-mode Pallas kernel, its backward against
  ``_xla_backward_postln_mask`` and autograd, and the BertLayer routing;
- the fusion tower, the heads, the losses, the Swin mask token and embeds;
- a tiny pretrain configuration (Swin embed 32 with 2 heads, one stage of
  a plain and a shifted block on clips of 4 x 56^2; BERT 2 layers of width
  48; a 1-layer fusion tower with ``fc_in`` over 2 x 196 visual tokens;
  vocab 100; ``fused_mlp_train='auto'`` on both sides, so the batched
  fusion pass's 2400 rows take the fused FFN route): ``forward_train`` in
  each ``batch_passes`` / ``share_embed`` combination, ``forward_test``,
  one step's gradients and 2 AdamW steps against the JAX
  ``make_pretrain_train_step`` with every dropout and DropPath at 0
  (``attention_impl='pallas_flat'``), the bridge of the pretrain tree and
  its AdamW moments.

The ``gpu`` tests launch K3M and skip without a card:
``python -m pytest tests/test_torch_pretrain.py -m gpu --noconftest`` (JAX
is imported inside the tests that compare with it).
"""

import dataclasses
import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from clover_tpu_torch import ops
from clover_tpu_torch.losses import (exclusive_nce_with_ranking, masked_lm_cross_entropy,
                                     masked_lm_focal_loss, pretrain_losses, total_loss)
from clover_tpu_torch.models import bert as pbert
from clover_tpu_torch.models import (BertConfig, CloverPretrain, CrossModalTransformer,
                                     FusionConfig, MLMHead, NCEHeadForText, NCEHeadForVision,
                                     PretrainConfig, SwinConfig, load_jax_params, state_from_jax)
from clover_tpu_torch.models.swin3d import SwinTransformer3D

SWIN = dict(embed_dim=32, depths=(2,), num_heads=(2,), drop_path_rate=0.0)
BERT = dict(vocab_size=100, hidden_size=48, num_attention_heads=2, intermediate_size=96,
            hidden_dropout=0.0, attention_dropout=0.0)
FUSION = dict(img_in_size=32, hidden_size=48, num_frames=2, spatial_tokens=196)
B, T, S, L = 3, 4, 56, 8
LR, TOTAL, WARMUP, CLIP = 1e-3, 20, 2, 1.0


@pytest.fixture
def jx():
    """The JAX package's modules under test."""
    jnp = pytest.importorskip("jax.numpy")
    import jax

    import clover_tpu.losses as losses
    import clover_tpu.losses.objectives  # noqa: F401  (losses.objectives)
    import clover_tpu.models as models
    import clover_tpu.models.bert as bert
    import clover_tpu.ops.mlp_block as mlp

    return types.SimpleNamespace(jax=jax, jnp=jnp, losses=losses, models=models, bert=bert,
                                 mlp=mlp)


def _np(t):
    return np.asarray(t, np.float32)


def _fill(rng):
    """Seeded values for a JAX parameter tree (test_torch_bridge's rules):
    every leaf non-trivial, so the bridge's mapping shows in the outputs."""
    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.normal(size=shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name == "kernel":
            z = z / np.sqrt(shape[0])
        else:
            z = (0.5 if name in ("embedding", "relative_position_bias_table") else 0.1) * z
        return z.astype(np.float32)
    return fill


def _init(jx, module, *args, seed=0, **kw):
    """Seeded random parameters of a JAX module (from jax.eval_shape, no init
    compile)."""
    shapes = jx.jax.eval_shape(lambda: module.init(jx.jax.random.PRNGKey(0), *args, **kw))
    return jx.jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(seed)), shapes)


# ------------------------------------------------ the masked post-LN MLP (K3M)

def _mlp_inputs(seed, rows=40, C=64, H=256, keep=0.9):
    """x, JAX-layout params (LN scale / bias, (C, H) / (H, C) kernels), a
    {0, 1/keep} mask, a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, C)).astype(np.float32)
    params = [rng.normal(size=s).astype(np.float32) * f for s, f in
              [(C, 1.0), (C, 0.1), ((C, H), C ** -0.5), (H, 0.1), ((H, C), H ** -0.5), (C, 0.1)]]
    m = ((rng.random((rows, C)) < keep) / keep).astype(np.float32)
    g = rng.normal(size=(rows, C)).astype(np.float32)
    return x, params, m, g


def _torch_params(params):
    s, b, k1, b1, k2, b2 = (torch.from_numpy(v) for v in params)
    return s, b, k1.T.contiguous(), b1, k2.T.contiguous(), b2


@pytest.mark.parametrize("mask", ["dropout", "none"])
def test_mlp_postln_mask_plain_matches_xla_reference(mask, jx):
    """mlp_postln_mask_plain against _xla_reference_postln_mask (no mask:
    a mask of ones). Tolerance 5e-5 (observed ~1e-6)."""
    x, params, m, _ = _mlp_inputs(80)
    if mask == "none":
        m = np.ones_like(m)
    want = jx.mlp._xla_reference_postln_mask(*map(jx.jnp.asarray, (x, *params, m)), 1e-12)
    got = ops.mlp_postln_mask_plain(torch.from_numpy(x), *_torch_params(params),
                                    None if mask == "none" else torch.from_numpy(m), 1e-12)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("mask", ["dropout", "none"])
def test_fused_mlp_postln_dropout_matches_pallas(mask, jx, monkeypatch):
    """The wrapper on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode: _forward_postln_mask with the mask, K3's
    _forward_postln (fused_mlp_postln) without. Tolerance 5e-5: the JAX
    kernel's GELU takes a rational erf (|err| <= 1.5e-7)."""
    monkeypatch.setattr(jx.mlp, "_FORCE_PALLAS", True)
    x, params, m, _ = _mlp_inputs(81, rows=48)
    jargs = list(map(jx.jnp.asarray, (x, *params)))
    if mask == "none":
        want = jx.mlp.fused_mlp_postln(*jargs, 1e-12)
    else:
        want = jx.mlp.fused_mlp_postln_dropout(*jargs, jx.jnp.asarray(m), 1e-12)
    ops.reset_launch_counts()
    got = ops.fused_mlp_postln_dropout(torch.from_numpy(x), *_torch_params(params),
                                       None if mask == "none" else torch.from_numpy(m), 1e-12)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=5e-5, rtol=5e-5)
    assert ops.fused_mlp_postln_dropout.launches == 0


@pytest.mark.parametrize("mask", ["dropout", "none"])
def test_mlp_postln_mask_bwd_matches_xla_backward(mask, jx):
    """mlp_postln_mask_bwd against _xla_backward_postln_mask (its default
    bf16 crossings, identities in fp32), each gradient within 5e-5 of its
    max (observed ~1e-6)."""
    x, params, m, g = _mlp_inputs(82)
    if mask == "none":
        m = np.ones_like(m)
    want = jx.mlp._xla_backward_postln_mask(*map(jx.jnp.asarray, (x, *params, m)), 1e-12,
                                            jx.jnp.asarray(g))
    got = ops.mlp_postln_mask_bwd(torch.from_numpy(x), *_torch_params(params),
                                  None if mask == "none" else torch.from_numpy(m), 1e-12,
                                  torch.from_numpy(g))
    names = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")
    for name, a, w in zip(names, got, want[:7]):
        w = _np(w)
        if name in ("dw1", "dw2"):   # JAX (in, out) kernels, torch (out, in) weights
            w = w.T
        np.testing.assert_allclose(a.numpy(), w, atol=5e-5 * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_fused_fn_backward_is_autograd_of_the_plain_forward():
    """FusedMlpPostlnDropoutFn (plain, CPU) against autograd of
    mlp_postln_mask_plain, fp32: the output bitwise, every gradient within
    1e-5 of its max (summation order; observed ~1e-7); the mask gets no
    gradient."""
    x, params, m, g = _mlp_inputs(83)
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        p.requires_grad_() for p in _torch_params(params)]
    mask = torch.from_numpy(m).requires_grad_()
    g = torch.from_numpy(g)
    out = ops.FusedMlpPostlnDropoutFn.apply(*leaves, mask, 1e-12, True)
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    ref = ops.mlp_postln_mask_plain(*ref_leaves, mask.detach(), 1e-12)
    want = torch.autograd.grad(ref, ref_leaves, g)
    assert torch.equal(out, ref)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5 * w.abs().max().item(), rtol=0)
    out2 = ops.FusedMlpPostlnDropoutFn.apply(*leaves, mask, 1e-12, True)
    assert torch.autograd.grad(out2.sum(), mask, allow_unused=True)[0] is None


# ------------------------------------------------------- the BertLayer route

def _layer(fused, drop=0.0, C=32, seed=3):
    cfg = BertConfig(hidden_size=C, num_attention_heads=2, intermediate_size=64,
                     hidden_dropout=drop, attention_dropout=0.0, fused_mlp_train=fused)
    layer = pbert.BertLayer(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + (1.0 if p.ndim == 1 else 0.0))
    return layer.train()


def _counting_fn(monkeypatch, seen):
    real = pbert.FusedMlpPostlnDropoutFn.apply

    class Counting(pbert.FusedMlpPostlnDropoutFn):
        apply = staticmethod(lambda *a: seen.append(a) or real(*a))

    monkeypatch.setattr(pbert, "FusedMlpPostlnDropoutFn", Counting)


@pytest.mark.parametrize("rows,fused", [(2048, True), (2047, False)])
def test_auto_takes_the_fused_route_from_2048_rows(rows, fused, monkeypatch):
    """fused_mlp_train='auto': a training layer of >= 2048 tokens takes
    FusedMlpPostlnDropoutFn, a smaller one the unfused FFN
    (test_mlp_block_kernel.py's row gate); '0' never, '1' always; eval
    never."""
    seen = []
    _counting_fn(monkeypatch, seen)
    shape = (4, 512) if rows == 2048 else (23, 89)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=shape + (32,)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    _layer("auto", 0.1)(x, None, gen)
    assert len(seen) == int(fused)
    _layer("0", 0.1)(x, None, gen)
    assert len(seen) == int(fused)
    _layer("1", 0.1)(x, None, gen)
    assert len(seen) == int(fused) + 1
    with torch.no_grad():
        _layer("1", 0.1).eval()(x, None)
    assert len(seen) == int(fused) + 1
    assert seen[-1][0].shape == (rows, 32) and seen[-1][7].shape == (rows, 32)


def test_fused_and_unfused_layers_agree_at_dropout_0(jx, monkeypatch):
    """At dropout 0 a training layer on the fused route ('1', no mask) and
    on the unfused one ('0') give the same output and gradients within
    1e-5, and both match the JAX BertLayer on its fused train route
    (_BERT_FUSED_MLP_TRAIN '1') with the same weights."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 10, 32)).astype(np.float32)
    outs, grads = [], []
    for fused in ("1", "0"):
        layer = _layer(fused)
        xt = torch.from_numpy(x).requires_grad_()
        out = layer(xt, None, torch.Generator())
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([xt.grad] + [p.grad for p in layer.parameters()])
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    jcfg = jx.bert.BertConfig(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                              hidden_dropout=0.0, attention_dropout=0.0)
    jlayer = jx.bert.BertLayer(jcfg)
    params = _init(jx, jlayer, jx.jnp.asarray(x), None, seed=7)
    monkeypatch.setattr(jx.bert, "_BERT_FUSED_MLP_TRAIN", "1")
    want = jlayer.apply(params, jx.jnp.asarray(x), None, deterministic=False,
                        rngs={"dropout": jx.jax.random.PRNGKey(0)})
    layer = _layer("1")
    load_jax_params(layer, params)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), None, torch.Generator())
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=2e-5)


def test_fused_route_draws_a_dropout_mask_of_rate_p(monkeypatch):
    """The fused route's mask: fp32 (rows, C), every value 0 or 1/keep, a
    share of zeros within 0.02 of the rate (8192 draws: 4 standard
    deviations); the same generator seed gives the same mask whatever
    ``kernels`` says (the route depends on the config and the rows only);
    no generator, no run."""
    seen = []
    _counting_fn(monkeypatch, seen)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(4, 64, 32)).astype(np.float32))
    for kernels in (True, False):
        layer = _layer("1", 0.25)
        layer.kernels = kernels
        layer(x, None, torch.Generator().manual_seed(11))
    (m, m2) = (a[7] for a in seen)
    assert m.dtype == torch.float32 and m.shape == (256, 32)
    assert set(torch.unique(m).tolist()) == {0.0, np.float32(1 / 0.75)}
    assert abs((m == 0).float().mean().item() - 0.25) < 0.02
    assert torch.equal(m, m2)
    with pytest.raises(ValueError):
        _layer("1", 0.25)(x, None, None)
    with pytest.raises(ValueError):
        BertConfig(fused_mlp_train="yes")


# ----------------------------------------------- fusion tower, heads, embeds

def _fusion_cfgs(jx, **kw):
    jb = jx.bert.BertConfig(num_hidden_layers=1, **BERT)
    return (jx.models.FusionConfig(bert=jb, **FUSION, **kw),
            FusionConfig(bert=BertConfig(num_hidden_layers=1, **BERT), **FUSION, **kw))


@pytest.mark.parametrize("variant", ["ids", "candidates", "cls_prompt_word_pos"])
def test_cross_modal_transformer_matches_jax(variant, jx):
    """CrossModalTransformer (eval) against the JAX tower on the same tree:
    text as ids; candidate-expanded text (B*2 rows regrouped to (B, 2L));
    use_text_cls=False with prompt tokens and word_pos_start. Every output
    within 1e-4 abs + rel (observed ~1e-6)."""
    kw = {"cls_prompt_word_pos": dict(use_text_cls=False, use_prompt=True, word_pos_start=True)}
    jcfg, pcfg = _fusion_cfgs(jx, **kw.get(variant, {}))
    rng = np.random.default_rng(20)
    n = 2 if variant == "candidates" else 1
    vis = rng.normal(size=(B, 2, 196, 32)).astype(np.float32)
    ids = rng.integers(5, 100, size=(B * n, L)).astype(np.int32)
    mask = np.ones((B * n, L), np.int32)
    mask[0, 5:] = 0
    jm = jx.models.CrossModalTransformer(jcfg)
    args = tuple(map(jx.jnp.asarray, (vis, mask, ids)))
    params = _init(jx, jm, *args)
    want = jx.jax.jit(lambda p, *a: jm.apply(p, *a))(params, *args)
    pm = CrossModalTransformer(pcfg).eval()
    load_jax_params(pm, params)
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a) for a in (vis, mask, ids)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def test_fusion_forward_text_matches_jax(jx):
    """CrossModalTransformer.forward_text (with word_pos_start, positions
    from T*S + 1) against the JAX method; a tower without text embeddings
    refuses ids. Tolerance 1e-4."""
    jcfg, pcfg = _fusion_cfgs(jx, word_pos_start=True)
    rng = np.random.default_rng(21)
    vis = rng.normal(size=(B, 2, 196, 32)).astype(np.float32)
    ids = rng.integers(5, 100, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 6:] = 0
    jm = jx.models.CrossModalTransformer(jcfg)
    params = _init(jx, jm, *map(jx.jnp.asarray, (vis, mask, ids)))
    want = jm.apply(params, jx.jnp.asarray(ids), jx.jnp.asarray(mask), method="forward_text")
    pm = CrossModalTransformer(pcfg).eval()
    load_jax_params(pm, params)
    with torch.no_grad():
        got = pm.forward_text(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-4)
    bare = CrossModalTransformer(pcfg, text_embeddings=False)
    assert not any(n.startswith("embeddings.") for n, _ in bare.named_parameters())
    with pytest.raises(ValueError, match="text_input_embeds"):
        bare.forward_text(torch.from_numpy(ids), torch.from_numpy(mask))


@pytest.mark.parametrize("head", ["vision_2d", "vision_3d", "text", "mlm"])
def test_heads_match_jax(head, jx):
    """NCEHeadForVision (a 2-D CLS feature passes as it is, a 3-D one is
    token-averaged: the documented fix), NCEHeadForText and MLMHead in eval
    against the JAX heads. Tolerance 1e-5 (observed ~1e-7)."""
    rng = np.random.default_rng(22)
    jh = jx.models
    if head.startswith("vision"):
        feat = rng.normal(size=(B, 48) if head == "vision_2d" else (B, 5, 48))
        jm, pm = jh.NCEHeadForVision(hidden_dim=48, vts_embed_dim=32), NCEHeadForVision(48, 48, 32)
    elif head == "text":
        feat = rng.normal(size=(B, 48))
        jm, pm = jh.NCEHeadForText(cross_in_channels=48, vts_embed_dim=32), NCEHeadForText(48, 32)
    else:
        feat = rng.normal(size=(B, L, 48))
        jm = jh.MLMHead(jx.bert.BertConfig(**BERT))
        pm = MLMHead(BertConfig(**BERT))
    feat = feat.astype(np.float32)
    params = _init(jx, jm, jx.jnp.asarray(feat))
    want = jm.apply(params, jx.jnp.asarray(feat))
    load_jax_params(pm, params)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(feat))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_bert_embeddings_token_types_and_offset_match_jax(jx):
    """BertEmbeddings with token_type_ids and a position offset against the
    JAX embeddings (eval). Tolerance 1e-5."""
    rng = np.random.default_rng(23)
    ids = rng.integers(5, 100, size=(B, L)).astype(np.int32)
    types_ = rng.integers(0, 2, size=(B, L)).astype(np.int32)
    jm = jx.bert.BertEmbeddings(jx.bert.BertConfig(**BERT))
    params = _init(jx, jm, jx.jnp.asarray(ids))
    want = jm.apply(params, jx.jnp.asarray(ids), jx.jnp.asarray(types_), 17)
    pm = pbert.BertEmbeddings(BertConfig(**BERT)).eval()
    load_jax_params(pm, params)
    with torch.no_grad():
        got = pm(torch.from_numpy(ids).long(), torch.float32, None,
                 torch.from_numpy(types_).long(), 17)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def _swin_pair(jx, impl="conv", **kw):
    jcfg = jx.models.SwinConfig(embed_impl=impl, mask_token=True, **SWIN, **kw)
    return (jx.models.SwinTransformer3D(jcfg),
            SwinTransformer3D(SwinConfig(embed_impl=impl, mask_token=True, **SWIN, **kw)))


def test_swin_mask_token_mixing_and_the_embed_encode_split(jx):
    """The Swin with a (B, 7, 7) token mask against the JAX backbone (eval):
    features and the broadcast mask weights within 1e-4; the port's 'embed'
    then 'encode' gives its 'full' output bitwise; a token mask needs
    mask_token."""
    rng = np.random.default_rng(24)
    imgs = (rng.normal(size=(B, T, S, S, 3)) * 0.5).astype(np.float32)
    tmask = rng.integers(0, 2, size=(B, 7, 7)).astype(np.int32)
    jm, pm = _swin_pair(jx)
    params = _init(jx, jm, jx.jnp.asarray(imgs), jx.jnp.asarray(tmask))
    want, want_w = jx.jax.jit(jm.apply)(params, jx.jnp.asarray(imgs), jx.jnp.asarray(tmask))
    load_jax_params(pm, params)
    pm.eval()
    ti, tm = torch.from_numpy(imgs), torch.from_numpy(tmask)
    with torch.no_grad():
        got, w = pm(ti, token_mask=tm)
        split, _ = pm(pm(ti, mode="embed"), token_mask=tm, mode="encode")
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(w.numpy(), _np(want_w))
    assert torch.equal(split, got)
    plain = SwinTransformer3D(SwinConfig(**SWIN))
    with pytest.raises(ValueError, match="mask_token"):
        plain(torch.zeros(1, 2, 14, 14, 96), token_mask=tm[:1])


@pytest.mark.parametrize("impl", ["s2d", "conv"])
def test_device_s2d_embeds_match_jax(impl, jx):
    """The raw-clip embeds ('s2d', 'conv': space-to-depth on the device, one
    GEMM) against the JAX patch embed of the same impl (a conv for 'conv'),
    with fold_normalize on pixel-scale input and T=5 (the time axis padded
    to whole patches): within 1e-3 on values up to ~40 (observed ~1e-5);
    the same GEMM on the host s2d clip ('host_s2d') gives the same tokens."""
    rng = np.random.default_rng(25)
    frames = rng.integers(0, 256, size=(2, 5, S, S, 3), dtype=np.uint8)
    imgs = frames.astype(np.float32)
    jm, pm = _swin_pair(jx, impl, fold_normalize=True)
    params = _init(jx, jm, jx.jnp.asarray(imgs))
    want = jm.apply(params, jx.jnp.asarray(imgs), mode="embed")
    load_jax_params(pm, params)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(imgs), mode="embed")
    assert got.shape == (2, 3, 14, 14, 32)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-3, rtol=1e-5)
    from clover_tpu_torch.ops.preprocess import space_to_depth_host
    host = SwinTransformer3D(SwinConfig(mask_token=True, fold_normalize=True, **SWIN)).eval()
    host.load_state_dict(pm.state_dict())
    padded = np.concatenate([frames, np.zeros_like(frames[:, :1])], axis=1)
    with torch.no_grad():
        via_host = host(torch.from_numpy(space_to_depth_host(padded)).float(), mode="embed")
    torch.testing.assert_close(via_host, got, atol=1e-3, rtol=1e-5)


# -------------------------------------------------------------------- losses

def _embs(seed, n=4, d=16, k=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, d)).astype(np.float32) for _ in range(k)]


def test_exclusive_nce_with_ranking_matches_jax(jx):
    """Values and the gradient of their sum w.r.t. all four embeddings
    against the JAX loss (use_rank and use_rank_ttm on, as the port has
    them). Tolerance 1e-5 relative, 1e-6 absolute on gradients (observed
    ~1e-7)."""
    e = _embs(30)
    fn = functools.partial(jx.losses.exclusive_nce_with_ranking, temperature=0.05,
                           margin_ttm=5.0)
    want = fn(*map(jx.jnp.asarray, e))
    jg = jx.jax.grad(lambda *a: sum(fn(*a).values()), argnums=(0, 1, 2, 3))(
        *map(jx.jnp.asarray, e))
    te = [torch.from_numpy(a).requires_grad_() for a in e]
    got = exclusive_nce_with_ranking(*te, temperature=0.05, margin_ttm=5.0)
    assert set(got) == set(want) == {"nce_loss", "rank_t_tm_loss"}
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=1e-5)
    sum(got.values()).backward()
    for t, w in zip(te, jg):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gamma", [2.0, 0.0])
def test_masked_lm_focal_loss_matches_jax(gamma, jx):
    """The focal MLM loss (gamma 2) and its CE form (gamma 0,
    masked_lm_cross_entropy) over the masked positions only: value and
    gradient against JAX within 1e-5 relative."""
    rng = np.random.default_rng(31)
    logits = rng.normal(size=(2, 6, 11)).astype(np.float32) * 2
    labels = np.full((2, 6), -100, np.int32)
    labels[0, 1], labels[0, 4], labels[1, 2] = 3, 10, 0
    jfn = (functools.partial(jx.losses.classification.masked_lm_focal_loss, gamma=gamma)
           if gamma else jx.losses.classification.masked_lm_cross_entropy)
    want, jg = jx.jax.value_and_grad(jfn)(jx.jnp.asarray(logits), jx.jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_()
    lab = torch.from_numpy(labels).long()
    got = masked_lm_focal_loss(t, lab, gamma) if gamma else masked_lm_cross_entropy(t, lab)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), _np(jg), rtol=1e-5, atol=1e-7)


def test_pretrain_losses_match_jax(jx):
    """pretrain_losses on the same model outputs against the JAX losses at
    their default config: the same keys in the same order, each value within
    1e-5 relative, the gradient of the total w.r.t. every output within 1e-5
    relative, 1e-6 absolute."""
    names = ("visual_emb", "text_emb", "mask_word_emb", "mask_visual_recon_emb",
             "mask_visual_emb", "mask_word_recon_emb")
    outs = dict(zip(names, _embs(32, k=6)))
    rng = np.random.default_rng(33)
    outs["mlm_logits"] = rng.normal(size=(4, 6, 11)).astype(np.float32)
    labels = np.full((4, 6), -100, np.int32)
    labels[:, 2] = rng.integers(0, 11, size=4)
    jobj = jx.losses.objectives

    def jtotal(o):
        return jobj.total_loss(jobj.pretrain_losses(o, jx.jnp.asarray(labels)))

    jo = {k: jx.jnp.asarray(v) for k, v in outs.items()}
    want = jobj.pretrain_losses(jo, jx.jnp.asarray(labels))
    jg = jx.jax.grad(jtotal)(jo)
    to = {k: torch.from_numpy(v).requires_grad_() for k, v in outs.items()}
    got = pretrain_losses(to, torch.from_numpy(labels).long())
    assert list(got) == list(want)
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=1e-5), k
    total_loss(got).backward()
    for k, t in to.items():
        np.testing.assert_allclose(t.grad.numpy(), _np(jg[k]), rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------ the tiny pretrain model

def _configs(jx, **kw):
    """(JAX, port) pretrain configs; the port's towers at fused_mlp_train
    'auto' (the JAX side's is the module knob, set by the fixture)."""
    jb = jx.bert.BertConfig
    jcfg = jx.models.PretrainConfig(
        swin=jx.models.SwinConfig(embed_impl="conv", mask_token=True, attention_impl="pallas_flat",
                                  **SWIN),
        text_bert=jb(num_hidden_layers=2, **BERT),
        fusion=jx.models.FusionConfig(bert=jb(num_hidden_layers=1, **BERT), **FUSION),
        vts_embed_dim=32, **kw)
    pb = functools.partial(BertConfig, fused_mlp_train="auto", **BERT)
    pcfg = PretrainConfig(swin=SwinConfig(embed_impl="conv", mask_token=True, **SWIN),
                          text_bert=pb(num_hidden_layers=2),
                          fusion=FusionConfig(bert=pb(num_hidden_layers=1), **FUSION),
                          vts_embed_dim=32, **kw)
    return jcfg, pcfg


def _pretrain_batch(seed):
    """bench_train-shaped: clips normal * 0.5, ids in [5, 100) with position
    3 masked (id 3) and labelled, all-ones attention mask, a random 0/1
    (B, 7, 7) video mask."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(5, 100, size=(B, L)).astype(np.int32)
    label = np.full((B, L), -100, np.int32)
    label[:, 3] = tok[:, 3]
    tok[:, 3] = 3
    return {"imgs": (rng.normal(size=(B, T, S, S, 3)) * 0.5).astype(np.float32),
            "token_ids": tok, "input_mask": np.ones((B, L), np.int32), "mlm_label": label,
            "v_token_mask": rng.integers(0, 2, size=(B, 7, 7)).astype(np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _jax_knobs(jx):
    """A MonkeyPatch of the JAX package for the reference runs: the pretrain
    model builds NCEHeadForText with its fixed dropout of 0.1 (no config
    field), here at 0, so the JAX step is deterministic (the port's head gets
    rate 0 in ``_port_model``); CLOVER_BERT_MLP_TRAIN='auto', the port's
    ``fused_mlp_train`` here."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jx.models.pretrain, "NCEHeadForText",
               functools.partial(jx.models.heads.NCEHeadForText, dropout_ratio=0.0))
    mp.setattr(jx.bert, "_BERT_FUSED_MLP_TRAIN", "auto")
    return mp


def _port_model(pcfg, params):
    pm = CloverPretrain(pcfg, device="cpu")
    pm.mlm_ssl_T_head.drop = 0.0
    load_jax_params(pm, params)
    return pm


@pytest.fixture(scope="module")
def pretrain_run():
    """The JAX reference: the tiny model's weights, forward_train outputs per
    (batch_passes, share_embed), forward_test, batch 0's loss and gradients,
    and 2 steps of make_pretrain_train_step (AdamW, warmup, clip)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import clover_tpu.models as models
    import clover_tpu.models.bert as bert
    from clover_tpu.engine import TrainState as JTrainState
    from clover_tpu.engine import make_optimizer as jmake_optimizer
    from clover_tpu.engine.steps import make_pretrain_train_step as jmake_step
    from clover_tpu.losses.objectives import pretrain_losses as jpretrain_losses
    from clover_tpu.losses.objectives import total_loss as jtotal_loss

    jx = types.SimpleNamespace(jax=jax, jnp=jnp, models=models, bert=bert)
    mp = _jax_knobs(jx)
    key = jax.random.PRNGKey(0)
    try:
        jcfg, pcfg = _configs(jx)
        jm = models.CloverPretrain(jcfg, dtype=jnp.float32)
        batches = [_pretrain_batch(s) for s in range(2)]
        params = _init(jx, jm, batches[0], train=False)["params"]

        def loss_fn(p, batch):
            out = jm.apply({"params": p}, batch, train=True, rngs={"dropout": key})
            return jtotal_loss(jpretrain_losses(out, batch["mlm_label"]))

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batches[0])
        forward = {}
        # without batch_passes the JAX model never reads share_embed: one run
        for bp, se in ((True, True), (True, False), (False, True)):
            m = models.CloverPretrain(dataclasses.replace(jcfg, batch_passes=bp, share_embed=se))
            forward[bp, se] = jax.device_get(jax.jit(
                lambda p, b, m=m: m.apply({"params": p}, b, train=True,
                                          rngs={"dropout": key}))(params, batches[1]))
        forward[False, False] = forward[False, True]
        b1 = batches[1]
        test = jax.device_get(jax.jit(lambda p, *a: jm.apply({"params": p}, *a,
                                                             method="forward_test"))(
            params, b1["imgs"], b1["token_ids"], b1["input_mask"]))
        tx, _ = jmake_optimizer(params, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
        state = JTrainState.create(params, tx)
        step = jax.jit(jmake_step(jm, jit=False, grad_clip_norm=CLIP))
        history = []
        for b in batches:
            state, metrics = step(state, b, key)
            history.append(jax.device_get((metrics, state.params, state.opt_state)))
    finally:
        mp.undo()
    return dict(pcfg=pcfg, params=jax.device_get(params), batches=batches, loss=float(loss),
                grads=jax.device_get(grads), forward=forward, test=test, history=history)


@pytest.mark.parametrize("batch_passes,share_embed",
                         [(True, True), (True, False), (False, True), (False, False)])
def test_forward_train_matches_jax(pretrain_run, batch_passes, share_embed, monkeypatch):
    """forward_train (train() mode, every dropout at 0) in each batch_passes /
    share_embed combination against the JAX forward_train with train=True:
    the same keys, every output within 1e-4 abs + rel (observed ~2e-6). With
    batch_passes the fusion pass has 2400 rows and takes the fused FFN
    route ('auto'); the text passes' 48 or 24 rows, and the fusion passes'
    1200 without batch_passes, do not."""
    pcfg = dataclasses.replace(pretrain_run["pcfg"], batch_passes=batch_passes,
                               share_embed=share_embed)
    seen = []
    _counting_fn(monkeypatch, seen)
    pm = _port_model(pcfg, pretrain_run["params"]).train()
    with torch.no_grad():
        got = pm.forward_train(_torch_batch(pretrain_run["batches"][1]), torch.Generator())
    # the fused FFN route: the batched fusion pass's 2 * 3 * (392 + 8) rows only
    assert [a[0].shape[0] for a in seen] == ([2400] if batch_passes else [])
    want = pretrain_run["forward"][batch_passes, share_embed]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def test_forward_test_matches_jax(pretrain_run):
    """forward_test (the dual-tower retrieval embeddings, eval) against the
    JAX forward_test within 1e-4 abs + rel."""
    pm = _port_model(pretrain_run["pcfg"], pretrain_run["params"]).eval()
    b = _torch_batch(pretrain_run["batches"][1])
    with torch.no_grad():
        got = pm.forward_test(b["imgs"], b["token_ids"], b["input_mask"])
    for g, w in zip(got, pretrain_run["test"]):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4, rtol=1e-4)


def test_pretrain_step_gradients_match_jax(pretrain_run):
    """forward_train + pretrain_losses + backward against jax.value_and_grad
    of the JAX pretrain loss: loss and global gradient norm within 1e-5
    relative, each parameter's gradient within 2e-4 * max|its JAX
    gradient| + 1e-7 (test_torch_train32's limits). The attention key
    biases' gradients are zero in exact arithmetic (softmax does not see
    q.b_k): on both sides each entry is fp32 noise below 1e-6 (observed
    ~1e-7, at the size of the absolute floor)."""
    from test_torch_train import _key_bias

    pm = _port_model(pretrain_run["pcfg"], pretrain_run["params"]).train()
    batch = _torch_batch(pretrain_run["batches"][0])
    loss = total_loss(pretrain_losses(pm.forward_train(batch, torch.Generator()),
                                      batch["mlm_label"]))
    loss.backward()
    assert loss.item() == pytest.approx(pretrain_run["loss"], rel=1e-5)
    want = state_from_jax(pretrain_run["grads"])
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want.values()))
    got_norm = np.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in pm.parameters()))
    assert got_norm == pytest.approx(gnorm, rel=1e-5)
    for name, p in pm.named_parameters():
        w, got = want[name].reshape(-1), p.grad.numpy().reshape(-1)
        noise = _key_bias(name, w.size)
        assert np.abs(got[noise]).max(initial=0) < 1e-6 > np.abs(w[noise]).max(initial=0), name
        w, got = w[~noise], got[~noise]
        if w.size:
            err = float(np.abs(got - w).max())
            assert err <= 2e-4 * np.abs(w).max() + 1e-7, f"{name}: {err} vs max {np.abs(w).max()}"


def test_two_pretrain_steps_match_jax(pretrain_run):
    """2 steps of make_pretrain_train_step (AdamW, warmup, clip at 1.0)
    against the JAX step: every metric (the five loss terms, loss,
    grad_norm) within 1e-4 relative, the parameters after 2 steps within
    2e-5 absolute, the attention key biases within 3 lr (test_torch_train32's
    limits)."""
    from clover_tpu_torch.engine import TrainState, make_optimizer, make_pretrain_train_step
    from test_torch_train import _assert_params_close

    history = pretrain_run["history"]
    assert max(float(h[0]["grad_norm"]) for h in history) > CLIP, "the clip never fired"
    pm = _port_model(pretrain_run["pcfg"], pretrain_run["params"])
    optimizer, schedule = make_optimizer(pm, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
    state = TrainState.create(pm, optimizer, schedule)
    step = make_pretrain_train_step(pm, grad_clip_norm=CLIP)
    for b, (want, _, _) in zip(pretrain_run["batches"], history):
        state, metrics = step(state, _torch_batch(b), torch.Generator().manual_seed(0))
        assert set(metrics) == set(want) == {"mlm_loss", "nce_loss", "rank_t_tm_loss",
                                             "v_nce_loss", "rank_v_vm_loss", "loss", "grad_norm"}
        for k in want:
            assert metrics[k].item() == pytest.approx(float(want[k]), rel=1e-4, abs=1e-7), k
    assert state.step == 2
    _assert_params_close(pm, history[-1][1], 2e-5, "after 2 steps")


def test_bridge_loads_the_pretrain_tree_and_its_moments(pretrain_run):
    """The JAX pretrain tree loads strictly (every leaf on one parameter,
    every parameter set; the fusion tower has no text embeddings on either
    side), a tree with a leaf too many is refused, and the JAX state after
    step 1 (params and AdamW count / mu / nu) resumes in the port: its step
    2 lands within 2e-5 of JAX's."""
    from clover_tpu_torch.engine import TrainState, make_optimizer, make_pretrain_train_step
    from clover_tpu_torch.models import opt_state_from_jax
    from test_torch_train import _assert_params_close

    params = pretrain_run["params"]
    assert "embeddings" not in params["multimodal_backbone"]
    pm = _port_model(pretrain_run["pcfg"], params)
    assert len(state_from_jax(params)) == len(list(pm.parameters()))
    bad = {**params, "multimodal_backbone": {**params["multimodal_backbone"],
                                             "embeddings": params["text_backbone"]["embeddings"]}}
    with pytest.raises(KeyError):
        load_jax_params(pm, bad)
    history = pretrain_run["history"]
    pm = _port_model(pretrain_run["pcfg"], history[0][1])
    optimizer, schedule = make_optimizer(pm, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
    count = opt_state_from_jax(history[0][2], pm, optimizer)
    assert count == 1
    state = TrainState(pm, optimizer, schedule, step=count)
    make_pretrain_train_step(pm, grad_clip_norm=CLIP)(
        state, _torch_batch(pretrain_run["batches"][1]), torch.Generator())
    _assert_params_close(pm, history[1][1], 2e-5, "resumed step 2")


def test_weight_decay_mask_matches_jax_on_the_pretrain_tree(pretrain_run):
    """The decay mask on the pretrain model equals the JAX mask leaf for
    leaf (no decay on the mask token, the visual positions, the token-type
    table)."""
    from clover_tpu.engine import weight_decay_mask as jweight_decay_mask
    from clover_tpu_torch.engine import weight_decay_mask

    pm = _port_model(pretrain_run["pcfg"], pretrain_run["params"])
    want = {k: bool(v) for k, v in state_from_jax(
        jweight_decay_mask(pretrain_run["params"])).items()}
    got = weight_decay_mask(pm)
    assert got == want
    for name in ("backbone.mask_token", "multimodal_backbone.vis_space_pos",
                 "multimodal_backbone.token_type_embeddings.weight"):
        assert not got[name], name
    assert got["mlm_head.decoder.weight"] and got["multimodal_backbone.fc_in.weight"]


def test_pretrain_builds_on_the_device_asked_for(monkeypatch):
    """device='cpu' builds every parameter on the CPU; with no card the
    default construction raises and names the way out."""
    pm = CloverPretrain(PretrainConfig(swin=SwinConfig(mask_token=True, embed_impl="conv",
                                                       **SWIN),
                                       text_bert=BertConfig(num_hidden_layers=1, **BERT),
                                       fusion=FusionConfig(bert=BertConfig(num_hidden_layers=1,
                                                                           **BERT), **FUSION),
                                       vts_embed_dim=32), device="cpu")
    assert {p.device.type for p in pm.parameters()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CloverPretrain(PretrainConfig())


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_mlp(dev, rows, seed, keep=0.9):
    """x (rows, 768) bf16 and fp32 BERT-base FFN weights on the card, a
    seeded {0, 1/keep} mask."""
    x, params, m, g = _mlp_inputs(seed, rows=rows, C=768, H=3072, keep=keep)
    return (torch.from_numpy(x).to(dev, torch.bfloat16),
            [t.to(dev) for t in _torch_params(params)], torch.from_numpy(m).to(dev),
            torch.from_numpy(g).to(dev, torch.bfloat16))


def _close(got, ref, atol, rtol):
    """bf16 outputs: max|got - ref| <= atol + rtol * max|ref|, as chip_smoke.py."""
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= atol + rtol * ref.float().abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [3616, 1001])
def test_k3m_kernel_on_card(cuda, rows):
    """K3M at the fusion tower's 3616 rows and at an odd count against its
    plain version (chip_smoke.py's K3M limits); one launch counted; with no
    mask it is K3, bitwise."""
    x, w, m, _ = _card_mlp(cuda, rows, 90)
    before = ops.fused_mlp_postln_dropout.launches
    got = ops.fused_mlp_postln_dropout(x, *w, m, 1e-12)
    torch.cuda.synchronize()
    assert ops.fused_mlp_postln_dropout.launches == before + 1
    _close(got, ops.mlp_postln_mask_plain(x, *w, m, 1e-12), 2e-2, 2e-2)
    assert torch.equal(ops.fused_mlp_postln_dropout(x, *w, None, 1e-12),
                       ops.fused_mlp_postln(x, *w, 1e-12))


_UNCACHED_K3M = r"""
import sys
import torch
from clover_tpu_torch import ops

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)

def randn(*shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

f32 = torch.float32
x = randn(3616, 768)
w = (1 + randn(768, std=0.1, dtype=f32), randn(768, std=0.1, dtype=f32),
     randn(3072, 768, std=768 ** -0.5, dtype=f32), randn(3072, std=0.1, dtype=f32),
     randn(768, 3072, std=3072 ** -0.5, dtype=f32), randn(768, std=0.1, dtype=f32))
mask = (torch.rand(3616, 768, generator=g, device=dev) < 0.9).float() / 0.9
got = ops.fused_mlp_postln_dropout(x, *w, mask, 1e-12).float()
ref = ops.mlp_postln_mask_plain(x, *w, mask, 1e-12).float()
torch.cuda.synchronize()
err = (got - ref).abs().max().item()
sys.exit(None if err <= 2e-2 + 2e-2 * ref.abs().max().item() else f"K3M: max abs err {err}")
"""


@pytest.mark.gpu
def test_k3m_reads_no_freed_buffer(cuda):
    """K3M with PyTorch's caching allocator off and fp32 weights (so the
    wrapper makes bf16 copies), as test_kernels_read_no_freed_buffer checks
    K3: a buffer let go before the launch would be read after it was
    freed."""
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    proc = subprocess.run([sys.executable, "-c", _UNCACHED_K3M],
                          cwd=Path(__file__).resolve().parent.parent, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.gpu
def test_fused_mlp_postln_dropout_fn_on_card(cuda):
    """FusedMlpPostlnDropoutFn with the kernel (K3M) against the plain
    version on the card: the forward within K3M's limits, and the backward,
    which recomputes from the same saved inputs in both, bitwise equal;
    every gradient finite."""
    x, w, m, g = _card_mlp(cuda, 3616, 91)
    grads = []
    for kernels in (True, False):
        leaves = [x.detach().clone().requires_grad_()] + [t.clone().requires_grad_() for t in w]
        out = ops.FusedMlpPostlnDropoutFn.apply(*leaves, m, 1e-12, kernels)
        grads.append((out.detach(), torch.autograd.grad(out, leaves, g)))
    (k_out, k_grads), (p_out, p_grads) = grads
    _close(k_out, p_out, 2e-2, 2e-2)
    for a, b in zip(k_grads, p_grads):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
