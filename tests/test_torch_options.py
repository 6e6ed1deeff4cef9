"""The options of slices 1-3 the port took last, held against the JAX package
on the CPU, in fp32:

- ``SwinConfig(attention_impl='fused_block')``: the half-block (K6's plain
  version) in every block of a stage that divides the window, on the
  window-resident layout, on the JAX fused-block test's configuration
  (tests/test_attn_block_kernel.py), a stage that pads (K1 there, as the
  JAX block leaves 'fused_block' for XLA) and the gradients in training,
  against the JAX default route: 3e-5;
- ``stride != patch_size`` (the strided ``nn.Conv`` embed), and the
  ``drop_rate`` / ``attn_drop_rate`` routes;
- ``NCEHeadForMM``'s ``text_agg_type`` 'avg' / 'max' and its BatchNorm
  projector (eval, and training with the running statistics' update);
- ``step_schedule``, ``freeze_by_prefix`` / ``freeze_mask_from_cfg``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clover_tpu.models.swin3d as jswin
from clover_tpu.engine.optim import freeze_by_prefix as jfreeze_by_prefix
from clover_tpu.engine.optim import freeze_mask_from_cfg as jfreeze_mask_from_cfg
from clover_tpu.engine.optim import step_schedule as jstep_schedule
from clover_tpu.models.heads import NCEHeadForMM as JNCEHeadForMM
from clover_tpu_torch.engine import freeze_by_prefix, freeze_mask_from_cfg, step_schedule
from clover_tpu_torch.models import load_jax_params, state_from_jax
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.models.heads import NCEHeadForMM
from clover_tpu_torch.models.layers import Mlp
from test_torch_bridge import tiny_models

# the JAX fused-block test's Swin (tests/test_attn_block_kernel.py:66-86)
FB = dict(patch_size=(1, 2, 2), stride=(1, 2, 2), embed_dim=16, depths=(2, 2), num_heads=(2, 4),
          window_size=(2, 2, 2), drop_path_rate=0.0)
TOL = dict(atol=3e-5, rtol=3e-5)


def _clip(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_swin(x, **fields):
    """(JAX backbone, seeded params) of ``fields`` on x: the tree's shapes
    (jax.eval_shape, no init run) filled as test_torch_bridge fills them: LN
    scales near 1, kernels at 1/sqrt(fan-in), tables at 0.5, the rest 0.1."""
    jm = jswin.SwinTransformer3D(jswin.SwinConfig(**fields))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.normal(size=shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name == "kernel":
            z = z / np.sqrt(np.prod(shape[:-1]))
        else:
            z = (0.5 if name == "relative_position_bias_table" else 0.1) * z
        return z.astype(np.float32)

    return jm, jax.tree_util.tree_map_with_path(fill, shapes)


def _port_swin(params, **fields):
    pm = pswin.SwinTransformer3D(pswin.SwinConfig(embed_impl="conv", **fields))
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in state_from_jax(params).items()})
    return pm


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the blocks that took the fused half-block."""
    calls = []
    real = pswin.SwinBlock3D._fused_attn_half

    def counted(self, *a, **k):
        calls.append(self)
        return real(self, *a, **k)

    monkeypatch.setattr(pswin.SwinBlock3D, "_fused_attn_half", counted)
    return calls


@pytest.mark.parametrize("size,fused", [(8, 4), (12, 2)])
def test_fused_block_swin_matches_the_jax_default_route(fused_calls, size, fused):
    """The tiny Swin under 'fused_block' in eval against the JAX default
    (XLA) route on the same weights, within 3e-5 (observed 1.5e-6). At 8^2
    every block takes the half-block (tokens (2, 4, 4), then (2, 2, 2)); at
    12^2 stage 1's tokens (2, 3, 3) pad, so its 2 blocks take K1 on the
    partitioned windows."""
    x = _clip((2, 2, size, size, 3), 2)
    jm, params = _jax_swin(x, **FB)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    pm = _port_swin(params, attention_impl="fused_block", **FB).eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert len(fused_calls) == fused


def test_fused_block_gradients_match_jax(fused_calls):
    """The JAX fused-block gradient test's Swin (embed dim 8, one stage, a
    shifted block) in training with drop_path_rate 0: the half-block through
    FusedAttnBlockFn (its backward recomputes through K1's and K5's plain
    versions), against jax.grad of the JAX default route: every parameter's
    gradient within 3e-5 of max|JAX gradient| (observed 2.5e-6)."""
    fields = dict(FB, embed_dim=8, depths=(2,), num_heads=(2,))
    x = _clip((1, 2, 4, 4, 3), 3)
    jm, params = _jax_swin(x, **fields)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) ** 2)))(params)
    pm = _port_swin(params, attention_impl="fused_block", **fields).train()
    (pm(torch.from_numpy(x), generator=torch.Generator()) ** 2).sum().backward()
    assert len(fused_calls) == 2
    want = state_from_jax(jax.device_get(grads))
    for name, p in pm.named_parameters():
        scale = np.abs(want[name]).max()
        assert np.abs(p.grad.numpy() - want[name]).max() <= 3e-5 * max(scale, 1e-3), name


def test_strided_patch_embed_matches_jax():
    """patch (2, 4, 4) with stride (1, 2, 2): the JAX nn.Conv kernel (pd, ph,
    pw, C, E) bridged as it is, the clip padded to whole patches (3 x 14^2 ->
    4 x 16^2) and convolved: within 3e-5 (observed 1.5e-6); embed_dims gives
    the token dims."""
    fields = dict(FB, patch_size=(2, 4, 4), stride=(1, 2, 2))
    x = _clip((1, 3, 14, 14, 3), 4)
    jm, params = _jax_swin(x, **fields)
    assert params["params"]["patch_embed"]["proj"]["kernel"].shape == (2, 4, 4, 3, 16)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    pm = _port_swin(params, **fields).eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    cfg = pswin.SwinConfig(embed_impl="conv", **fields)
    assert pswin.embed_dims(cfg, (3, 14, 14)) == (3, 7, 7)
    assert pswin.embed_dims(pswin.SwinConfig(), (32, 224, 224)) == (16, 56, 56)
    with torch.no_grad():
        assert pm(torch.from_numpy(x), mode="embed").shape == (1, 3, 7, 7, 16)


def test_dropout_rates_leave_eval_alone():
    """drop_rate 0.3 and attn_drop_rate 0.2 are no-ops in eval: the tiny Swin
    on either route within 3e-5 of the JAX forward with the same rates."""
    x = _clip((2, 2, 8, 8, 3), 5)
    fields = dict(FB, drop_rate=0.3, attn_drop_rate=0.2)
    jm, params = _jax_swin(x, **fields)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    for impl in ("auto", "fused_block"):
        pm = _port_swin(params, attention_impl=impl, **fields).eval()
        with torch.no_grad():
            np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("rates", [(0.3, 0.0), (0.0, 0.2), (0.3, 0.2)])
def test_dropout_rates_take_the_plain_route_in_training(fused_calls, monkeypatch, rates):
    """In training a rate above 0 sends each block to its plain route, as the
    JAX block leaves its kernels: attn_drop_rate the 'xla' attention with
    the probabilities' dropout, drop_rate the plain MLP (fc1, GELU, dropout,
    fc2, dropout), and neither the fused half-block. The draws come from the
    generator: one seed gives the same output twice, another a different one."""
    drop, attn_drop = rates
    seen = {"xla": 0, "mlp": 0}
    real_xla, real_mlp = pswin._xla_attention, Mlp.forward

    def xla(*a, **k):
        seen["xla"] += 1
        return real_xla(*a, **k)

    def mlp(self, *a, **k):
        seen["mlp"] += 1
        return real_mlp(self, *a, **k)

    monkeypatch.setattr(pswin, "_xla_attention", xla)
    monkeypatch.setattr(Mlp, "forward", mlp)
    x = torch.from_numpy(_clip((2, 2, 8, 8, 3), 6))
    pm = pswin.SwinTransformer3D(pswin.SwinConfig(
        embed_impl="conv", attention_impl="fused_block", drop_rate=drop, attn_drop_rate=attn_drop,
        **FB)).train()
    outs = [pm(x, generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert not fused_calls
    assert seen == {"xla": 12 if attn_drop else 0, "mlp": 12 if drop else 0}
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    outs[0].square().sum().backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in pm.parameters() if p.grad is not None)


# ----------------------------------------------------------- NCEHeadForMM

HEAD = dict(visual_in_channels=16, text_in_channels=24, img_hidden_dim=32, vts_embed_dim=8)


def _head_inputs():
    rng = np.random.default_rng(7)
    visual = rng.normal(size=(4, 2, 2, 2, 16)).astype(np.float32)
    text = rng.normal(size=(4, 6, 24)).astype(np.float32)
    ids = rng.integers(1000, 2000, size=(4, 6)).astype(np.int32)
    mask = np.ones((4, 6), np.int32)
    mask[1, 4:] = 0
    mask[3, 2:] = 0
    ids[0, 5], ids[1, 3], ids[2, 5] = 102, 102, 102          # SEP
    ids[3, 1] = 102                                          # no word left: count 0
    return visual, text, mask, ids


def _heads(**fields):
    """(JAX head, its variables with seeded params and running statistics,
    port head loaded with them)."""
    jh = JNCEHeadForMM(**HEAD, **fields)
    variables = jh.init(jax.random.PRNGKey(0), *map(jnp.asarray, _head_inputs()))
    rng = np.random.default_rng(8)

    def fill(path, a):
        z = rng.normal(size=a.shape)
        if path[-1].key in ("scale", "var"):
            z = 1.0 + 0.3 * np.abs(z)
        return (0.3 * z if path[-1].key in ("bias", "mean") else z).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, jax.device_get(variables))
    ph = NCEHeadForMM(**HEAD, **fields)
    load_jax_params(ph, variables)
    return jh, variables, ph


@pytest.mark.parametrize("agg", ["cls", "avg", "max"])
def test_text_aggregation_matches_jax(agg):
    """'avg' / 'max' pool the words: CLS dropped, SEP and padding masked, the
    mean over max(count, 1e-6) (a caption of no words gives 0), the max over
    the zero-filled masked tokens. Within 1e-5 (observed 5.7e-6)."""
    jh, variables, ph = _heads(text_agg_type=agg)
    inputs = _head_inputs()
    want = jh.apply(variables, *map(jnp.asarray, inputs))
    got = ph.eval()(*map(torch.from_numpy, inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_projector_matches_jax(train):
    """use_ln=False, text_bn=True: in eval the running statistics; in
    training the batch's mean and biased variance, and the running
    statistics updated as 0.9 ra + 0.1 batch. Outputs and updated
    statistics within 1e-5 (observed 5.7e-6)."""
    jh, variables, ph = _heads(use_ln=False, text_bn=True, text_agg_type="avg")
    inputs = _head_inputs()
    if train:
        want, updates = jh.apply(variables, *map(jnp.asarray, inputs), deterministic=False,
                                 mutable=["batch_stats"])
        stats = state_from_jax({"params": jax.device_get(updates["batch_stats"])})
    else:
        want = jh.apply(variables, *map(jnp.asarray, inputs))
        stats = state_from_jax({"params": variables["batch_stats"]})
    got = ph.train(train)(*map(torch.from_numpy, inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    buffers = dict(ph.named_buffers())
    assert set(buffers) == set(stats) and len(stats) == 6
    for name, value in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------- schedule, freeze

def test_step_schedule_matches_optax():
    """Compounded scales from each boundary on: at every boundary and one
    step either side, within 1e-6 relative (optax computes in fp32)."""
    pairs = {30: 0.1, 10: 0.5, 20: 0.2}
    want, got = jstep_schedule(2e-3, pairs), step_schedule(2e-3, pairs)
    for count in (0, 9, 10, 11, 19, 20, 21, 29, 30, 31, 100):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6), count
    assert got(10) == pytest.approx(1e-3) and got(30) == pytest.approx(2e-3 * 0.5 * 0.2 * 0.1)


@pytest.fixture(scope="module")
def tree():
    """The tiny finetune model (test_torch_bridge) and its JAX tree's shapes."""
    jm, pm = tiny_models()
    x = jnp.zeros((2, 1, 2, 28, 28, 96), jnp.uint8)
    tok = jnp.zeros((2, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, tok, tok,
                                            method="forward_test"))["params"]
    return pm, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _same_leaves(got, want_tree):
    want = {k: bool(v) for k, v in state_from_jax(want_tree).items()}
    assert got == want
    return sum(not v for v in got.values())


@pytest.mark.parametrize("prefixes", [("text_backbone",), ("backbone/patch_embed", "ssl_head/img"),
                                      ("backbone/stage_0",)])
def test_freeze_by_prefix_freezes_the_jax_leaves(tree, prefixes):
    pm, params = tree
    assert _same_leaves(freeze_by_prefix(pm, prefixes), jfreeze_by_prefix(params, prefixes)) > 0


@pytest.mark.parametrize("stage,exempt", [
    (("backbone.patch_embed.", "text_backbone"), ()),
    (("text_backbone.encoder",), ("layer_1",)),
    (("backbone",), ("norm",)),                 # substrings: ssl_head's norms stay too
    (("stage_1", "embeddings"), ("position_embeddings", "stage_1_block_0.attn")),
])
def test_freeze_mask_from_cfg_freezes_the_jax_leaves(tree, stage, exempt):
    """Substring matches on the '/'-joined JAX leaf paths, dots as '/', the
    exemptions winning: the same leaves as the JAX mask."""
    pm, params = tree
    got = freeze_mask_from_cfg(pm, stage, exempt)
    assert _same_leaves(got, jfreeze_mask_from_cfg(params, stage, exempt)) > 0
    if exempt:
        assert _same_leaves(got, jfreeze_mask_from_cfg(params, stage, exempt)) < sum(
            not v for v in freeze_mask_from_cfg(pm, stage).values())


def test_fields_reach_the_blocks():
    cfg = pswin.SwinConfig(embed_impl="conv", drop_rate=0.1, attn_drop_rate=0.05,
                           attention_impl="fused_block", **dict(FB, drop_path_rate=0.2))
    pm = pswin.SwinTransformer3D(cfg)
    blk = pm.stage_1_block_1
    assert (blk.drop, blk.attn.attn_drop, blk.attention_impl) == (0.1, 0.05, "fused_block")
    assert dataclasses.replace(cfg, drop_rate=0.0).drop_rate == 0.0
