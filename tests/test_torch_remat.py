"""Stage remat and the recompute MLP backward of the port, held against the
JAX package on the CPU.

The TPU's 32-frame pretrain recipe rematerialises Swin stages 0-1
(``SwinConfig.use_checkpoint``) and turns the MLP z-stash off
(``CLOVER_MLP_STASH=0``), so every Swin MLP backward recomputes LN + fc1 +
GELU: ``_xla_backward``, or the Pallas kernels ``_backward_onepass`` and
``_backward_pallas`` when opted in. The port has them as
``ln_mlp_residual_bwd_recompute`` (plain) and the kernels K7
(``ln_mlp_residual_bwd_onepass``) and K8 (``ln_mlp_residual_bwd_pair``,
K7's passes with the erf GELU), picked by ``SwinConfig.mlp_bwd``, and remat
as ``models.layers.remat``, which replays the explicit dropout generator in
the recompute. On the CPU every wrapper runs the plain version; these tests
feed the same seeded numpy inputs to it and to the JAX function (the Pallas
kernels in interpret mode), in fp32, with the tolerance each states:

- the recompute backward against ``_xla_backward``, ``_backward_onepass``
  and ``_backward_pallas``; ``FusedLnMlpResidualFn`` with the stash off on
  each route against autograd of the plain forward; the config's checks;
- the generator replay: a tiny pretrain step with DropPath and dropout on
  gives the same gradients with and without remat (Swin stages, BERT
  layers);
- a tiny pretrain step (Swin embed 32 with 2 heads in two stages, BERT 2
  layers of 64, a 1-layer fusion tower) with ``use_checkpoint=(0,)`` and the
  stash off against the JAX step with the same config and ``_STASH=False``,
  every dropout at 0, and the bridge of the JAX remat tree.

The ``gpu`` tests launch K7 and K8 and skip without a card:
``python -m pytest tests/test_torch_remat.py -m gpu --noconftest``.
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
from clover_tpu_torch.losses import pretrain_losses, total_loss
from clover_tpu_torch.models import (BertConfig, CloverPretrain, FusionConfig, PretrainConfig,
                                     SwinConfig, init_params, load_jax_params, state_from_jax)

SWIN = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 2))
BERT = dict(vocab_size=100, hidden_size=64, num_attention_heads=2, intermediate_size=128)
FUSION = dict(img_in_size=64, hidden_size=64, num_frames=2, spatial_tokens=49)
LR, TOTAL, WARMUP, CLIP = 1e-3, 20, 2, 1.0
NAMES = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2", "drs")


@pytest.fixture
def jx():
    """The JAX package's MLP module."""
    jnp = pytest.importorskip("jax.numpy")
    import clover_tpu.ops.mlp_block as mlp

    return types.SimpleNamespace(jnp=jnp, mlp=mlp)


def _np(t):
    return np.asarray(t, np.float32)


# ------------------------------------------------- the recompute backward

def _mlp_case(seed, with_rs, ragged, C=64, H=256):
    """x, JAX-layout params (LN scale / bias, (C, H) / (H, C) kernels), a
    DropPath row scale or None, a cotangent; 44 rows (ragged against the
    Pallas kernels' 16-row blocks) or 48."""
    rng = np.random.default_rng(seed)
    rows = 44 if ragged else 48
    x = rng.normal(size=(rows, C)).astype(np.float32) * 1.5 + 0.3
    params = [rng.normal(size=s).astype(np.float32) * f for s, f in
              [(C, 1.0), (C, 0.1), ((C, H), C ** -0.5), (H, 0.1), ((H, C), H ** -0.5), (C, 0.1)]]
    rs = ((rng.random(rows) > 0.3) / 0.7).astype(np.float32) if with_rs else None
    g = rng.normal(size=(rows, C)).astype(np.float32)
    return x, params, rs, g


def _torch_args(x, params, rs, g):
    s, b, k1, b1, k2, b2 = (torch.from_numpy(v) for v in params)
    return (torch.from_numpy(x), s, b, k1.T.contiguous(), b1, k2.T.contiguous(), b2,
            None if rs is None else torch.from_numpy(rs)), torch.from_numpy(g)


def _assert_grads(got, want, atol, rtol):
    """The port's 8 outputs against the JAX backward's (kernels transposed
    to the torch layout); drs None exactly when the JAX one is."""
    for name, a, w in zip(NAMES, got, want):
        if w is None:
            assert a is None, name
            continue
        w = _np(w)
        if name in ("dw1", "dw2"):
            w = w.T
        np.testing.assert_allclose(a.numpy(), w.reshape(a.shape), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("with_rs", [False, True])
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_recompute_backward_matches_xla_backward(gelu, with_rs, ragged, jx):
    """ln_mlp_residual_bwd_recompute against _xla_backward (its default bf16
    crossings, identities in fp32): every output within 2e-5 absolute and
    relative (the JAX gelu' takes the rational erf, within 1.5e-7)."""
    x, params, rs, g = _mlp_case(40, with_rs, ragged)
    want = jx.mlp._xla_backward(*map(jx.jnp.asarray, (x, *params)),
                                None if rs is None else jx.jnp.asarray(rs), 1e-5, gelu,
                                jx.jnp.asarray(g))
    args, tg = _torch_args(x, params, rs, g)
    _assert_grads(ops.ln_mlp_residual_bwd_recompute(*args, 1e-5, gelu, tg), want, 2e-5, 2e-5)


@pytest.mark.parametrize("with_rs,ragged", [(False, False), (True, True)])
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_onepass_wrapper_matches_pallas_onepass(gelu, with_rs, ragged, jx, monkeypatch):
    """K7's wrapper on CPU tensors (the plain recompute) against the one-pass
    Pallas kernel in interpret mode (16-row blocks, so 44 rows leave a masked
    tail): within 2e-4 absolute and relative; no launch counted."""
    mlp = jx.mlp
    monkeypatch.setattr(mlp, "_FORCE_PALLAS", True)
    monkeypatch.setattr(mlp, "_BWD_ONEPASS", "auto")
    monkeypatch.setattr(mlp, "_pick_rows_onepass", lambda rows, C, H, i: 16)
    x, params, rs, g = _mlp_case(41, with_rs, ragged)
    want = mlp._backward_onepass(*map(jx.jnp.asarray, (x, *params)),
                                 None if rs is None else jx.jnp.asarray(rs), 1e-5, gelu,
                                 jx.jnp.asarray(g))
    assert want is not None
    args, tg = _torch_args(x, params, rs, g)
    ops.reset_launch_counts()
    _assert_grads(ops.ln_mlp_residual_bwd_onepass(*args, 1e-5, gelu, tg), want, 2e-4, 2e-4)
    assert ops.ln_mlp_residual_bwd_onepass.launches == 0


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("with_rs", [False, True])
def test_pair_wrapper_matches_pallas_pair(with_rs, ragged, jx, monkeypatch):
    """The pair's wrapper (erf) on CPU tensors (K7's passes in plain
    PyTorch) against _backward_pallas in interpret mode (16-row blocks, 4
    hidden chunks): within 2e-4; no launch counted; the pair refuses the
    tanh GELU."""
    mlp = jx.mlp
    monkeypatch.setattr(mlp, "_FORCE_PALLAS", True)
    monkeypatch.setattr(mlp, "_pick_tiles_bwd", lambda rows, C, H, i: (16, H // 4))
    x, params, rs, g = _mlp_case(42, with_rs, ragged)
    want = mlp._backward_pallas(*map(jx.jnp.asarray, (x, *params)),
                                None if rs is None else jx.jnp.asarray(rs), 1e-5,
                                jx.jnp.asarray(g))
    assert want is not None
    args, tg = _torch_args(x, params, rs, g)
    ops.reset_launch_counts()
    _assert_grads(ops.ln_mlp_residual_bwd_pair(*args, 1e-5, "erf", tg), want, 2e-4, 2e-4)
    assert ops.ln_mlp_residual_bwd_pair.launches == 0
    with pytest.raises(ValueError, match="erf"):
        ops.ln_mlp_residual_bwd_pair(*args, 1e-5, "tanh", tg)


@pytest.mark.parametrize("rows", [196, 294, 300])
def test_pair_on_p8e_like_rows_matches_pallas_pair(rows, jx, monkeypatch):
    """The pair's CPU route on ragged row counts like P8E's (196 = one
    stage-3 clip of 4 x 7 x 7 tokens, 294, 300: none a whole number of the
    Pallas kernel's 16-row blocks or K7's 128-row tiles), with a row scale,
    against _backward_pallas in interpret mode: within 2e-4. With K7's
    hidden cap lowered to one 128-row tile the passes take the rows in 2-3
    chunks: dx is bitwise the one-chunk route's."""
    from clover_tpu_torch.ops import mlp_block as mb

    mlp = jx.mlp
    monkeypatch.setattr(mlp, "_FORCE_PALLAS", True)
    monkeypatch.setattr(mlp, "_pick_tiles_bwd", lambda rows, C, H, i: (16, H // 4))
    rng = np.random.default_rng(rows)
    x, params, _, g = _mlp_case(rows, False, True)
    x = np.concatenate([x, rng.normal(size=(rows - x.shape[0], x.shape[1])).astype(np.float32)])
    g = np.concatenate([g, rng.normal(size=(rows - g.shape[0], g.shape[1])).astype(np.float32)])
    rs = ((rng.random(rows) > 0.1) / 0.9).astype(np.float32)
    want = mlp._backward_pallas(*map(jx.jnp.asarray, (x, *params)), jx.jnp.asarray(rs), 1e-5,
                                jx.jnp.asarray(g))
    args, tg = _torch_args(x, params, rs, g)
    one = ops.ln_mlp_residual_bwd_pair(*args, 1e-5, "erf", tg)
    _assert_grads(one, want, 2e-4, 2e-4)
    H = params[3].shape[0]
    cap = 4 * mb._K7_TILE * H   # dz and s h of one 128-row tile
    plan = mb.k7_plan(rows, x.shape[1], H, hidden_bytes=cap)
    assert plan.chunks == -(-rows // mb._K7_TILE) > 1
    got = mb.ln_mlp_residual_bwd_passes(*args, 1e-5, "erf", tg, plan)
    assert torch.equal(got[0], one[0])
    _assert_grads(got, want, 2e-4, 2e-4)


@pytest.mark.parametrize("route,gelu", [("xla", "tanh"), ("xla", "erf"), ("onepass", "tanh"),
                                        ("onepass", "erf"), ("pair", "erf")])
def test_stash_off_fn_matches_autograd_of_plain(route, gelu):
    """FusedLnMlpResidualFn with the stash off, on each route, kernels on
    and off (on the CPU both run the plain versions), against autograd
    through ln_mlp_residual_plain with a row scale: the output bitwise, every
    gradient within 1e-5 of its max (summation order); the row scale takes
    no gradient."""
    x, params, rs, g = _mlp_case(43, True, True, C=32, H=128)
    args, tg = _torch_args(x, params, rs, g)
    leaves = [t.clone().requires_grad_() for t in args[:7]]
    rs_t = args[7].clone().requires_grad_()
    ref = ops.ln_mlp_residual_plain(*leaves, 1e-5, gelu, rs_t.detach())
    want = torch.autograd.grad(ref, leaves, tg)
    for kernels in (True, False):
        out = ops.FusedLnMlpResidualFn.apply(*leaves, rs_t, 1e-5, gelu, kernels, False, route)
        assert torch.equal(out, ref)
        got = torch.autograd.grad(out, leaves + [rs_t], tg, allow_unused=True)
        assert got[-1] is None
        for name, a, w in zip(NAMES, got, want):
            torch.testing.assert_close(a, w, atol=1e-5 * w.abs().max().item(), rtol=0,
                                       msg=name)


def test_swin_config_checks_the_mlp_route_and_remat():
    """SwinConfig refuses an unknown mlp_bwd and 'pair' with the tanh GELU
    (the JAX package falls back to XLA there without a word); use_checkpoint
    is a bool or a tuple of stage ids, read as the JAX swin3d.py:1204-1206."""
    with pytest.raises(ValueError, match="mlp_bwd"):
        SwinConfig(mlp_bwd="fused")
    with pytest.raises(ValueError, match="erf"):
        SwinConfig(mlp_bwd="pair")
    with pytest.raises(ValueError, match="use_checkpoint"):
        SwinConfig(use_checkpoint="0,1")
    SwinConfig(mlp_bwd="pair", gelu="erf")
    assert [SwinConfig(use_checkpoint=(0, 1)).remat_stage(i) for i in range(4)] == [
        True, True, False, False]
    assert all(SwinConfig(use_checkpoint=True).remat_stage(i) for i in range(4))
    assert not any(SwinConfig().remat_stage(i) for i in range(4))


# --------------------------------------------------------- the generator replay

def _replay_model(use_checkpoint, bert_remat):
    """A tiny pretrain model with DropPath 0.1 and every dropout at 0.1, the
    stash off (the remat recipe's MLP route), seeded weights."""
    drop = dict(hidden_dropout=0.1, attention_dropout=0.1)
    cfg = PretrainConfig(
        swin=SwinConfig(embed_impl="conv", mask_token=True, drop_path_rate=0.1,
                        use_checkpoint=use_checkpoint, mlp_stash=False, mlp_bwd="onepass",
                        **SWIN),
        text_bert=BertConfig(num_hidden_layers=2, **drop, **BERT),
        fusion=FusionConfig(bert=BertConfig(num_hidden_layers=1, **drop, **BERT), **FUSION),
        vts_embed_dim=32)
    pm = CloverPretrain(cfg, device="cpu")
    init_params(pm, torch.Generator().manual_seed(0))
    pm.text_backbone.encoder.remat = bert_remat
    pm.multimodal_backbone.encoder.remat = bert_remat
    return pm.train()


def _replay_step(pm):
    """One forward + backward on batch 1 from generator seed 3: -> (loss,
    {name: grad}, the generator's state after the step)."""
    batch = _torch_batch(_pretrain_batch(1, 2))
    gen = torch.Generator().manual_seed(3)
    loss = total_loss(pretrain_losses(pm.forward_train(batch, gen), batch["mlm_label"]))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in pm.named_parameters()}, gen.get_state()


@pytest.fixture(scope="module")
def replay_base():
    return _replay_step(_replay_model(False, False))


@pytest.mark.parametrize("use_checkpoint,bert_remat", [((0,), False), (True, False),
                                                       (False, True), (True, True),
                                                       ((0, 1), True)])
def test_remat_replays_the_dropout_generator(replay_base, use_checkpoint, bert_remat):
    """With DropPath and dropout on, a step with the Swin stages and / or the
    BERT layers rematerialised gives the loss and every gradient of the step
    without remat within 1e-6, and leaves the generator where that step
    leaves it: the recompute draws the forward's masks again from a copy of
    the generator's state. (A checkpoint that passes the live generator
    draws new masks in the recompute: its gradients belong to another
    forward, off by O(1) here.)"""
    loss0, grads0, state0 = replay_base
    loss, grads, state = _replay_step(_replay_model(use_checkpoint, bert_remat))
    assert loss == pytest.approx(loss0, rel=1e-6)
    assert torch.equal(state, state0)
    for name, g0 in grads0.items():
        torch.testing.assert_close(grads[name], g0, atol=1e-6, rtol=0, msg=name)


# ------------------------------------- the tiny remat pretrain step against JAX

def _init(jx_mod, module, *args, seed=0, **kw):
    """Seeded random parameters of a JAX module (test_torch_pretrain's)."""
    from test_torch_pretrain import _fill

    jax = jx_mod.jax
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    return jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(seed)), shapes)


def _pretrain_batch(seed, B=3, T=4, S=56, L=8):
    """bench_train-shaped (test_torch_pretrain's): clips normal * 0.5, ids
    with position 3 masked and labelled, a random 0/1 (B, 7, 7) video mask."""
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


def _remat_configs(jm, mlp_bwd="xla"):
    """(JAX, port) pretrain configs: stage 0 rematerialised, every dropout
    and DropPath at 0; the port's stash off on route ``mlp_bwd``."""
    zero = dict(hidden_dropout=0.0, attention_dropout=0.0)
    jb = jm.bert.BertConfig
    jcfg = jm.models.PretrainConfig(
        swin=jm.models.SwinConfig(embed_impl="conv", mask_token=True, attention_impl="pallas_flat",
                                  drop_path_rate=0.0, use_checkpoint=(0,), **SWIN),
        text_bert=jb(num_hidden_layers=2, **zero, **BERT),
        fusion=jm.models.FusionConfig(bert=jb(num_hidden_layers=1, **zero, **BERT), **FUSION),
        vts_embed_dim=32)
    pb = functools.partial(BertConfig, **zero, **BERT)
    pcfg = PretrainConfig(
        swin=SwinConfig(embed_impl="conv", mask_token=True, drop_path_rate=0.0,
                        use_checkpoint=(0,), mlp_stash=False, mlp_bwd=mlp_bwd, **SWIN),
        text_bert=pb(num_hidden_layers=2), fusion=FusionConfig(bert=pb(num_hidden_layers=1),
                                                               **FUSION),
        vts_embed_dim=32)
    return jcfg, pcfg


def _port_model(pcfg, params):
    pm = CloverPretrain(pcfg, device="cpu")
    pm.mlm_ssl_T_head.drop = 0.0
    load_jax_params(pm, params)
    return pm


@pytest.fixture(scope="module")
def remat_run():
    """The JAX reference under the remat recipe (use_checkpoint=(0,),
    _STASH=False, NCEHeadForText's fixed dropout at 0): the weights, batch
    0's loss and gradients, and 2 steps of make_pretrain_train_step."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import clover_tpu.models as models
    import clover_tpu.models.bert as bert
    import clover_tpu.ops.mlp_block as mlp
    from clover_tpu.engine import TrainState as JTrainState
    from clover_tpu.engine import make_optimizer as jmake_optimizer
    from clover_tpu.engine.steps import make_pretrain_train_step as jmake_step
    from clover_tpu.losses.objectives import pretrain_losses as jpretrain_losses
    from clover_tpu.losses.objectives import total_loss as jtotal_loss

    jm = types.SimpleNamespace(jax=jax, jnp=jnp, models=models, bert=bert)
    mp = pytest.MonkeyPatch()
    mp.setattr(models.pretrain, "NCEHeadForText",
               functools.partial(models.heads.NCEHeadForText, dropout_ratio=0.0))
    mp.setattr(mlp, "_STASH", False)
    key = jax.random.PRNGKey(0)
    try:
        jcfg, _ = _remat_configs(jm)
        model = models.CloverPretrain(jcfg, dtype=jnp.float32)
        batches = [_pretrain_batch(s) for s in range(2)]
        params = _init(jm, model, batches[0], train=False)["params"]

        def loss_fn(p, batch):
            out = model.apply({"params": p}, batch, train=True, rngs={"dropout": key})
            return jtotal_loss(jpretrain_losses(out, batch["mlm_label"]))

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batches[0])
        tx, _ = jmake_optimizer(params, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
        state = JTrainState.create(params, tx)
        step = jax.jit(jmake_step(model, jit=False, grad_clip_norm=CLIP))
        history = []
        for b in batches:
            state, metrics = step(state, b, key)
            history.append(jax.device_get((metrics, state.params, state.opt_state)))
    finally:
        mp.undo()
    return dict(jm=jm, params=jax.device_get(params), batches=batches, loss=float(loss),
                grads=jax.device_get(grads), history=history)


@pytest.mark.parametrize("mlp_bwd", ["xla", "onepass"])
def test_remat_pretrain_gradients_match_jax(remat_run, mlp_bwd, monkeypatch):
    """forward_train + the pretrain losses + backward of the port's remat
    model (stage 0 through remat, the stash off: every Swin MLP half through
    FusedLnMlpResidualFn's recompute route) against jax.value_and_grad of the
    JAX remat model: loss and gradient norm within 1e-5 relative, each
    gradient within 2e-4 * max|its JAX gradient| + 1e-7 (test_torch_pretrain's
    limits; the attention key biases, zero in exact arithmetic, below 1e-6);
    stage 0's 2 blocks and no others go through remat."""
    from test_torch_train import _key_bias

    import clover_tpu_torch.models.swin3d as pswin

    seen = []
    real = pswin.remat
    monkeypatch.setattr(pswin, "remat", lambda fn, *a, **kw: seen.append(a[0].shape)
                        or real(fn, *a, **kw))
    _, pcfg = _remat_configs(remat_run["jm"], mlp_bwd)
    pm = _port_model(pcfg, remat_run["params"]).train()
    batch = _torch_batch(remat_run["batches"][0])
    loss = total_loss(pretrain_losses(pm.forward_train(batch, torch.Generator()),
                                      batch["mlm_label"]))
    loss.backward()
    assert len(seen) == 2 and all(s[-1] == SWIN["embed_dim"] for s in seen)
    assert loss.item() == pytest.approx(remat_run["loss"], rel=1e-5)
    want = state_from_jax(remat_run["grads"])
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


def test_two_remat_pretrain_steps_match_jax(remat_run):
    """2 steps of make_pretrain_train_step (AdamW, warmup, clip at 1.0) on
    the port's remat model (K7's route) against the JAX remat step: every
    metric within 1e-4 relative, the parameters after 2 steps within 2e-5
    (the key biases within 3 lr)."""
    from clover_tpu_torch.engine import TrainState, make_optimizer, make_pretrain_train_step
    from test_torch_train import _assert_params_close

    history = remat_run["history"]
    _, pcfg = _remat_configs(remat_run["jm"], "onepass")
    pm = _port_model(pcfg, remat_run["params"])
    optimizer, schedule = make_optimizer(pm, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
    state = TrainState.create(pm, optimizer, schedule)
    step = make_pretrain_train_step(pm, grad_clip_norm=CLIP)
    for b, (want, _, _) in zip(remat_run["batches"], history):
        state, metrics = step(state, _torch_batch(b), torch.Generator().manual_seed(0))
        assert set(metrics) == set(want)
        for k in want:
            assert metrics[k].item() == pytest.approx(float(want[k]), rel=1e-4, abs=1e-7), k
    assert state.step == 2
    _assert_params_close(pm, history[-1][1], 2e-5, "after 2 steps")


def test_bridge_loads_the_remat_tree_and_its_moments(remat_run):
    """nn.remat keeps the stage_i_block_j names, so the JAX remat tree has
    the plain model's leaves: it loads strictly into the port's remat model
    (every leaf on one parameter, every parameter set), and the JAX state
    after step 1 (params and AdamW count / mu / nu) resumes there: step 2
    lands within 2e-5 of JAX's."""
    from clover_tpu_torch.engine import TrainState, make_optimizer, make_pretrain_train_step
    from clover_tpu_torch.models import opt_state_from_jax
    from test_torch_train import _assert_params_close

    params = remat_run["params"]
    assert {"stage_0_block_0", "stage_0_block_1", "stage_1_block_1"} <= set(params["backbone"])
    _, pcfg = _remat_configs(remat_run["jm"], "onepass")
    pm = _port_model(pcfg, params)
    assert len(state_from_jax(params)) == len(list(pm.parameters()))
    history = remat_run["history"]
    pm = _port_model(pcfg, history[0][1])
    optimizer, schedule = make_optimizer(pm, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
    assert opt_state_from_jax(history[0][2], pm, optimizer) == 1
    state = TrainState(pm, optimizer, schedule, step=1)
    make_pretrain_train_step(pm, grad_clip_norm=CLIP)(
        state, _torch_batch(remat_run["batches"][1]), torch.Generator())
    _assert_params_close(pm, history[1][1], 2e-5, "resumed step 2")


def test_remat_config_passes_the_route_to_every_block():
    """Every Swin block of a remat config carries mlp_stash / mlp_bwd from the
    config, and a dataclasses.replace of the config keeps its checks."""
    cfg = SwinConfig(mask_token=True, embed_impl="conv", use_checkpoint=(0, 1),
                     mlp_stash=False, mlp_bwd="onepass", **SWIN)
    from clover_tpu_torch.models.swin3d import SwinTransformer3D

    sw = SwinTransformer3D(cfg)
    blocks = [m for n, m in sw.named_children() if "_block_" in n]
    assert len(blocks) == 4 and all(b.mlp_stash is False and b.mlp_bwd == "onepass"
                                    for b in blocks)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, mlp_bwd="pair")


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_case(dev, rows, C, seed):
    """x and g (rows, C) bf16, fp32 Swin MLP weights with bf16-exact values,
    a keep-0.9 row scale, on the card."""
    rng = np.random.default_rng(seed)
    H = 4 * C
    x = torch.from_numpy(rng.normal(size=(rows, C)).astype(np.float32)).to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(rows, C)).astype(np.float32)).to(dev, torch.bfloat16)
    w = [rng.normal(size=s).astype(np.float32) * f for s, f in
         [(C, 0.1), (C, 0.1), ((H, C), C ** -0.5), (H, 0.1), ((C, H), H ** -0.5), (C, 0.1)]]
    w[0] += 1.0
    w = [torch.from_numpy(t).to(dev).bfloat16().float() for t in w]
    rs = torch.from_numpy(((rng.random(rows) < 0.9) / 0.9).astype(np.float32)).to(dev)
    return x, w, rs, g


def _check_against_plain(got, x, w, rs, gelu, g):
    """dx within K2's limits of the plain version; each fp32 output's error
    against the plain version run in fp32 at most 1.5x the bf16 plain
    version's plus 1e-6 of max|reference|, its cosine with it >= 0.9999
    (chip_smoke.py's limits)."""
    plain = ops.ln_mlp_residual_bwd_recompute(x, *w, rs, 1e-5, gelu, g)
    ref = ops.ln_mlp_residual_bwd_recompute(x.float(), *w, rs, 1e-5, gelu, g.float())
    err = (got[0].float() - plain[0].float()).abs().max().item()
    assert err <= 2e-2 + 2e-2 * plain[0].float().abs().max().item(), ("dx", err)
    for name, k, p, r in list(zip(NAMES, got, plain, ref))[1:]:
        if r is None:
            assert k is None and p is None, name
            continue
        e_k, e_p = (k - r).abs().max().item(), (p - r).abs().max().item()
        assert e_k <= 1.5 * e_p + 1e-6 * r.abs().max().item(), (name, e_k, e_p)
        cos = torch.nn.functional.cosine_similarity(k.flatten(), p.flatten(), 0).item()
        assert cos >= 0.9999, (name, cos)


@pytest.mark.gpu
@pytest.mark.parametrize("route,gelu", [("onepass", "tanh"), ("onepass", "erf"), ("pair", "erf")])
@pytest.mark.parametrize("rows,C", [(1000, 128), (777, 256), (333, 512), (97, 1024)])
def test_recompute_kernels_on_card(cuda, route, gelu, rows, C):
    """K7 and K8 at each Swin width, row counts that leave a ragged
    row block, against the plain version; one launch each counted; two
    launches bitwise equal (no atomics: the slices and partials are summed
    in a fixed order)."""
    x, w, rs, g = _card_case(cuda, rows, C, rows + C)
    fn = ops.ln_mlp_residual_bwd_onepass if route == "onepass" else ops.ln_mlp_residual_bwd_pair
    counters = [fn]
    before = [c.launches for c in counters]
    got = fn(x, *w, rs, 1e-5, gelu, g)
    again = fn(x, *w, rs, 1e-5, gelu, g)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 2 for b in before]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _check_against_plain(got, x, w, rs, gelu, g)
    no_rs = fn(x, *w, None, 1e-5, gelu, g)
    assert no_rs[7] is None
    _check_against_plain(no_rs, x, w, None, gelu, g)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,C", [(200704, 128), (50176, 256), (12544, 512), (3136, 1024)])
def test_pair_at_p8e_shapes_on_card(cuda, rows, C):
    """K8 at the (rows, C) of P8E's four Swin stages (16 clips of 8 frames),
    with a row scale: one launch each counted, two launches bitwise equal,
    every output within the limits of test_recompute_kernels_on_card."""
    x, w, rs, g = _card_case(cuda, rows, C, C)
    before = ops.ln_mlp_residual_bwd_pair.launches
    got = ops.ln_mlp_residual_bwd_pair(x, *w, rs, 1e-5, "erf", g)
    again = ops.ln_mlp_residual_bwd_pair(x, *w, rs, 1e-5, "erf", g)
    torch.cuda.synchronize()
    assert ops.ln_mlp_residual_bwd_pair.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _check_against_plain(got, x, w, rs, "erf", g)


_UNCACHED = r"""
import sys
import torch
from clover_tpu_torch import ops

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)

def randn(*shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

f32 = torch.float32
rows, C, H = 3000, 256, 1024
x, g = randn(rows, C), randn(rows, C)
w = (1 + randn(C, std=0.1, dtype=f32), randn(C, std=0.1, dtype=f32),
     randn(H, C, std=C ** -0.5, dtype=f32), randn(H, std=0.1, dtype=f32),
     randn(C, H, std=H ** -0.5, dtype=f32), randn(C, std=0.1, dtype=f32))
rs = (torch.rand(rows, generator=gen, device=dev) < 0.9).float() / 0.9
ref = ops.ln_mlp_residual_bwd_recompute(x, *w, rs, 1e-5, "erf", g)
for fn in (ops.ln_mlp_residual_bwd_onepass, ops.ln_mlp_residual_bwd_pair):
    got = fn(x, *w, rs, 1e-5, "erf", g)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        cos = torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(), 0)
        if not cos.item() >= 0.9999:
            sys.exit(f"{fn.__name__}: cosine {cos.item()}")
"""


@pytest.mark.gpu
def test_recompute_kernels_read_no_freed_buffer(cuda):
    """K7 and the pair with PyTorch's caching allocator off and fp32 weights
    (so the wrappers make bf16 copies and transposes), as
    test_kernels_read_no_freed_buffer checks K2 and K3: a buffer let go
    before its launch would be read after it was freed."""
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    proc = subprocess.run([sys.executable, "-c", _UNCACHED],
                          cwd=Path(__file__).resolve().parent.parent, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.gpu
@pytest.mark.parametrize("route,gelu", [("xla", "tanh"), ("onepass", "tanh"), ("pair", "erf")])
def test_stash_off_fn_on_card(cuda, route, gelu):
    """FusedLnMlpResidualFn with the stash off on each route, kernels (K2's
    training form; the route's backward) against plain (the plain forward
    and recompute): the forward within K2's limits, every gradient finite
    and within cosine 0.9999 of the plain one; K2's training form and the
    route's kernels each launched once."""
    x, w, rs, g = _card_case(cuda, 2000, 256, 5)
    counters = {"xla": [], "onepass": [ops.ln_mlp_residual_bwd_onepass],
                "pair": [ops.ln_mlp_residual_bwd_pair]}[route]
    counters = [ops.fused_ln_mlp_residual_train] + counters
    results = []
    for kernels in (True, False):
        before = [c.launches for c in counters]
        leaves = [x.detach().clone().requires_grad_()] + [t.clone().requires_grad_() for t in w]
        out = ops.FusedLnMlpResidualFn.apply(*leaves, rs, 1e-5, gelu, kernels, False, route)
        grads = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == [int(kernels)] * len(counters)
        results.append((out.detach(), grads))
    (k_out, k_grads), (p_out, p_grads) = results
    err = (k_out.float() - p_out.float()).abs().max().item()
    assert err <= 2e-2 + 2e-2 * p_out.float().abs().max().item()
    for name, a, b in zip(NAMES, k_grads, p_grads):
        assert bool(torch.isfinite(a).all()), name
        cos = torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(), 0)
        assert cos.item() >= 0.9999, (name, cos.item())
