"""The port's RGB-frame paths held against the JAX package on the CPU, in fp32.

A tiny retrieval model (Swin with the raw-clip 'conv' embed, embed dim 32,
head dim 32, depths 2/2, a shifted block in stage 0; a 1-layer BERT of
width 32), one set of seeded weights through the bridge:

- the retrieval eval from uint8 RGB frames: ``run_retrieval_eval`` on the
  port (``eval_preprocess`` on the device, the lazy bias cache built at the
  patch embed's token dims) against the JAX loop, through both branches of
  ``eval_preprocess`` (frames at the output size, and a centre crop):
  embeddings within 1e-4 absolute and relative, the same R@K;
- the retrieval finetune from uint8 frames: ``to_model_batch`` (seeded
  crop boxes and flips through ``preprocess_clips``) and 3 steps of
  ``make_retrieval_train_step`` under a freeze mask
  (``freeze_mask_from_cfg``) against ``tools/train.py``'s recipe and the
  JAX step with ``make_optimizer(freeze_mask=...)``, jitted once.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clover_tpu.engine import TrainState as JTrainState
from clover_tpu.engine import make_optimizer as jmake_optimizer
from clover_tpu.engine.eval_loop import run_retrieval_eval as jrun_retrieval_eval
from clover_tpu.engine.optim import freeze_mask_from_cfg as jfreeze_mask_from_cfg
from clover_tpu.engine.steps import make_embed_eval_step as jmake_eval_step
from clover_tpu.engine.steps import make_retrieval_train_step as jmake_train_step
from clover_tpu.models import BertConfig as JBertConfig
from clover_tpu.models import CloverFinetune as JCloverFinetune
from clover_tpu.models import FinetuneConfig as JFinetuneConfig
from clover_tpu.models import SwinConfig as JSwinConfig
from clover_tpu.models.swin3d import bias_cache_builder
from clover_tpu.ops.preprocess import preprocess_clips as jpreprocess_clips
from clover_tpu.ops.preprocess import random_resized_crop_params
from clover_tpu_torch.engine import (TrainState, freeze_mask_from_cfg, make_embed_eval_step,
                                     make_optimizer, make_retrieval_train_step,
                                     run_retrieval_eval, to_model_batch)
from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig, SwinConfig,
                                     load_jax_params, opt_state_from_jax, state_from_jax,
                                     swin_bias_cache)
from test_torch_bridge import random_jax_params

SWIN = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), drop_path_rate=0.0)
BERT = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=1, intermediate_size=64,
            hidden_dropout=0.0, attention_dropout=0.0)
B, T, OUT, L = 2, 4, 56, 8
LR, TOTAL, WARMUP, CLIP = 1e-3, 20, 2, 1.0
FREEZE = (("backbone.patch_embed", "text_backbone.embeddings"), ("position_embeddings",))
TOL = dict(atol=1e-4, rtol=1e-4)


def tiny_rgb_models():
    jcfg = JFinetuneConfig(swin=JSwinConfig(embed_impl="conv", **SWIN),
                           text_bert=JBertConfig(**BERT), task="retrieval")
    pcfg = FinetuneConfig(swin=SwinConfig(embed_impl="conv", **SWIN), text_bert=BertConfig(**BERT))
    return JCloverFinetune(jcfg, dtype=jnp.float32), CloverFinetune(pcfg, device="cpu")


def _text(rng, n):
    tok = rng.integers(1000, 30522, size=(n, L)).astype(np.int32)
    mask = np.ones((n, L), np.int32)
    mask[0, 5:] = 0
    return tok, mask


def _eval_batches(size, seed=1):
    """Two loader batches of B clips (B, 1, T, size, size, 3) uint8."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(2):
        tok, mask = _text(rng, B)
        out.append({"imgs": rng.integers(0, 256, (B, 1, T, size, size, 3), dtype=np.uint8),
                    "token_ids": tok, "input_mask": mask, "index": np.arange(B) + B * i,
                    "video_index": np.arange(B) + B * i})
    return out


def _host_train_batch(seed):
    """A loader batch for the finetune: (B, 1, T, 64, 64, 3) uint8 canonical
    squares, seeded random-resized-crop boxes and flips, captions."""
    rng = np.random.default_rng(100 + seed)
    tok, mask = _text(rng, B)
    return {"imgs": rng.integers(0, 256, (B, 1, T, 64, 64, 3), dtype=np.uint8),
            "crop_boxes": np.stack([random_resized_crop_params(rng, 64) for _ in range(B)]),
            "flip": rng.random(B) < 0.5, "token_ids": tok, "input_mask": mask}


def _jax_model_batch(host):
    """tools/train.py's to_model_batch on the JAX side (fp32)."""
    imgs = jpreprocess_clips(jnp.asarray(host["imgs"].reshape((-1,) + host["imgs"].shape[2:])),
                             jnp.asarray(host["crop_boxes"]), jnp.asarray(host["flip"]),
                             out_size=OUT, dtype=jnp.float32)
    return {"imgs": imgs.reshape((B, 1) + imgs.shape[1:]),
            "token_ids": jnp.asarray(host["token_ids"]),
            "input_mask": jnp.asarray(host["input_mask"])}


@pytest.fixture(scope="module")
def rgb():
    jm, _ = tiny_rgb_models()
    imgs = np.zeros((B, 1, T, OUT, OUT, 3), np.float32)
    params = random_jax_params(jm, imgs, *_text(np.random.default_rng(0), B))["params"]
    return types.SimpleNamespace(jm=jm, params=jax.device_get(params),
                                 jeval=jmake_eval_step(jm))


def _port(params):
    _, pm = tiny_rgb_models()
    load_jax_params(pm, params)
    return pm


def _capturing(step, to_numpy):
    seen = []

    def run(*args):
        v, t = step(*args)
        seen.append((to_numpy(v), to_numpy(t)))
        return v, t

    return run, seen


@pytest.mark.parametrize("size", [OUT, 64])
def test_rgb_retrieval_eval_matches_the_jax_loop(rgb, size):
    """RGB batches through both loops with a lazy bias cache: per-batch
    embeddings within 1e-4 (observed 2.9e-6), identical R@K. size == OUT
    takes eval_preprocess's normalize-only branch, 64 its centre crop."""
    dataset = types.SimpleNamespace(text_video_ids=[[i] for i in range(2 * B)])
    jstep, jseen = _capturing(rgb.jeval, np.asarray)
    want = jrun_retrieval_eval(jstep, rgb.params, dataset, iter(_eval_batches(size)),
                               out_size=OUT, bias_cache=bias_cache_builder(rgb.jm.config.swin))
    pm = _port(rgb.params).eval()
    built = []

    def cache(model, dims):
        built.append(tuple(dims))
        return swin_bias_cache(model.backbone, model.config.swin, dims)

    pstep, pseen = _capturing(make_embed_eval_step(pm), lambda a: a.numpy())
    got = run_retrieval_eval(pstep, pm, dataset, iter(_eval_batches(size)), bias_cache=cache,
                             out_size=OUT)
    assert built == [(T // 2, OUT // 4, OUT // 4)]      # the embed's token dims, once
    for (gv, gt), (wv, wt) in zip(pseen, jseen):
        np.testing.assert_allclose(gv, wv, **TOL)
        np.testing.assert_allclose(gt, wt, **TOL)
    assert got == want


@pytest.fixture(scope="module")
def finetune(rgb):
    """3 JAX steps from uint8 frames under the freeze mask: (metrics, params,
    opt_state) after each, numpy."""
    params = rgb.params
    tx, _ = jmake_optimizer(params, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP,
                            freeze_mask=jfreeze_mask_from_cfg(params, *FREEZE))
    state = JTrainState.create(params, tx)
    step = jax.jit(jmake_train_step(rgb.jm, jit=False, grad_clip_norm=CLIP))
    history = []
    for i in range(3):
        state, metrics = step(state, _jax_model_batch(_host_train_batch(i)),
                              jax.random.PRNGKey(0))
        history.append(jax.device_get((metrics, state.params, state.opt_state)))
    return history


def _port_steps(params, history, first=0, opt_state=None):
    """The port's steps from ``first`` on (resumed from ``opt_state``, the JAX
    state before step ``first``): -> (model, per-step metrics)."""
    pm = _port(params)
    optimizer, schedule = make_optimizer(pm, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP,
                                         freeze_mask=freeze_mask_from_cfg(pm, *FREEZE))
    count = 0 if opt_state is None else opt_state_from_jax(opt_state, pm, optimizer)
    assert count == first
    state = TrainState(pm, optimizer, schedule, step=count)
    step = make_retrieval_train_step(pm, grad_clip_norm=CLIP)
    got = []
    for i in range(first, len(history)):
        batch = to_model_batch(_host_train_batch(i), OUT, torch.float32, "cpu")
        state, metrics = step(state, batch, torch.Generator().manual_seed(0))
        got.append({k: v.item() for k, v in metrics.items()})
    return pm, got


@pytest.fixture(scope="module")
def port_run(rgb, finetune):
    """The port's 3 steps from the same weights and host batches."""
    return _port_steps(rgb.params, finetune)


def _key_bias(name, n):
    """The attention key-bias entries of ``name``: their gradient is zero in
    exact arithmetic (softmax does not see q.b_k), so Adam turns fp32 noise
    into updates of order lr on both sides."""
    mask = np.zeros(n, bool)
    if name.endswith("attention.key.bias"):
        mask[:] = True
    elif name.endswith("attn.qkv.bias"):
        mask[n // 3:2 * n // 3] = True
    return mask


def _assert_params_close(pm, jax_params, atol):
    want = state_from_jax(jax_params)
    for name, p in pm.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name]).reshape(-1)
        noise = _key_bias(name, diff.size)
        assert diff[~noise].max(initial=0.0) <= atol, (name, diff[~noise].max())
        assert diff[noise].max(initial=0.0) <= 3 * LR, name


def test_rgb_finetune_step_matches_jax(port_run, finetune):
    """Step 1 from uint8 frames: loss and grad_norm within 2e-5 relative of
    the JAX step's, steps 2 and 3 too (observed at most 6.7e-7 and 2.8e-6:
    the two preprocess_clips differ by 3e-5 on inputs of magnitude ~2), and
    the clip fires."""
    _, got = port_run
    assert max(h[0]["grad_norm"] for h in finetune) > CLIP
    for g, (want, _, _) in zip(got, finetune):
        for k in ("loss", "grad_norm"):
            assert g[k] == pytest.approx(float(want[k]), rel=2e-5), k


def test_frozen_parameters_stay_and_the_rest_follow_jax(rgb, finetune, port_run):
    """After 3 steps under the freeze mask: every frozen parameter bitwise its
    start on both sides (the mask freezes the same leaves: 'position_embeddings'
    is exempt), every other within 2e-5 of JAX's (observed 1.0e-5; the attention
    key biases held to 3 lr, see _key_bias). grad_norm counts the frozen
    gradients on both sides (test above)."""
    pm, _ = port_run
    start, end = state_from_jax(rgb.params), state_from_jax(finetune[-1][1])
    mask = freeze_mask_from_cfg(pm, *FREEZE)
    frozen = [n for n, trainable in mask.items() if not trainable]
    assert "text_backbone.embeddings.word_embeddings.weight" in frozen
    assert "text_backbone.embeddings.position_embeddings.weight" not in frozen
    assert any(n.startswith("backbone.patch_embed") for n in frozen)
    params = dict(pm.named_parameters())
    for n in frozen:
        np.testing.assert_array_equal(params[n].detach().numpy(), start[n])
        np.testing.assert_array_equal(end[n], start[n])
    _assert_params_close(pm, finetune[-1][1], 2e-5)


def test_multi_transform_opt_state_resumes_a_jax_run(rgb, finetune):
    """The JAX state after 2 steps under multi_transform (AdamW under
    inner_states['train'], the frozen leaves masked) carried into the port;
    its step 3 against JAX's within 2e-5, as above."""
    pm, got = _port_steps(finetune[1][1], finetune, first=2, opt_state=finetune[1][2])
    assert got[0]["grad_norm"] == pytest.approx(float(finetune[2][0]["grad_norm"]), rel=2e-5)
    _assert_params_close(pm, finetune[2][1], 2e-5)
