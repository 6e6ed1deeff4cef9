"""The port's 32-frame retrieval eval held against the JAX package on the CPU.

The tiny configuration of test_torch_bridge (Swin embed dim 64, depths
2/2/2/2, heads 2/4/8/16, 2 BERT layers) on B=2 clips of 32 frames at 56^2:
token dims (16, 14, 14), so stages 0-1 run the 8x7x7 window (N=392, time
shift in both, space shift in stage 0) through the fused attention
half-block, and stages 2-3 clamp their windows (N=128, 32) and run the
unfused path. The JAX ``CloverFinetune`` runs with
``attention_impl='pallas_flat'`` and ``attn_block._FORCE_PALLAS`` (the fused
half-block's Pallas kernel in interpret mode), in fp32, one set of seeded
weights through the bridge. Tolerance 1e-4 absolute and relative, as
test_torch_slice.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clover_tpu.ops.attn_block as AB
from clover_tpu.engine.eval_loop import run_retrieval_eval as jax_run_retrieval_eval
from clover_tpu.models import CloverFinetune as JCloverFinetune
from clover_tpu.models import FinetuneConfig as JFinetuneConfig
from clover_tpu.models import SwinConfig as JSwinConfig
from clover_tpu.models import BertConfig as JBertConfig
from clover_tpu_torch.engine import make_embed_eval_step, run_retrieval_eval
from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig, SwinConfig,
                                     load_jax_params, swin_bias_cache)
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.ops.preprocess import space_to_depth_host
from test_torch_bridge import BERT, SWIN, random_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
B, T, S, L = 2, 32, 56, 8


def _inputs():
    rng = np.random.default_rng(32)
    frames = rng.integers(0, 256, size=(B, T, S, S, 3), dtype=np.uint8)
    tok = rng.integers(1000, 30522, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, 6:] = 0
    return space_to_depth_host(frames)[:, None], tok, mask


@pytest.fixture(scope="module")
def slice32(request):
    jm = JCloverFinetune(JFinetuneConfig(
        swin=JSwinConfig(embed_impl="host_s2d", attention_impl="pallas_flat", **SWIN),
        text_bert=JBertConfig(**BERT), task="retrieval"), dtype=jnp.float32)
    pm = CloverFinetune(FinetuneConfig(swin=SwinConfig(**SWIN), text_bert=BertConfig(**BERT)),
                        device="cpu")
    imgs, tok, mask = _inputs()
    params = random_jax_params(jm, imgs, tok, mask)
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    mp.setattr(AB, "_FORCE_PALLAS", True)
    calls = []
    real = AB._forward
    mp.setattr(AB, "_forward", lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, method="forward_test"))(
        params, jnp.asarray(imgs), jnp.asarray(tok), jnp.asarray(mask))
    ref = tuple(np.asarray(r, np.float32) for r in ref)
    load_jax_params(pm, params)
    pm.eval()
    inputs = tuple(torch.from_numpy(a) for a in (imgs, tok, mask))
    return types.SimpleNamespace(pm=pm, inputs=inputs, ref=ref, jax_fused_calls=calls)


def test_jax_reference_runs_the_fused_kernel_at_stages_0_and_1(slice32):
    """The reference itself took the fused half-block in stages 0-1 only:
    four blocks of (Bn, 392, C)."""
    assert [tuple(s[1:]) for s in slice32.jax_fused_calls] == [(392, 64)] * 2 + [(392, 128)] * 2


@pytest.mark.parametrize("cached_bias", [False, True])
def test_forward_test_matches_jax_at_32_frames(slice32, cached_bias, monkeypatch):
    imgs, tok, mask = slice32.inputs
    pm = slice32.pm
    n = []
    real = pswin.library.k6_window_attn_block    # the eval route's K6 op
    monkeypatch.setattr(pswin.library, "k6_window_attn_block",
                        lambda *a, **k: n.append(a[11]) or real(*a, **k))
    cache = swin_bias_cache(pm.backbone, pm.config.swin, imgs.shape[2:5]) if cached_bias else None
    with torch.inference_mode():
        v, t = pm.forward_test(imgs, tok, mask, cache)
    assert n == [392] * 4                             # the port's fused blocks, stages 0-1
    np.testing.assert_allclose(v.numpy(), slice32.ref[0], **TOL)
    np.testing.assert_allclose(t.numpy(), slice32.ref[1], **TOL)


def test_bias_cache_at_32_frame_token_dims(slice32):
    """swin_bias_cache at (16, 14, 14): the 8x7x7 window's (nH, 392, 392)
    bias in stages 0-1, the clamped windows' after them."""
    pm = slice32.pm
    cache = swin_bias_cache(pm.backbone, pm.config.swin, (16, 14, 14))
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    assert shapes["stage_0_block_1"] == (2, 392, 392)
    assert shapes["stage_1_block_0"] == (4, 392, 392)
    assert shapes["stage_2_block_1"] == (8, 128, 128)
    assert shapes["stage_3_block_0"] == (16, 32, 32)


def test_eval_loop_at_32_frames_matches_the_jax_loop(slice32):
    """make_embed_eval_step + run_retrieval_eval on the 32-frame clips, one
    clip per loader batch in reverse order, against the JAX loop fed the
    JAX model's embeddings of the same batches."""
    imgs, tok, mask = slice32.inputs
    pm = slice32.pm
    batches = [{"imgs": imgs[i:i + 1].numpy(), "token_ids": tok[i:i + 1].numpy(),
                "input_mask": mask[i:i + 1].numpy(), "index": np.array([i]),
                "video_index": np.array([i])} for i in (1, 0)]
    dataset = types.SimpleNamespace(text_video_ids=[[0], [1]])
    got = run_retrieval_eval(make_embed_eval_step(pm), pm, dataset, iter(batches),
                             bias_cache=lambda m, dims: swin_bias_cache(m.backbone,
                                                                        m.config.swin, dims))
    jax_embs = iter([(slice32.ref[0][i:i + 1], slice32.ref[1][i:i + 1]) for i in (1, 0)])
    want = jax_run_retrieval_eval(lambda *a: next(jax_embs), None, dataset, iter(batches))
    assert got == want
