"""The port's retrieval-eval slice and finetune step under the new Swin
options held against the JAX package on the CPU, in fp32.

- (d) the tiny retrieval-eval slice (test_torch_bridge's configuration)
  under 'pallas' and 'pallas_fused' against the JAX ``forward_test``,
  test_torch_slice's tolerance.
- (e) one tiny finetune train step on the spatial path ('pallas_fused',
  ``window_resident=False``) and one at 32 frames under ``long_attn='v7'``
  against ``jax.value_and_grad`` of the JAX retrieval loss: loss and
  gradient norm within 1e-5 relative, each gradient within 2e-4 of its
  max, as test_torch_train. DropPath and dropouts at 0, as in every
  port-vs-JAX train test (the two packages' dropout streams differ).

The backbone under each option is in test_torch_spatial_model.py.
"""

import numpy as np
import pytest
import torch

from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig, SwinConfig,
                                     load_jax_params, state_from_jax)
from clover_tpu_torch.ops import window_attention as pwa
from test_torch_spatial_model import TOL, _counting, jx  # noqa: F401  (jx: the fixture)


# ----------------------------------------------------------- (d) the slice

@pytest.mark.parametrize("impl", ["pallas", "pallas_fused"])
def test_eval_slice_matches_jax(impl, jx):
    """forward_test of the tiny retrieval configuration under each kernel
    route against the JAX forward_test (test_torch_slice's 1e-4)."""
    from clover_tpu.models import BertConfig as JBertConfig
    from clover_tpu.models import CloverFinetune as JCloverFinetune
    from clover_tpu.models import FinetuneConfig as JFinetuneConfig
    from clover_tpu.models import SwinConfig as JSwinConfig
    from test_torch_bridge import BERT, SWIN, random_jax_params, tiny_inputs

    jm = JCloverFinetune(JFinetuneConfig(
        swin=JSwinConfig(embed_impl="host_s2d", attention_impl=impl, **SWIN),
        text_bert=JBertConfig(**BERT), task="retrieval"), dtype=jx.jnp.float32)
    pm = CloverFinetune(FinetuneConfig(swin=SwinConfig(attention_impl=impl, **SWIN),
                                       text_bert=BertConfig(**BERT)), device="cpu").eval()
    imgs, tok, mask = tiny_inputs()
    params = random_jax_params(jm, imgs, tok, mask)
    ref = jx.jax.jit(lambda p, *a: jm.apply(p, *a, method="forward_test"))(
        params, *(jx.jnp.asarray(a) for a in (imgs, tok, mask)))
    load_jax_params(pm, params)
    with torch.inference_mode():
        v, t = pm.forward_test(*(torch.from_numpy(a) for a in (imgs, tok, mask)))
    np.testing.assert_allclose(v.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(ref[1]), **TOL)


# ------------------------------------------------------- (e) train steps

def _train_step_matches_jax(jx, batch, swin_fields, jax_swin_fields):
    """The port's forward_train + retrieval loss + backward against
    jax.value_and_grad on the same bridged weights and batch."""
    from clover_tpu.losses.objectives import retrieval_loss as jretrieval_loss
    from clover_tpu.models import BertConfig as JBertConfig
    from clover_tpu.models import CloverFinetune as JCloverFinetune
    from clover_tpu.models import FinetuneConfig as JFinetuneConfig
    from clover_tpu.models import SwinConfig as JSwinConfig
    from clover_tpu_torch.losses import retrieval_loss, total_loss
    from test_torch_bridge import BERT, SWIN, random_jax_params
    from test_torch_train32 import _torch_batch

    nodrop = dict(hidden_dropout=0.0, attention_dropout=0.0, **BERT)
    jm = JCloverFinetune(JFinetuneConfig(
        swin=JSwinConfig(embed_impl="host_s2d", drop_path_rate=0.0, **SWIN, **jax_swin_fields),
        text_bert=JBertConfig(**nodrop), task="retrieval"), dtype=jx.jnp.float32)
    params = random_jax_params(jm, batch["imgs"], batch["token_ids"],
                               batch["input_mask"])["params"]
    key = jx.jax.random.PRNGKey(0)

    def loss_fn(p, b):
        v, t = jm.apply({"params": p}, b, train=True, rngs={"dropout": key})
        return jretrieval_loss(v, t, temperature=0.05, cos_sim=True)["retrieval_nce_loss"]

    loss, grads = jx.jax.jit(jx.jax.value_and_grad(loss_fn))(params, batch)
    pm = CloverFinetune(FinetuneConfig(swin=SwinConfig(drop_path_rate=0.0, **SWIN, **swin_fields),
                                       text_bert=BertConfig(**nodrop)), device="cpu").train()
    load_jax_params(pm, params)
    v, t = pm.forward_train(_torch_batch(batch), torch.Generator())
    got = total_loss(retrieval_loss(v, t, temperature=0.05, cos_sim=True))
    got.backward()
    assert got.item() == pytest.approx(float(loss), rel=1e-5)
    want = state_from_jax(jx.jax.device_get(grads))
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want.values()))
    got_norm = np.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in pm.parameters()))
    assert got_norm == pytest.approx(gnorm, rel=1e-5)
    for name, p in pm.named_parameters():
        w = want[name]
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 2e-4 * np.abs(w).max() + 1e-7, f"{name}: {err} vs max {np.abs(w).max()}"


def test_spatial_train_step_matches_jax(jx, monkeypatch):
    """Every Swin block on the spatial path through SpatialWindowAttentionFn
    (K10's route; its backward _spatial_bwd's math) against the JAX step
    with attention_impl='pallas_fused' (the Pallas kernel in interpret
    mode, its XLA backward)."""
    from test_torch_bridge import tiny_inputs

    calls = []
    _counting(monkeypatch, pwa, "spatial_window_attention", calls)
    imgs, tok, mask = tiny_inputs(1)
    batch = {"imgs": imgs, "token_ids": tok, "input_mask": mask}
    fields = dict(attention_impl="pallas_fused", window_resident=False)
    _train_step_matches_jax(jx, batch, fields, fields)
    assert len(calls) == 8


def test_long_attn_train_step_matches_jax(jx, monkeypatch):
    """The tiny 32-frame step (token dims (16, 14, 14): stages 0-1 at N=392)
    with long_attn='v7' -- WindowAttentionFn's key-tiled forward and its
    flat backward -- against the JAX step on the flat route with
    CLOVER_WA_LONG=v7 at N=392 (the all-heads and head-group blocks refused
    there, the fused half-block off, the additive mask, the XLA backward of
    the flat route; in fp32 the same function as the port's K5 math)."""
    from test_torch_train32 import _batch32

    wa, swin = jx.wa, jx.swin
    monkeypatch.setattr(swin, "_FUSED_ATTN_MODE", "0")
    monkeypatch.setattr(wa, "_LONG_IMPL", "v7")
    monkeypatch.setattr(wa, "_MASK_LANES", False)
    monkeypatch.setattr(wa, "_BWD_KERNEL", False)
    real_pick, real_grouped = wa._pick_window_block_flat, wa._forward_flat_grouped
    monkeypatch.setattr(wa, "_pick_window_block_flat",
                        lambda Bn, nH, N, *a: 0 if N >= 384 else real_pick(Bn, nH, N, *a))
    monkeypatch.setattr(wa, "_forward_flat_grouped",
                        lambda qkv, *a, **k: None if qkv.shape[1] >= 384
                        else real_grouped(qkv, *a, **k))
    jcalls, pcalls = [], []
    _counting(monkeypatch, wa, "_forward_flat_flash", jcalls)
    _counting(monkeypatch, pwa, "window_attention_flat_flash_plain", pcalls)
    _train_step_matches_jax(jx, _batch32(0), dict(fused_attn="off", long_attn="v7"),
                            dict(attention_impl="pallas_flat"))
    assert jcalls and len(pcalls) == 4
