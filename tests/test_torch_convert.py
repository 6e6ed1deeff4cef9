"""The port's checkpoint converters (``clover_tpu_torch/models/convert.py``)
and convert entry (``clover_tpu_torch/tools/convert_checkpoint.py``) held
against the JAX package's (``clover_tpu/models/convert.py``) on the CPU.

- Each converter's output is **equal** (same names, bitwise fp32 values) to
  ``bridge.state_from_jax`` of the JAX converter's tree, on seeded synthetic
  state dicts in the published key schemas (the dress rehearsal's, at small
  widths): a Video-Swin 3D dict with downsamples (under ``backbone.`` and
  bare), the SimMIM ``mask_token``, the strided-conv patch embed
  (``patch_equals_stride=False``), an image-Swin 2D dict inflated, HF BERT
  bare and ``bert.``-prefixed, the fusion tower's BERT part, the MLM head
  with its decoder tied and untied.
- A tiny model converted both ways gives the JAX embeddings (1e-4 absolute
  and relative: fp32 summation order over 4 Swin blocks and a BERT layer).
- The convert entry's checkpoint (from .pth files) is what the train
  entry's ``load_from`` merges: the backbone and the text backbone, equal to
  the converted tensors.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clover_tpu.models.convert as jconvert
from clover_tpu.models import BertConfig as JBertConfig
from clover_tpu.models import CloverFinetune as JCloverFinetune
from clover_tpu.models import FinetuneConfig as JFinetuneConfig
from clover_tpu.models import SwinConfig as JSwinConfig
from clover_tpu_torch import engine as pengine
from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig, SwinConfig,
                                     load_jax_params, state_from_jax)
from clover_tpu_torch.models import convert as pconvert
from clover_tpu_torch.tools import convert_checkpoint as pconvert_entry
from clover_tpu_torch.tools import dress_rehearsal as prehearsal
from clover_tpu_torch.tools import train as ptrain_entry
from test_torch_bridge import random_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN2D = dict(embed=32, depths=(2, 2), heads=(1, 2), window=7)
HF = dict(hidden=32, layers=2, intermediate=64, vocab=120, max_positions=40)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _swin2d(seed=0, **kw):
    return _np(prehearsal.synth_swin2d_state_dict(**{**SWIN2D, **kw}, seed=seed))


def _swin3d(seed=0):
    """A Video-Swin 3D dict: the 2D one inflated (2 frames a patch, window 8)."""
    return jconvert.inflate_swin2d(_swin2d(seed), 2, 8)


def _hf(seed=1):
    return _np(prehearsal.synth_hf_bert_state_dict(**HF, seed=seed))


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32 and want[k].dtype == np.float32, k
        assert np.array_equal(got[k], want[k]), k


SWIN_CASES = {
    "3d": lambda: (_swin3d(), {}),
    "3d under backbone.": lambda: ({f"backbone.{k}": v for k, v in _swin3d(2).items()}, {}),
    "mask_token": lambda: ({**_swin3d(3), "mask_token": np.random.default_rng(0).normal(
        size=(1, 32, 1, 1, 1)).astype(np.float32)}, {}),
    "conv patch embed": lambda: (_swin3d(4), {"patch_equals_stride": False}),
}


@pytest.mark.parametrize("case", sorted(SWIN_CASES))
def test_convert_swin3d_equals_the_jax_converter(case):
    sd, kw = SWIN_CASES[case]()
    got = pconvert.convert_swin3d(sd, (2, 2), **kw)
    _assert_equal(got, state_from_jax(jconvert.convert_swin3d(sd, (2, 2), **kw)))
    assert "stage_0_downsample.reduction.weight" in got
    assert ("mask_token" in got) == (case == "mask_token")


def test_inflate_swin2d_equals_the_jax_inflation():
    sd = _swin2d(5)
    got, want = pconvert.inflate_swin2d(sd, 2, 8), jconvert.inflate_swin2d(sd, 2, 8)
    assert got.keys() == want.keys() and not any("relative_position_index" in k for k in got)
    assert all(np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype for k in want)
    assert got["layers.0.blocks.0.attn.relative_position_bias_table"].shape == (15 * 169, 1)
    _assert_equal(pconvert.convert_swin3d(got, (2, 2)),
                  state_from_jax(jconvert.convert_swin3d(want, (2, 2))))


@pytest.mark.parametrize("prefixed", [False, True])
def test_convert_hf_bert_equals_the_jax_converter(prefixed):
    sd = _hf()
    if not prefixed:
        sd = {k[5:]: v for k, v in sd.items() if k.startswith("bert.")}
    kw = {"prefix": "bert"} if prefixed else {}
    _assert_equal(pconvert.convert_hf_bert(sd, 2, **kw),
                  state_from_jax(jconvert.convert_hf_bert(sd, 2, **kw)))


def test_convert_fusion_from_hf_equals_the_jax_converter():
    sd = _hf(2)
    _assert_equal(pconvert.convert_fusion_from_hf(sd, 1),
                  state_from_jax(jconvert.convert_fusion_from_hf(sd, 1)))


@pytest.mark.parametrize("tied", [True, False])
def test_convert_mlm_head_equals_the_jax_converter(tied):
    sd = _hf(3)
    if not tied:
        sd["cls.predictions.decoder.bias"] = np.random.default_rng(1).normal(
            size=HF["vocab"]).astype(np.float32)
    got = pconvert.convert_mlm_head(sd)
    _assert_equal(got, state_from_jax(jconvert.convert_mlm_head(sd)))
    bias = sd["cls.predictions.bias" if tied else "cls.predictions.decoder.bias"]
    assert np.array_equal(got["decoder.bias"], bias)


def test_converted_model_gives_the_jax_embeddings():
    """Swin 2D inflated and HF BERT through each package's converters into
    the same tiny retrieval model (its head from one seeded tree): the
    port's forward_video / forward_text equal the JAX ones within 1e-4."""
    swin = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), drop_path_rate=0.0)
    bert = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=1, intermediate_size=64,
                vocab_size=120, max_position_embeddings=40, hidden_dropout=0.0,
                attention_dropout=0.0)
    jm = JCloverFinetune(JFinetuneConfig(swin=JSwinConfig(embed_impl="conv", **swin),
                                         text_bert=JBertConfig(**bert), task="retrieval",
                                         vts_embed_dim=8), dtype=jnp.float32)
    pm = CloverFinetune(FinetuneConfig(swin=SwinConfig(embed_impl="conv", **swin),
                                       text_bert=BertConfig(**bert), vts_embed_dim=8),
                        device="cpu").eval()
    rng = np.random.default_rng(0)
    clips = rng.random((2, 1, 4, 56, 56, 3)).astype(np.float32)
    ids = rng.integers(1, 120, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    swin2d, hf = _swin2d(6), _hf(7)
    hf_bare = {k[5:]: v for k, v in hf.items() if k.startswith("bert.")}
    tree = random_jax_params(jm, clips, ids, mask)
    tree["params"]["backbone"] = jconvert.convert_swin3d(jconvert.inflate_swin2d(swin2d, 2, 8),
                                                         (2, 2))
    tree["params"]["text_backbone"] = jconvert.convert_hf_bert(hf_bare, 2)
    want_v = jax.jit(lambda p, x: jm.apply(p, x, method="forward_video"))(tree, clips)
    want_t = jax.jit(lambda p, i, m: jm.apply(p, i, m, method="forward_text"))(tree, ids, mask)

    load_jax_params(pm, tree)   # the head (and, overwritten next, the towers)
    converted = {**{f"backbone.{k}": v for k, v in pconvert.convert_swin3d(
        pconvert.inflate_swin2d(swin2d, 2, 8), (2, 2)).items()},
        **{f"text_backbone.{k}": v for k, v in pconvert.convert_hf_bert(hf_bare, 2).items()}}
    _, loaded, _ = pengine.merge_pretrained_params(
        pm, {k: torch.from_numpy(v) for k, v in converted.items()})
    assert loaded == ["backbone", "text_backbone"]
    with torch.inference_mode():
        got_v = pm.forward_video(torch.from_numpy(clips))
        got_t = pm.forward_text(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-4, rtol=1e-4)


def test_convert_entry_checkpoint_is_merged_by_the_train_entry(tmp_path, monkeypatch):
    """.pth files in the published schemas (timm's {'model': ...} wrapping,
    HF's BertForPreTraining) at the debug retrieval config's widths ->
    ``convert_checkpoint`` -> the train entry's ``load_from`` merges the
    backbone and the text backbone, bitwise the converted tensors."""
    swin2d = prehearsal.synth_swin2d_state_dict(embed=8, depths=(1, 1), heads=(2, 2), window=2)
    hf = prehearsal.synth_hf_bert_state_dict(hidden=16, layers=1, intermediate=32, vocab=60)
    swin_pth, bert_pth, _ = prehearsal.write_sources(str(tmp_path), swin2d, hf)
    out = str(tmp_path / "converted")
    pconvert_entry.main(["--swin", swin_pth, "--inflate-2d", "--temporal-window", "2",
                         "--bert", bert_pth, "--depths", "1", "1", "--bert-layers", "1",
                         "--fusion-layers", "1", "--out", out])
    converted = pengine.CheckpointManager(out).restore_params(step=0)
    assert {k.split(".")[0] for k in converted} == {"backbone", "text_backbone",
                                                    "multimodal_backbone", "mlm_head"}
    merged = {}
    real = pengine.merge_pretrained_params

    def spy(model, pretrained):
        result = real(model, pretrained)
        merged.update(loaded=result[1], state={k: v.detach().clone()
                                               for k, v in model.named_parameters()})
        return result

    monkeypatch.setattr(pengine, "merge_pretrained_params", spy)
    ptrain_entry.main([os.path.join(REPO, "configs", "exp", "debug_retrieval_synthetic.py"),
                       "--cpu", "--work-dir", str(tmp_path / "run"), "--cfg-options",
                       f"load_from={out}", "total_epochs=1"])
    assert merged["loaded"] == ["backbone", "text_backbone"]
    for name, want in converted.items():
        if name.startswith(("backbone.", "text_backbone.")):
            assert torch.equal(merged["state"][name], want), name
