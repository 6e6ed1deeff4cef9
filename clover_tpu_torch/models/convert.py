"""Torch / HF checkpoints -> the port's state-dict names (port of
``clover_tpu/models/convert.py``).

The reference pulls its pretrained weights from two sources: HF
``bert-base-uncased`` for the text tower, the fusion tower and the MLM head,
and a Video-Swin ``.pth`` (or an image Swin, inflated in time) for the
backbone. These converters map those state dicts onto the port's
parameter names, so that a published checkpoint reaches the port without
the JAX package.

Every function takes a flat ``{name: array}`` dict (numpy, or anything
``np.asarray`` takes: call ``.numpy()`` on torch tensors first) and returns
a flat ``{port name: fp32 numpy array}`` dict, named under the converted
module (``embeddings.norm.weight``, ``stage_0_block_0.attn.qkv.weight``,
...); the caller prefixes the model's child (``backbone.``,
``text_backbone.``, ...). The leaf rules are those of ``bridge.py``, so
each result equals ``bridge.state_from_jax`` of the JAX converter's tree:
a torch ``Linear`` weight keeps its (out, in) layout (the JAX tree holds it
transposed and the bridge transposes it back), the patch embed's ``proj``
keeps the JAX layout (the space-to-depth Dense (pd*ph*pw*C_in, E), or the
``nn.Conv`` (pd, ph, pw, C_in, E) where the stride is not the patch), a
LayerNorm's weight and bias and an embedding table go as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

Array = Any


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32))


def _copy(out: Dict[str, np.ndarray], sd: Mapping[str, Array], src: str, dst: str) -> None:
    """``dst.weight`` <- ``src.weight`` and ``dst.bias`` <- ``src.bias``
    where ``sd`` has one (a Linear without a bias has none)."""
    out[f"{dst}.weight"] = _f32(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])


# --------------------------------------------------------------------- BERT


def convert_bert_embeddings(sd: Mapping[str, Array], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for table in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out[f"embeddings.{table}.weight"] = _f32(sd[f"{prefix}.{table}.weight"])
    _copy(out, sd, f"{prefix}.LayerNorm", "embeddings.norm")
    return out


def convert_bert_encoder(sd: Mapping[str, Array], prefix: str,
                         num_layers: int) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for i in range(num_layers):
        src, dst = f"{prefix}.layer.{i}", f"encoder.layer_{i}"
        for proj in ("query", "key", "value"):
            _copy(out, sd, f"{src}.attention.self.{proj}", f"{dst}.attention.{proj}")
        _copy(out, sd, f"{src}.attention.output.dense", f"{dst}.attention_output")
        _copy(out, sd, f"{src}.attention.output.LayerNorm", f"{dst}.attention_norm")
        _copy(out, sd, f"{src}.intermediate.dense", f"{dst}.intermediate")
        _copy(out, sd, f"{src}.output.dense", f"{dst}.output")
        _copy(out, sd, f"{src}.output.LayerNorm", f"{dst}.output_norm")
    return out


def convert_hf_bert(sd: Mapping[str, Array], num_layers: int = 12,
                    prefix: str = "") -> Dict[str, np.ndarray]:
    """HF BertModel state dict -> ``BertTextEncoder``'s parameters."""
    if prefix and not prefix.endswith("."):
        prefix += "."
    return {**convert_bert_embeddings(sd, f"{prefix}embeddings"),
            **convert_bert_encoder(sd, f"{prefix}encoder", num_layers)}


def convert_mlm_head(sd: Mapping[str, Array],
                     prefix: str = "cls.predictions") -> Dict[str, np.ndarray]:
    """HF BertForMaskedLM's cls head -> ``MLMHead``'s parameters (the decoder
    kept tied: HF's ``cls.predictions.bias`` where the decoder has none)."""
    out: Dict[str, np.ndarray] = {}
    _copy(out, sd, f"{prefix}.transform.dense", "transform.dense")
    _copy(out, sd, f"{prefix}.transform.LayerNorm", "transform.norm")
    _copy(out, sd, f"{prefix}.decoder", "decoder")
    if "decoder.bias" not in out:
        out["decoder.bias"] = _f32(sd[f"{prefix}.bias"])
    return out


def convert_fusion_from_hf(sd: Mapping[str, Array], num_layers: int = 3,
                           bert_prefix: str = "bert") -> Dict[str, np.ndarray]:
    """HF BertForPreTraining -> the BERT-initialized part of the fusion tower
    (``embeddings.*`` and ``encoder.*``); its own parameters (positions,
    token types, visual_norm, fc_in, cls tokens) keep their fresh init, as
    they are new in the reference too."""
    return {**convert_bert_embeddings(sd, f"{bert_prefix}.embeddings"),
            **convert_bert_encoder(sd, f"{bert_prefix}.encoder", num_layers)}


# --------------------------------------------------------------------- Swin


def inflate_swin2d(sd: Mapping[str, Array], temporal_patch: int,
                   temporal_window: int) -> Dict[str, np.ndarray]:
    """An image-Swin state dict -> the 3D layout, for :func:`convert_swin3d`
    (the reference's inflate_weights): the patch-embed conv (Co, Ci, ph, pw)
    repeated over pd and divided by pd; each relative-position bias table
    ((2wh-1)(2ww-1), nH) tiled (2wd-1) times along its rows (the spatial
    sizes must already match); relative_position_index and attn_mask
    dropped (recomputed). Names kept."""
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        val = np.asarray(val)
        if "relative_position_index" in key or "attn_mask" in key:
            continue
        if key == "patch_embed.proj.weight":
            val = np.repeat(val[:, :, None], temporal_patch, axis=2) / temporal_patch
        elif "relative_position_bias_table" in key:
            val = np.tile(val, (2 * temporal_window - 1, 1))
        out[key] = val
    return out


def convert_swin3d(sd: Mapping[str, Array], depths, patch_equals_stride: bool = True,
                   prefix: str = "backbone.") -> Dict[str, np.ndarray]:
    """Video-Swin torch state dict -> ``SwinTransformer3D``'s parameters.

    The Conv3d patch embed (Co, Ci, pd, ph, pw) becomes the space-to-depth
    Dense (pd*ph*pw*Ci, Co), features in (d, h, w, c) order, or with
    ``patch_equals_stride=False`` the (pd, ph, pw, Ci, Co) kernel of the
    strided convolution; the SimMIM ``mask_token`` (1, C, 1, 1, 1) becomes
    (1, 1, 1, 1, C)."""
    sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    out: Dict[str, np.ndarray] = {}
    conv_w = np.asarray(sd["patch_embed.proj.weight"])       # (Co, Ci, pd, ph, pw)
    kernel = conv_w.transpose(2, 3, 4, 1, 0)
    if patch_equals_stride:
        kernel = kernel.reshape(-1, conv_w.shape[0])
    out["patch_embed.proj.weight"] = _f32(kernel)
    out["patch_embed.proj.bias"] = _f32(sd["patch_embed.proj.bias"])
    if "patch_embed.norm.weight" in sd:
        _copy(out, sd, "patch_embed.norm", "patch_embed.norm")
    if "mask_token" in sd:
        out["mask_token"] = _f32(np.asarray(sd["mask_token"]).reshape(1, 1, 1, 1, -1))
    for i_stage, depth in enumerate(depths):
        for i_blk in range(depth):
            src, dst = f"layers.{i_stage}.blocks.{i_blk}", f"stage_{i_stage}_block_{i_blk}"
            for sub in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
                _copy(out, sd, f"{src}.{sub}", f"{dst}.{sub}")
            table = "attn.relative_position_bias_table"
            out[f"{dst}.{table}"] = _f32(sd[f"{src}.{table}"])
        down = f"layers.{i_stage}.downsample"
        if f"{down}.norm.weight" in sd:
            _copy(out, sd, f"{down}.norm", f"stage_{i_stage}_downsample.norm")
            _copy(out, sd, f"{down}.reduction", f"stage_{i_stage}_downsample.reduction")
    _copy(out, sd, "norm", "norm")
    return out
