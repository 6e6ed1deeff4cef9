"""Projection and readout heads (port of ``clover_tpu/models/heads.py``):

- ``NCEHeadForMM``: the dual-tower contrastive head (reference
  mmaction/models/heads/ssl_head.py:8-139): LayerNorm or BatchNorm
  projector, text pooled from CLS or by mean or max over the words;
- ``NCEHeadForVision`` (ssl_head.py:142-221) and ``NCEHeadForText``
  (:224-297): the pretrain reconstruction heads;
- ``MLMHead`` (mlm_itm_head.py:10-52): transform + vocabulary decoder;
- ``ITMHead`` (mlm_itm_head.py:55-97): the 2-way image-text-match head;
- ``QAMCHead`` (qa_head.py:7-39) and ``QAOEHead`` (:42-87): the
  multiple-choice scorer and the open-ended answer classifier. Their
  LayerNorm (eps 1e-5) is plain: it is not a kernel site in the JAX
  package either (``LayerNormAuto`` without ``fwd_only``).

The projection heads draw their weights xavier-uniform (``init_params``);
dropout draws from the ``generator`` passed to ``forward`` in training.

``NCEHeadForVision`` keeps the JAX package's documented fix
(``clover_tpu/models/heads.py:12-17``): the reference takes the token mean
unconditionally and crashes on the 2-D CLS feature the pretrain model feeds
it; the mean is taken for 3-D inputs only, a 2-D input passes as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clover_tpu_torch.models.bert import BertConfig, BertPredictionTransform
from clover_tpu_torch.models.layers import LayerNorm, Linear, ProjectorNorm, dropout

SEP_TOKEN_ID = 102
MASK_TOKEN_ID = 103


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float()).to(x.dtype)


class NCEHeadForMM(nn.Module):
    """Dual-tower contrastive head: video pool + MLP / text pooling + MLP.

    ``text_agg_type``: 'cls' takes the CLS token; 'avg' / 'max' pool the
    words: CLS dropped, SEP (id 102) and padding masked out, 'avg' the sum
    over max(count, 1e-6), 'max' the max over the zero-filled masked tokens.
    ``use_ln=False`` makes the image projector norms :class:`BatchNorm`;
    ``text_bn`` adds one after text_fc1. ``dropout_ratio``: the pooled
    video feature's dropout in training, from ``generator``."""

    def __init__(self, visual_in_channels: int = 1024, text_in_channels: int = 768,
                 img_hidden_dim: int = 1536, vts_embed_dim: int = 768,
                 text_agg_type: str = "cls", use_ln: bool = True, text_bn: bool = False,
                 dropout_ratio: float = 0.0):
        super().__init__()
        if text_agg_type not in ("cls", "avg", "max"):
            raise ValueError(f"unknown text_agg_type {text_agg_type!r}")
        self.text_agg_type, self.drop = text_agg_type, dropout_ratio
        self.img_fc1 = Linear(visual_in_channels, img_hidden_dim, init="xavier")
        self.img_norm1 = ProjectorNorm(img_hidden_dim, use_ln)
        self.img_fc2 = Linear(img_hidden_dim, vts_embed_dim, init="xavier")
        self.img_norm2 = ProjectorNorm(vts_embed_dim, use_ln)
        self.text_fc1 = Linear(text_in_channels, text_in_channels, init="xavier")
        self.text_norm = ProjectorNorm(text_in_channels, use_ln=False) if text_bn else None
        self.text_fc2 = Linear(text_in_channels, vts_embed_dim, init="xavier")

    def forward(self, visual_feat: torch.Tensor, text_feat: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None,
                token_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return (self.forward_vision(visual_feat, generator),
                self.forward_text(text_feat, text_mask, token_ids))

    def forward_vision(self, visual_feat: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, H, W, C) channels-last features -> (B, vts_embed_dim)."""
        img = dropout(visual_feat.mean(dim=(1, 2, 3)), self.drop, generator, self.training)
        img = _gelu(self.img_norm1(self.img_fc1(img)))
        return self.img_norm2(self.img_fc2(img))

    def forward_text(self, text_feat: torch.Tensor, text_mask: Optional[torch.Tensor] = None,
                     token_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S, D) hidden states (with the (B, S) mask and ids for 'avg' /
        'max') -> (B, vts_embed_dim)."""
        if self.text_agg_type == "cls":
            text = text_feat[:, 0]
        else:
            mask = torch.where(token_ids == SEP_TOKEN_ID, torch.zeros_like(text_mask), text_mask)
            mask = mask[:, 1:].to(text_feat.dtype)[..., None]
            masked = text_feat[:, 1:] * mask
            if self.text_agg_type == "avg":
                text = masked.sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1e-6)
            else:
                text = masked.amax(dim=1)
        text = self.text_fc1(text)
        if self.text_norm is not None:
            text = self.text_norm(text)
        return self.text_fc2(_gelu(text))


class NCEHeadForVision(nn.Module):
    """Projects the fused masked-video reconstruction feature: (B[, S], C)
    -> (B, vts_embed_dim); fc1 to 2 * hidden_dim, LN, GELU, fc2, LN. Its
    dropout rate is 0 in every config, so it has none."""

    def __init__(self, in_channels: int = 768, hidden_dim: int = 768,
                 vts_embed_dim: int = 768):
        super().__init__()
        self.fc1 = Linear(in_channels, 2 * hidden_dim, init="xavier")
        self.norm1 = ProjectorNorm(2 * hidden_dim)
        self.fc2 = Linear(2 * hidden_dim, vts_embed_dim, init="xavier")
        self.norm2 = ProjectorNorm(vts_embed_dim)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        if feat.ndim == 3:
            feat = feat.mean(dim=1)
        feat = _gelu(self.norm1(self.fc1(feat)))
        return self.norm2(self.fc2(feat))


class NCEHeadForText(nn.Module):
    """Projects the fused masked-word reconstruction feature: fc1, GELU,
    dropout (0.1, from ``generator`` in training), fc2."""

    def __init__(self, cross_in_channels: int = 768, vts_embed_dim: int = 768,
                 dropout_ratio: float = 0.1):
        super().__init__()
        self.fc1 = Linear(cross_in_channels, cross_in_channels, init="xavier")
        self.fc2 = Linear(cross_in_channels, vts_embed_dim, init="xavier")
        self.drop = dropout_ratio

    def forward(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = dropout(_gelu(self.fc1(feat)), self.drop, generator, self.training)
        return self.fc2(feat)


class MLMHead(nn.Module):
    """BERT LM head: transform + vocabulary decoder (a separate weight,
    initialised like the word embeddings)."""

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.transform = BertPredictionTransform(cfg)
        self.decoder = Linear(cfg.hidden_size, cfg.vocab_size, init="normal")

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.transform(hidden_states))


class ITMHead(nn.Module):
    """2-way image-text-match head: dropout, fc1, tanh, fc2 -> (..., 2)."""

    def __init__(self, hidden_dim: int = 768, dropout_ratio: float = 0.1):
        super().__init__()
        self.fc1 = Linear(hidden_dim, hidden_dim, init="xavier")
        self.fc2 = Linear(hidden_dim, 2, init="xavier")
        self.drop = dropout_ratio

    def forward(self, cls_feature: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(cls_feature, self.drop, generator, self.training)
        return self.fc2(torch.tanh(self.fc1(x)))


class _QAHead(nn.Module):
    """dropout, fc1 to ``width``, LayerNorm, GELU, fc2 to ``out``."""

    def __init__(self, in_features: int, width: int, out: int, dropout_ratio: float):
        super().__init__()
        self.fc1 = Linear(in_features, width, init="xavier")
        self.norm = LayerNorm(width)
        self.fc2 = Linear(width, out, init="xavier")
        self.drop = dropout_ratio

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(x, self.drop, generator, self.training)
        return self.fc2(_gelu(self.norm(self.fc1(x))))


class QAMCHead(_QAHead):
    """Multiple-choice scorer: (..., in_features) -> (..., 1) through a
    256-wide hidden layer; dropout 0.1."""

    def __init__(self, in_features: int = 768, dropout_ratio: float = 0.1):
        super().__init__(in_features, 256, 1, dropout_ratio)


class QAOEHead(_QAHead):
    """Open-ended answer classifier: (..., in_features) -> (..., num_labels)
    through a hidden_dim / 2 wide layer; dropout 0.5."""

    def __init__(self, in_features: int = 768, hidden_dim: int = 768, num_labels: int = 1000,
                 dropout_ratio: float = 0.5):
        super().__init__(in_features, hidden_dim // 2, num_labels, dropout_ratio)
