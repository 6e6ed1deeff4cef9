"""Retrieval projection head (port of ``clover_tpu/models/heads.py::NCEHeadForMM``,
reference mmaction/models/heads/ssl_head.py:8-139), LayerNorm projector,
CLS text aggregation."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from clover_tpu_torch.models.layers import Linear, ProjectorNorm


class NCEHeadForMM(nn.Module):
    """Dual-tower contrastive head: video pool + MLP / text CLS + MLP."""

    def __init__(self, visual_in_channels: int = 1024, text_in_channels: int = 768,
                 img_hidden_dim: int = 1536, vts_embed_dim: int = 768):
        super().__init__()
        self.img_fc1 = Linear(visual_in_channels, img_hidden_dim, init="xavier")
        self.img_norm1 = ProjectorNorm(img_hidden_dim)
        self.img_fc2 = Linear(img_hidden_dim, vts_embed_dim, init="xavier")
        self.img_norm2 = ProjectorNorm(vts_embed_dim)
        self.text_fc1 = Linear(text_in_channels, text_in_channels, init="xavier")
        self.text_fc2 = Linear(text_in_channels, vts_embed_dim, init="xavier")

    def forward(self, visual_feat: torch.Tensor, text_feat: torch.Tensor):
        return self.forward_vision(visual_feat), self.forward_text(text_feat)

    def forward_vision(self, visual_feat: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) channels-last features -> (B, vts_embed_dim)."""
        img = visual_feat.mean(dim=(1, 2, 3))
        img = self.img_norm1(self.img_fc1(img))
        img = F.gelu(img.float()).to(img.dtype)
        return self.img_norm2(self.img_fc2(img))

    def forward_text(self, text_feat: torch.Tensor) -> torch.Tensor:
        """(B, S, D) hidden states -> (B, vts_embed_dim), from the CLS token."""
        text = self.text_fc1(text_feat[:, 0])
        text = F.gelu(text.float()).to(text.dtype)
        return self.text_fc2(text)
