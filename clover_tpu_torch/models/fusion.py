"""Cross-modal fusion transformer (port of ``clover_tpu/models/fusion.py``,
reference mmaction/models/backbones/cross_transformer.py:11-141).

A BERT encoder of its own (the first N layers) over

    [ visual tokens (+ spatial / temporal positions, type 0) | (all-CLS) | text (type 1) ]

with a LayerNorm on the visual stream, and split outputs for the text,
visual and CLS segments. Self-attention stays plain PyTorch, as it is XLA in
the JAX package; the FFN halves follow ``BertConfig.fused_mlp_train`` in
training (K3M on the fused route) and run K3 in eval, the visual norm is a
LayerNorm kernel site (K4) in eval.

The text embeddings (``embeddings``) exist only with ``text_embeddings``:
the pretrain model always passes the text tower's hidden states
(``text_input_embeds``), so flax creates no such parameters in its tree, and
the port builds none there either. ``remat`` recomputes each encoder
layer in the backward (``BertEncoder``'s).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from clover_tpu_torch.models.bert import (
    BertConfig,
    BertEmbeddings,
    BertEncoder,
    extend_attention_mask,
)
from clover_tpu_torch.models.layers import LayerNorm, Linear, normal_, trunc_normal_


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """``clover_tpu.models.fusion.FusionConfig``."""

    bert: BertConfig = BertConfig(num_hidden_layers=3)
    img_in_size: int = 1024
    hidden_size: int = 768
    num_frames: int = 4          # latent frames (T after the patch stride)
    spatial_tokens: int = 49     # 7 * 7
    token_types: int = 2
    word_pos_start: bool = False
    use_text_cls: bool = True    # True: no extra all-CLS token (the flagship config)
    use_prompt: bool = False
    num_prompt_tokens: int = 4


class CrossModalTransformer(nn.Module):
    def __init__(self, cfg: FusionConfig = FusionConfig(), dtype: torch.dtype = torch.float32,
                 kernels: bool = True, text_embeddings: bool = True, remat: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        D = cfg.hidden_size
        if text_embeddings:
            self.embeddings = BertEmbeddings(cfg.bert, kernels)
        self.encoder = BertEncoder(cfg.bert, kernels, remat)
        self.token_type_embeddings = nn.Embedding(cfg.token_types, D)
        # learned visual positions: (1, 1, S, D) spatial + (1, T, 1, D) temporal
        self.vis_space_pos = nn.Parameter(torch.zeros(1, 1, cfg.spatial_tokens, D))
        self.vis_tempor_pos = nn.Parameter(torch.zeros(1, cfg.num_frames, 1, D))
        self.visual_norm = LayerNorm(D, kernel=kernels)
        if cfg.img_in_size != D:
            self.fc_in = Linear(cfg.img_in_size, D)
        if not cfg.use_text_cls:
            self.all_cls_token = nn.Parameter(torch.zeros(1, 1, D))
            if cfg.use_prompt:
                self.prompt_token = nn.Parameter(torch.zeros(1, cfg.num_prompt_tokens, D))

    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.vis_space_pos, generator)
        normal_(self.vis_tempor_pos, generator)
        for name in ("all_cls_token", "prompt_token"):
            if hasattr(self, name):
                trunc_normal_(getattr(self, name), generator)

    def _embed_text(self, ids: torch.Tensor, position_offset: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        if not hasattr(self, "embeddings"):
            raise ValueError("this fusion tower has no text embeddings (text_embeddings=False): "
                             "pass text_input_embeds")
        return self.embeddings(ids, self.dtype, generator, position_offset=position_offset)

    def _text_type(self, text_emb: torch.Tensor) -> torch.Tensor:
        return text_emb + self.token_type_embeddings.weight[1].to(text_emb.dtype)

    def forward(self, visual_token: torch.Tensor, text_input_mask: torch.Tensor,
                text_input_ids: Optional[torch.Tensor] = None,
                text_input_embeds: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """visual_token (B, T, S, D_img), text_input_mask (B[*n], L) and the
        text as ids or as embeddings (B[*n], L, D); candidate-expanded text
        (B*n rows) is regrouped to (B, n*L). -> {'last_hidden_state',
        't_last_hidden_state', 'v_last_hidden_state'[, 'cls_last_hidden_state']}."""
        cfg = self.cfg
        if cfg.img_in_size != cfg.hidden_size:
            visual_token = self.fc_in(visual_token)
        B, T, S, D = visual_token.shape
        if text_input_embeds is None:
            text_emb = self._embed_text(text_input_ids, T * S + 1 if cfg.word_pos_start else 0,
                                        generator)
        else:
            text_emb = text_input_embeds.to(self.dtype)
        if text_emb.shape[0] != B:
            # candidate-expanded text (B*n, L, D) -> (B, n*L, D) (reference :79-82)
            text_emb = text_emb.reshape(B, -1, text_emb.shape[-1])
            text_input_mask = text_input_mask.reshape(B, -1)
        text_emb = self._text_type(text_emb)

        dt = visual_token.dtype
        visual_token = visual_token + (self.vis_space_pos + self.vis_tempor_pos[:, :T]).to(dt)
        visual_token = (visual_token.reshape(B, T * S, D)
                        + self.token_type_embeddings.weight[0].to(dt))
        visual_token = self.visual_norm(visual_token)
        if not cfg.use_text_cls:
            extra = [self.all_cls_token.to(dt).expand(B, 1, D)]
            if cfg.use_prompt:
                extra.insert(0, self.prompt_token.to(dt).expand(B, cfg.num_prompt_tokens, D))
            visual_token = torch.cat([visual_token] + extra, dim=1)
        v_seq_len = visual_token.shape[1]

        feats = torch.cat([visual_token, text_emb], dim=1)
        mask = torch.cat([torch.ones((B, v_seq_len), dtype=text_input_mask.dtype,
                                     device=text_input_mask.device), text_input_mask], dim=1)
        hidden = self.encoder(feats, extend_attention_mask(mask), generator)
        out = {"last_hidden_state": hidden,
               "t_last_hidden_state": hidden[:, v_seq_len:],
               "v_last_hidden_state": hidden[:, :T * S]}
        if not cfg.use_text_cls:
            out["cls_last_hidden_state"] = hidden[:, v_seq_len - 1:v_seq_len]
        return out

    def forward_text(self, text_input_ids: torch.Tensor, text_input_mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Text-only pass through the fusion encoder (reference
        cross_transformer.py:126-141). -> (B, L, D)."""
        cfg = self.cfg
        offset = cfg.num_frames * cfg.spatial_tokens + 1 if cfg.word_pos_start else 0
        text_emb = self._text_type(self._embed_text(text_input_ids, offset, generator))
        return self.encoder(text_emb, extend_attention_mask(text_input_mask), generator)
