"""CloverPretrain: the tri-modal pretraining model (port of
``clover_tpu/models/pretrain.py``; reference
mmaction/models/recognizers/multimodal_transformer_pretrain.py:77-173).

Two Swin passes (clean and SimMIM-masked video), two BERT passes (clean and
MLM-masked text) and two fusion passes, emitting every embedding the losses
need; the losses live in ``clover_tpu_torch.losses`` and are applied in the
train step. With ``batch_passes`` each pair of tower passes is one pass over
a 2B batch, and with ``share_embed`` the Swin patch embed runs once on B and
its tokens are duplicated into the 2B encode batch.

The model is built on ``device``, the card (``cuda``) unless the caller asks
for the CPU (``device='cpu'``, as the CPU tests do); with no card the
default construction raises. ``kernels`` as in ``CloverFinetune``.

Batch layout (channels-last):
  imgs         (B, T, H, W, 3) float
  token_ids    (B, L)  MLM-masked token ids
  input_mask   (B, L)  1/0 attention mask
  mlm_label    (B, L)  original ids at masked positions, -100 elsewhere
  v_token_mask (B, mh, mw) blockwise video mask
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from clover_tpu_torch.models.bert import BertConfig, BertTextEncoder
from clover_tpu_torch.models.fusion import CrossModalTransformer, FusionConfig
from clover_tpu_torch.models.heads import MLMHead, NCEHeadForMM, NCEHeadForText, NCEHeadForVision
from clover_tpu_torch.models.swin3d import SwinConfig, SwinTransformer3D

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """The fields of ``clover_tpu.models.pretrain.PretrainConfig`` the port
    reads, with the values every pretrain config sets for the others:
    ``text_agg_type='cls'``, ``use_mlm``, ``use_cmask`` and
    ``symmetry_rank`` on, ``scale_pixels`` off. The Swin config takes the
    raw clip (``embed_impl='conv'``), as the JAX pretrain does."""

    swin: SwinConfig = SwinConfig(mask_token=True, embed_impl="conv")
    text_bert: BertConfig = BertConfig()
    fusion: FusionConfig = FusionConfig()
    vts_embed_dim: int = 768
    batch_passes: bool = True
    share_embed: bool = True


def _split(t: torch.Tensor, B: int):
    return t[:B], t[B:]


class CloverPretrain(nn.Module):
    def __init__(self, config: PretrainConfig = PretrainConfig(),
                 dtype: torch.dtype = torch.float32, kernels: bool = True, device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CloverPretrain: no CUDA device for the default device='cuda'; "
                               "pass device='cpu' to build the model on the CPU")
        self.config, self.dtype = config, dtype
        cfg, D = config, config.fusion.hidden_size
        with device:
            self.backbone = SwinTransformer3D(cfg.swin, kernels)
            self.text_backbone = BertTextEncoder(cfg.text_bert, dtype, kernels)
            # the text always arrives as the text tower's hidden states
            self.multimodal_backbone = CrossModalTransformer(cfg.fusion, dtype, kernels,
                                                             text_embeddings=False)
            self.ssl_head = NCEHeadForMM(cfg.swin.num_features, cfg.text_bert.hidden_size,
                                         2 * D, cfg.vts_embed_dim)
            self.mlm_head = MLMHead(cfg.text_bert)
            self.mlm_ssl_V_head = NCEHeadForVision(D, D, cfg.vts_embed_dim)
            self.mlm_ssl_T_head = NCEHeadForText(D, cfg.vts_embed_dim)

    @staticmethod
    def _visual_tokens(feat: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, T, H*W, C), the fusion token layout."""
        B, T, H, W, C = feat.shape
        return feat.reshape(B, T, H * W, C)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The pretrain forward in ``train()`` mode (dropout and DropPath draw
        from ``generator``) -> {'visual_emb', 'text_emb', 'mlm_logits',
        'mask_visual_recon_emb', 'mask_word_emb', 'mask_word_recon_emb',
        'mask_visual_emb'}."""
        cfg = self.config
        imgs = batch["imgs"].reshape((-1,) + batch["imgs"].shape[-4:]).to(self.dtype)
        flat = {k: batch[k].reshape((-1,) + batch[k].shape[-1:])
                for k in ("token_ids", "input_mask", "mlm_label")}
        token_ids, input_mask, mlm_label = flat["token_ids"], flat["input_mask"], flat["mlm_label"]
        # the original ids at the masked positions: the clean text (reference :97)
        input_ssl_ids = torch.where(mlm_label == IGNORE_INDEX, token_ids, mlm_label)
        v_token_mask = batch["v_token_mask"].reshape((-1,) + batch["v_token_mask"].shape[-2:])
        B = imgs.shape[0]
        g = generator

        if cfg.batch_passes:
            # one 2B Swin pass [clean; masked], the clean half under an
            # all-zero mask (the identity of the mask mixing)
            both_mask = torch.cat([torch.zeros_like(v_token_mask), v_token_mask])
            if cfg.share_embed:
                tokens = self.backbone(imgs, generator=g, mode="embed")
                both_feat, _ = self.backbone(torch.cat([tokens, tokens]), generator=g,
                                             token_mask=both_mask, mode="encode")
            else:
                both_feat, _ = self.backbone(torch.cat([imgs, imgs]), generator=g,
                                             token_mask=both_mask)
            visual_feat, visual_feat_masked = _split(both_feat, B)
            both_text = self.text_backbone(torch.cat([input_ssl_ids, token_ids]),
                                           torch.cat([input_mask, input_mask]), g)
            text_no_mask, text_with_mask = _split(both_text, B)
        else:
            visual_feat = self.backbone(imgs, generator=g)
            text_no_mask = self.text_backbone(input_ssl_ids, input_mask, g)
            text_with_mask = self.text_backbone(token_ids, input_mask, g)
            visual_feat_masked, _ = self.backbone(imgs, generator=g, token_mask=v_token_mask)

        visual_emb, text_emb = self.ssl_head(visual_feat, text_no_mask)

        if cfg.batch_passes:
            # one 2B fusion pass [masked video + clean text; clean video + masked text]
            both_fused = self.multimodal_backbone(
                torch.cat([self._visual_tokens(visual_feat_masked),
                           self._visual_tokens(visual_feat)]),
                torch.cat([input_mask, input_mask]),
                text_input_embeds=torch.cat([text_no_mask, text_with_mask]), generator=g)
            v_text, t_text = _split(both_fused["t_last_hidden_state"], B)
        else:
            v_text = self.multimodal_backbone(
                self._visual_tokens(visual_feat_masked), input_mask,
                text_input_embeds=text_no_mask, generator=g)["t_last_hidden_state"]
            t_text = self.multimodal_backbone(
                self._visual_tokens(visual_feat), input_mask,
                text_input_embeds=text_with_mask, generator=g)["t_last_hidden_state"]

        return {
            "visual_emb": visual_emb,
            "text_emb": text_emb,
            "mlm_logits": self.mlm_head(t_text),
            # the V-branch reconstruction: text CLS of the masked-video fusion (reference :148-149)
            "mask_visual_recon_emb": self.mlm_ssl_V_head(v_text[:, 0]),
            "mask_word_emb": self.ssl_head.forward_text(text_with_mask),
            "mask_word_recon_emb": self.mlm_ssl_T_head(t_text[:, 0], g),
            "mask_visual_emb": self.ssl_head.forward_vision(visual_feat_masked),
        }

    def forward_test(self, imgs: torch.Tensor, token_ids: torch.Tensor,
                     input_mask: torch.Tensor,
                     bias_cache: Optional[Dict[str, torch.Tensor]] = None):
        """Dual-tower retrieval embeddings (separate_test, reference
        :194-218), multi-clip features mean-pooled. -> (video emb, text emb)."""
        imgs = imgs.reshape((-1,) + imgs.shape[-4:]).to(self.dtype)
        token_ids = token_ids.reshape((-1,) + token_ids.shape[-1:])
        input_mask = input_mask.reshape((-1,) + input_mask.shape[-1:])
        visual_feat = self.backbone(imgs, bias_cache)
        n_text = token_ids.shape[0]
        if visual_feat.shape[0] != n_text:
            visual_feat = visual_feat.reshape((n_text, -1) + visual_feat.shape[1:]).mean(dim=1)
        return self.ssl_head(visual_feat, self.text_backbone(token_ids, input_mask))
