"""CloverFinetune for ``task='retrieval'`` (port of
``clover_tpu/models/finetune.py``): Swin video tower + BERT text tower +
``NCEHeadForMM``. ``forward_test`` is the retrieval eval; ``forward_video``
and ``forward_text`` are the same towers split for serving;
``forward_train`` is the retrieval finetune's forward (``train()`` mode).

The model is built on ``device``, the card (``cuda``) unless the caller
asks for the CPU (``device='cpu'``, as the CPU tests do); with no card the
default construction raises. ``kernels=True`` runs the CUDA kernels on a
CUDA device (a CPU tensor always takes the plain versions);
``kernels=False`` runs the plain PyTorch versions everywhere, the reference
the kernels are held against.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from clover_tpu_torch.models.bert import BertConfig, BertTextEncoder
from clover_tpu_torch.models.heads import NCEHeadForMM
from clover_tpu_torch.models.swin3d import SwinConfig, SwinTransformer3D


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """The retrieval fields of ``clover_tpu.models.finetune.FinetuneConfig``
    (``task='retrieval'``). ``text_agg_type``: the text embedding from the
    CLS token ('cls', every config) or pooled over the words ('avg' /
    'max', ``NCEHeadForMM``)."""

    swin: SwinConfig = SwinConfig()
    text_bert: BertConfig = BertConfig()
    vts_embed_dim: int = 768
    text_agg_type: str = "cls"
    # the JAX config derives this as fusion.hidden_size * 2 (768 * 2)
    img_hidden_dim: int = 1536


class CloverFinetune(nn.Module):
    def __init__(self, config: FinetuneConfig = FinetuneConfig(),
                 dtype: torch.dtype = torch.float32, kernels: bool = True,
                 device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CloverFinetune: no CUDA device for the default device='cuda'; "
                               "pass device='cpu' to build the model on the CPU")
        self.config, self.dtype = config, dtype
        with device:
            self.backbone = SwinTransformer3D(config.swin, kernels)
            self.text_backbone = BertTextEncoder(config.text_bert, dtype, kernels)
            self.ssl_head = NCEHeadForMM(config.swin.num_features, config.text_bert.hidden_size,
                                         config.img_hidden_dim, config.vts_embed_dim,
                                         config.text_agg_type)

    def _visual_feat(self, imgs: torch.Tensor, n_text: int,
                     bias_cache: Optional[Dict[str, torch.Tensor]],
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = self.backbone(imgs.to(self.dtype), bias_cache, generator)
        if feat.shape[0] != n_text:
            # multi-clip inputs: mean-pool clip features (reference :73-75)
            feat = feat.reshape((n_text, -1) + feat.shape[1:]).mean(dim=1)
        return feat

    def forward_video(self, imgs: torch.Tensor,
                      bias_cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """(B[, n_clips], D', H', W', K) host s2d clips (or (B[, n_clips], T,
        H, W, 3) frames with ``embed_impl`` 's2d' / 'conv') -> (B, D)
        embedding."""
        B = imgs.shape[0]
        imgs = imgs.reshape((-1,) + imgs.shape[-4:])
        return self.ssl_head.forward_vision(self._visual_feat(imgs, B, bias_cache))

    def forward_text(self, token_ids: torch.Tensor, input_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) ids / mask -> (B, D) embedding."""
        return self.ssl_head.forward_text(self.text_backbone(token_ids, input_mask), input_mask,
                                          token_ids)

    def forward_test(self, imgs: torch.Tensor, token_ids: torch.Tensor,
                     input_mask: torch.Tensor,
                     bias_cache: Optional[Dict[str, torch.Tensor]] = None):
        """Retrieval eval: -> (video embedding, text embedding)."""
        B = imgs.shape[0]
        imgs = imgs.reshape((-1,) + imgs.shape[-4:])
        token_ids = token_ids.reshape((-1,) + token_ids.shape[-1:])
        input_mask = input_mask.reshape((-1,) + input_mask.shape[-1:])
        visual_feat = self._visual_feat(imgs, B, bias_cache)
        text_hidden = self.text_backbone(token_ids, input_mask)
        return self.ssl_head(visual_feat, text_hidden, input_mask, token_ids)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None):
        """Retrieval finetune forward (reference collate contract): ``imgs``
        (B, n_clips, D', H', W', K) host s2d clips, flattened for the backbone
        and their features mean-pooled back to B; ``token_ids`` and
        ``input_mask`` (B, [n_cand,] L), flattened. Dropout and DropPath draw
        from ``generator`` in ``train()`` mode. -> (video emb, text emb)."""
        imgs = batch["imgs"]
        B = imgs.shape[0]
        imgs = imgs.reshape((-1,) + imgs.shape[-4:])
        token_ids = batch["token_ids"].reshape((-1,) + batch["token_ids"].shape[-1:])
        input_mask = batch["input_mask"].reshape((-1,) + batch["input_mask"].shape[-1:])
        visual_feat = self._visual_feat(imgs, B, None, generator)
        text_hidden = self.text_backbone(token_ids, input_mask, generator)
        return self.ssl_head(visual_feat, text_hidden, input_mask, token_ids, generator)
