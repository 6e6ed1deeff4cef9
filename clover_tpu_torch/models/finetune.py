"""CloverFinetune, the task-switched finetuning model (port of
``clover_tpu/models/finetune.py``; reference
mmaction/models/recognizers/multimodal_transformer_finetune.py:59-197):

- ``task='retrieval'``: Swin video tower + BERT text tower +
  ``NCEHeadForMM``. ``forward_test`` is the retrieval eval; ``forward_video``
  and ``forward_text`` are the same towers split for serving. With
  ``use_itm_head`` the model also has the fusion tower and the ITM head for
  the full-fusion ITM eval: ``encode_visual`` caches a video's Swin tokens
  once, ``itm_pair_score`` runs only the text tower, the fusion tower and
  the ITM head per (video, text) pair.
- ``task='video_qa'`` / ``'FIB'``: the fusion tower over [video tokens |
  text] and one of three readouts -- ``answer_mask``: the hidden state at
  the [MASK] token; ``answer_cls``: the fused CLS (the all-CLS token where
  the fusion tower has one, else the text CLS), through the ITM head with
  ``use_itm_head``; else the first token through the ITM head -- then the QA
  head ('mc': a score per candidate; 'oe': ``num_labels`` answer logits).
  Without a QA head the ITM "match" column is the score: the raw logit in
  training, its fp32 softmax probability in ``forward_test``.

``forward_train`` is the finetune's forward (``train()`` mode, dropout and
DropPath from the generator passed in).

The model is built on ``device``, the card (``cuda``) unless the caller
asks for the CPU (``device='cpu'``, as the CPU tests do); with no card the
default construction raises. ``kernels=True`` runs the CUDA kernels on a
CUDA device (a CPU tensor always takes the plain versions);
``kernels=False`` runs the plain PyTorch versions everywhere, the reference
the kernels are held against.

The [MASK] readout takes the first [MASK] of each row (row position 0 where
there is none), as the JAX package's argmax does: the FIB pipelines insert
exactly one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from clover_tpu_torch.models.bert import BertConfig, BertTextEncoder
from clover_tpu_torch.models.fusion import CrossModalTransformer, FusionConfig
from clover_tpu_torch.models.heads import MASK_TOKEN_ID, ITMHead, NCEHeadForMM, QAMCHead, QAOEHead
from clover_tpu_torch.models.swin3d import SwinConfig, SwinTransformer3D

TASKS = ("retrieval", "video_qa", "FIB")


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """``clover_tpu.models.finetune.FinetuneConfig``. ``text_agg_type``: the
    text embedding from the CLS token ('cls', every config) or pooled over
    the words ('avg' / 'max', ``NCEHeadForMM``, whose video projector is
    ``2 * fusion.hidden_size`` wide, as in the JAX package)."""

    swin: SwinConfig = SwinConfig()
    text_bert: BertConfig = BertConfig()
    fusion: FusionConfig = FusionConfig()
    task: str = "retrieval"          # 'retrieval' | 'video_qa' | 'FIB'
    vts_embed_dim: int = 768
    text_agg_type: str = "cls"
    answer_mask: bool = False
    answer_cls: bool = False
    use_itm_head: bool = False
    qa_head: Optional[str] = None    # None | 'mc' | 'oe'
    num_labels: int = 0              # the OE answer vocabulary
    scale_pixels: bool = False

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}; one of {TASKS}")
        if self.qa_head not in (None, "mc", "oe"):
            raise ValueError(f"qa_head must be None, 'mc' or 'oe', got {self.qa_head!r}")

    @property
    def qa(self) -> bool:
        return self.task != "retrieval"

    @property
    def readout_width(self) -> int:
        """The QA head's input: the fusion width, or the ITM head's 2 logits
        where the readout goes through it."""
        through_itm = not self.answer_mask and (self.use_itm_head or not self.answer_cls)
        return 2 if through_itm else self.fusion.hidden_size


class CloverFinetune(nn.Module):
    def __init__(self, config: FinetuneConfig = FinetuneConfig(),
                 dtype: torch.dtype = torch.float32, kernels: bool = True,
                 device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CloverFinetune: no CUDA device for the default device='cuda'; "
                               "pass device='cpu' to build the model on the CPU")
        self.config, self.dtype, self.kernels = config, dtype, kernels
        cfg, D = config, config.fusion.hidden_size
        with device:
            self.backbone = SwinTransformer3D(cfg.swin, kernels)
            self.text_backbone = BertTextEncoder(cfg.text_bert, dtype, kernels)
            if not cfg.qa:
                self.ssl_head = NCEHeadForMM(cfg.swin.num_features, cfg.text_bert.hidden_size,
                                             2 * D, cfg.vts_embed_dim, cfg.text_agg_type)
            if cfg.use_itm_head:
                self.itm_head = ITMHead(D)
            if cfg.qa and cfg.qa_head == "mc":
                self.qa_head = QAMCHead(cfg.readout_width)
            elif cfg.qa and cfg.qa_head == "oe":
                self.qa_head = QAOEHead(cfg.readout_width, D, cfg.num_labels)
            if cfg.qa or cfg.use_itm_head:
                # the text always arrives as the text tower's hidden states
                self.multimodal_backbone = CrossModalTransformer(cfg.fusion, dtype, kernels,
                                                                 text_embeddings=False)

    def _visual_feat(self, imgs: torch.Tensor, n_text: int,
                     bias_cache: Optional[Dict[str, torch.Tensor]],
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.config.scale_pixels:
            imgs = imgs / 255.0
        feat = self.backbone(imgs.to(self.dtype), bias_cache, generator)
        if feat.shape[0] != n_text:
            # multi-clip inputs: mean-pool clip features (reference :73-75)
            feat = feat.reshape((n_text, -1) + feat.shape[1:]).mean(dim=1)
        return feat

    def _qa_logits(self, visual_feat: torch.Tensor, token_ids: torch.Tensor,
                   input_mask: torch.Tensor, generator: Optional[torch.Generator] = None,
                   test_mode: bool = False) -> torch.Tensor:
        """Fusion + readout + QA head -> (B, num_choices) scores."""
        cfg = self.config
        B, T, H, W, C = visual_feat.shape
        tokens = visual_feat.reshape(B, T, H * W, C)
        if cfg.qa_head == "oe":
            num_choices = cfg.num_labels
        else:
            # candidate expansion (reference :94-95): each video's tokens
            # repeated for its candidates, candidate-major within a video
            num_choices = token_ids.shape[0] // B
            tokens = tokens.repeat_interleave(num_choices, dim=0)
        text_hidden = self.text_backbone(token_ids, input_mask, generator)
        output = self.multimodal_backbone(tokens, input_mask, text_input_embeds=text_hidden,
                                          generator=generator)
        if cfg.answer_mask:
            # the first [MASK] of each row (0 where none), the JAX argmax
            mask_pos = (token_ids == MASK_TOKEN_ID).to(torch.int32).argmax(dim=1)
            readout = torch.take_along_dim(output["t_last_hidden_state"],
                                           mask_pos[:, None, None], dim=1)[:, 0]
        elif cfg.answer_cls:
            readout = output.get("cls_last_hidden_state", output["t_last_hidden_state"])[:, 0]
            if cfg.use_itm_head:
                readout = self.itm_head(readout, generator)
        else:
            readout = self.itm_head(output["last_hidden_state"][:, 0], generator)
        if cfg.qa_head is not None:
            return self.qa_head(readout, generator).reshape(-1, num_choices)
        # the ITM "match" column: the raw logit in training (reference
        # :118), P(match) in the test (:187), which ranks candidates by l1 - l0
        if test_mode:
            readout = torch.softmax(readout.float(), dim=-1)
        return readout[:, 1].reshape(-1, num_choices)

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

    def encode_visual(self, imgs: torch.Tensor, n_videos: int,
                      bias_cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The Swin tokens of the ITM eval's cached-token protocol: clips as
        ``forward_video`` takes them -> (n_videos, T, H*W, C), the fusion
        layout. The reference reruns the whole model per (video, text) pair;
        caching the tokens once a video and rerunning only the fusion tower
        gives the same scores."""
        imgs = imgs.reshape((-1,) + imgs.shape[-4:])
        feat = self._visual_feat(imgs, n_videos, bias_cache)
        B, T, H, W, C = feat.shape
        return feat.reshape(B, T, H * W, C)

    def itm_pair_score(self, visual_tokens: torch.Tensor, token_ids: torch.Tensor,
                       input_mask: torch.Tensor) -> torch.Tensor:
        """P(match) of aligned (video, text) pairs (reference non-separate
        forward_test, multimodal_transformer_pretrain.py:220-225): cached
        tokens (B, T, S, C), ids and mask (B, L) -> (B,) fp32, the fp32
        softmax of the ITM head on the fused first token."""
        text_hidden = self.text_backbone(token_ids, input_mask)
        output = self.multimodal_backbone(visual_tokens.to(self.dtype), input_mask,
                                          text_input_embeds=text_hidden)
        logits = self.itm_head(output["last_hidden_state"][:, 0])
        return torch.softmax(logits.float(), dim=-1)[:, 1]

    @staticmethod
    def _flat(token_ids: torch.Tensor, input_mask: torch.Tensor):
        return (token_ids.reshape((-1,) + token_ids.shape[-1:]),
                input_mask.reshape((-1,) + input_mask.shape[-1:]))

    def forward_test(self, imgs: torch.Tensor, token_ids: torch.Tensor,
                     input_mask: torch.Tensor,
                     bias_cache: Optional[Dict[str, torch.Tensor]] = None):
        """The eval forward: retrieval -> (video embedding, text embedding);
        QA / FIB -> (B, num_choices) scores (ids and mask (B[, n_cand], L))."""
        B = imgs.shape[0]
        imgs = imgs.reshape((-1,) + imgs.shape[-4:])
        token_ids, input_mask = self._flat(token_ids, input_mask)
        visual_feat = self._visual_feat(imgs, B, bias_cache)
        if self.config.qa:
            return self._qa_logits(visual_feat, token_ids, input_mask, test_mode=True)
        text_hidden = self.text_backbone(token_ids, input_mask)
        return self.ssl_head(visual_feat, text_hidden, input_mask, token_ids)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None):
        """The finetune forward (reference collate contract): ``imgs``
        (B, n_clips, D', H', W', K) host s2d clips, flattened for the backbone
        and their features mean-pooled back to B; ``token_ids`` and
        ``input_mask`` (B, [n_cand,] L), flattened. Dropout and DropPath draw
        from ``generator`` in ``train()`` mode. -> (video emb, text emb) for
        retrieval, (B, num_choices) logits for QA / FIB."""
        imgs = batch["imgs"]
        B = imgs.shape[0]
        imgs = imgs.reshape((-1,) + imgs.shape[-4:])
        token_ids, input_mask = self._flat(batch["token_ids"], batch["input_mask"])
        visual_feat = self._visual_feat(imgs, B, None, generator)
        if self.config.qa:
            return self._qa_logits(visual_feat, token_ids, input_mask, generator)
        text_hidden = self.text_backbone(token_ids, input_mask, generator)
        return self.ssl_head(visual_feat, text_hidden, input_mask, token_ids, generator)
