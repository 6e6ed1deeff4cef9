"""Task objectives (port of ``clover_tpu/losses/objectives.py``): model
outputs -> {loss name: scalar}, with the reference's key names;
``total_loss`` sums every entry (reference recognizers/base.py
``_parse_losses``).

- pretrain: mlm_loss + nce_loss + rank_t_tm_loss + v_nce_loss +
  rank_v_vm_loss (multimodal_transformer_pretrain.py:127-169);
- finetune retrieval: retrieval_nce_loss;
- finetune QA / FIB: qa_loss (multimodal_transformer_finetune.py:114-123).

Each takes the data-parallel ``group`` (None: this process alone) and passes
it to its losses, which then give the global batch's values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from clover_tpu_torch.losses.classification import cross_entropy, masked_lm_focal_loss
from clover_tpu_torch.losses.contrastive import exclusive_nce_with_ranking, norm_softmax_loss


@dataclasses.dataclass(frozen=True)
class PretrainLossConfig:
    """``clover_tpu.losses.objectives.PretrainLossConfig``'s numbers; its
    switches (use_rank, use_rank_ttm, symmetry_rank, use_mlm) are on in
    every config, and the port has them on always."""

    nce_temperature: float = 0.05
    margin_ttm: float = 5.0
    mlm_focal_gamma: float = 2.0


def pretrain_losses(outputs: Dict[str, torch.Tensor], mlm_label: torch.Tensor,
                    cfg: PretrainLossConfig = PretrainLossConfig(),
                    group=None) -> Dict[str, torch.Tensor]:
    """CloverPretrain.forward_train's outputs -> the pretrain loss terms."""
    losses = {"mlm_loss": masked_lm_focal_loss(
        outputs["mlm_logits"], mlm_label.reshape((-1,) + mlm_label.shape[-1:]),
        gamma=cfg.mlm_focal_gamma, group=group)}
    nce = dict(temperature=cfg.nce_temperature, margin_ttm=cfg.margin_ttm, group=group)
    # V -> [T, T_mask, T_recon] (reference :147-152)
    losses.update(exclusive_nce_with_ranking(
        outputs["visual_emb"], outputs["text_emb"], outputs["mask_word_emb"],
        outputs["mask_visual_recon_emb"], **nce))
    # the symmetric T -> [V, V_mask, V_recon] (reference :155-169)
    ctv = exclusive_nce_with_ranking(
        outputs["text_emb"], outputs["visual_emb"], outputs["mask_visual_emb"],
        outputs["mask_word_recon_emb"], **nce)
    losses["v_nce_loss"] = ctv["nce_loss"]
    losses["rank_v_vm_loss"] = ctv["rank_t_tm_loss"]
    return losses


def retrieval_loss(visual_emb: torch.Tensor, text_emb: torch.Tensor,
                   temperature: float = 0.05, cos_sim: bool = True,
                   group=None) -> Dict[str, torch.Tensor]:
    return {"retrieval_nce_loss": norm_softmax_loss(visual_emb, text_emb,
                                                    temperature=temperature, cos_sim=cos_sim,
                                                    group=group)}


def qa_loss(logits: torch.Tensor, labels: torch.Tensor,
            group=None) -> Dict[str, torch.Tensor]:
    """CE of the (B, num_choices) scores against the (B[, 1]) answer index."""
    return {"qa_loss": cross_entropy(logits, labels.reshape(-1), group=group)}


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(losses.values())
