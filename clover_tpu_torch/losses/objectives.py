"""Task objectives (port of ``clover_tpu/losses/objectives.py``, retrieval
finetune): model outputs -> {loss name: scalar}, with the reference's key
names; ``total_loss`` sums every entry."""

from __future__ import annotations

from typing import Dict

import torch

from clover_tpu_torch.losses.contrastive import norm_softmax_loss


def retrieval_loss(visual_emb: torch.Tensor, text_emb: torch.Tensor,
                   temperature: float = 0.05, cos_sim: bool = True) -> Dict[str, torch.Tensor]:
    return {"retrieval_nce_loss": norm_softmax_loss(visual_emb, text_emb,
                                                    temperature=temperature, cos_sim=cos_sim)}


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(losses.values())
