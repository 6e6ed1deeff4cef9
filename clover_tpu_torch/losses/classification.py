"""Masked-LM losses (port of ``clover_tpu/losses/classification.py``, the
pretrain step's part; reference focal_loss.py:49-72 and
multimodal_transformer_pretrain.py:136-142). The reference selects the
masked rows by boolean indexing; here, as in the JAX package, a masked mean
over all rows gives the same value."""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def masked_lm_focal_loss(logits: torch.Tensor, mlm_labels: torch.Tensor,
                         gamma: float = 2.0) -> torch.Tensor:
    """(1 - p_t)^gamma * CE, averaged over the masked positions only: logits
    (B, L, V), mlm_labels (B, L) with IGNORE_INDEX where a token is not
    masked."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = mlm_labels != IGNORE_INDEX
    safe = torch.where(valid, mlm_labels, torch.zeros_like(mlm_labels))
    ce = -logp.gather(-1, safe[..., None].long())[..., 0]
    focal = (1.0 - torch.exp(-ce)) ** gamma * ce
    n_valid = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, focal, torch.zeros_like(focal)).sum() / n_valid


def masked_lm_cross_entropy(logits: torch.Tensor, mlm_labels: torch.Tensor) -> torch.Tensor:
    """Plain CE over the masked positions (the reference's mlm_loss=None fallback)."""
    return masked_lm_focal_loss(logits, mlm_labels, gamma=0.0)
