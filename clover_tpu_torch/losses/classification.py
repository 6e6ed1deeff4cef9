"""The cross-entropy family and the focal losses (port of
``clover_tpu/losses/classification.py``), all in fp32:

- ``cross_entropy`` with hard or soft labels and ``class_weight``, and
  ``bce_with_logits`` with ``pos_weight`` (reference
  cross_entropy_loss.py:9-138);
- ``label_smoothing_cross_entropy`` (:139-220);
- ``softmax_focal_multiclass`` and the masked-LM losses (focal_loss.py:49-72,
  multimodal_transformer_pretrain.py:136-142). The reference selects the
  masked rows by boolean indexing; here, as in the JAX package, a masked
  mean over all rows gives the same value.

The batch means of ``cross_entropy`` and the masked-LM losses are those of
the global batch: under a process ``group`` (data parallel) each rank's sum
over the global count (all-reduced: ranks hold different masked-token
counts), into ``psum_scalar``; in one process the collectives are the
identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from clover_tpu_torch.parallel.collectives import psum_scalar

IGNORE_INDEX = -100


def _nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -logp.gather(-1, labels[..., None].long())[..., 0]


def _global_mean(total: torch.Tensor, count: torch.Tensor, group) -> torch.Tensor:
    """sum(total) / sum(count) over the group's ranks (``count`` carries no
    gradient)."""
    return psum_scalar(total / psum_scalar(count.detach(), group), group)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weight: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Mean CE of logits (N, C) against int labels (N,) or soft labels (N, C);
    with ``class_weight`` (C,) hard labels take the weighted mean
    sum(w[y] nll) / sum(w[y]), soft labels weight each class's term. The
    mean of the global batch: over ``group``'s rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    rows = torch.full((), float(logits.shape[0]), device=logp.device)
    if labels.ndim == logits.ndim:   # soft labels
        loss = -(labels * logp)
        if class_weight is not None:
            loss = loss * class_weight
        return _global_mean(loss.sum(), rows, group)
    nll = _nll(logp, labels)
    if class_weight is not None:
        w = class_weight[labels.long()]
        return _global_mean((nll * w).sum(), w.sum(), group)
    return _global_mean(nll.sum(), rows, group)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    pos_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary CE on logits: -(pos_weight y log s(x) + (1 - y) log s(-x))."""
    logits, labels = logits.float(), labels.float()
    pos = -labels * F.logsigmoid(logits)
    if pos_weight is not None:
        pos = pos * pos_weight
    return (pos - (1.0 - labels) * F.logsigmoid(-logits)).mean()


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  epsilon: float = 0.1) -> torch.Tensor:
    """CE against one_hot(labels) (1 - epsilon) + epsilon / C."""
    n_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), n_classes).float()
    return cross_entropy(logits, onehot * (1.0 - epsilon) + epsilon / n_classes)


def softmax_focal_multiclass(logits: torch.Tensor, labels: torch.Tensor,
                             gamma: float = 2.0) -> torch.Tensor:
    """(1 - p_t)^gamma CE, mean-reduced (reference focal_loss.py:60-72)."""
    ce = _nll(torch.log_softmax(logits.float(), dim=-1), labels)
    return ((1.0 - torch.exp(-ce)) ** gamma * ce).mean()


def masked_lm_focal_loss(logits: torch.Tensor, mlm_labels: torch.Tensor,
                         gamma: float = 2.0, group=None) -> torch.Tensor:
    """(1 - p_t)^gamma * CE, averaged over the masked positions only: logits
    (B, L, V), mlm_labels (B, L) with IGNORE_INDEX where a token is not
    masked; over the global batch's masked positions, ``group``'s."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = mlm_labels != IGNORE_INDEX
    ce = _nll(logp, torch.where(valid, mlm_labels, torch.zeros_like(mlm_labels)))
    focal = (1.0 - torch.exp(-ce)) ** gamma * ce
    total = torch.where(valid, focal, torch.zeros_like(focal)).sum()
    return psum_scalar(total / torch.clamp(psum_scalar(valid.sum(), group), min=1), group)


def masked_lm_cross_entropy(logits: torch.Tensor, mlm_labels: torch.Tensor,
                            group=None) -> torch.Tensor:
    """Plain CE over the masked positions (the reference's mlm_loss=None fallback)."""
    return masked_lm_focal_loss(logits, mlm_labels, gamma=0.0, group=group)
