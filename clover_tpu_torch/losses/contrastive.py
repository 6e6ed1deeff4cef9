"""In-batch contrastive loss (port of ``clover_tpu/losses/contrastive.py``,
the retrieval finetune's part). Pure fp32 functions over the batch."""

from __future__ import annotations

from typing import Optional

import torch


def cos_norm(a: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row L2-normalization with the reference's max(norm, eps) guard."""
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=eps)


def sim_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return cos_norm(a, eps) @ cos_norm(b, eps).T


def _diag_logsoftmax_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(torch.log_softmax(x, dim=1)).mean()


def norm_softmax_loss(video_embd: Optional[torch.Tensor] = None,
                      text_embd: Optional[torch.Tensor] = None,
                      sim_mat: Optional[torch.Tensor] = None, temperature: float = 0.07,
                      cos_sim: bool = False) -> torch.Tensor:
    """Symmetric in-batch InfoNCE (reference NormSoftmaxLoss)."""
    if sim_mat is None:
        v, t = video_embd.float(), text_embd.float()
        if cos_sim:
            x = sim_matrix(v, t) / temperature
        else:   # F.normalize semantics (eps clamp at 1e-12)
            x = (cos_norm(v, 1e-12) @ cos_norm(t, 1e-12).T) / temperature
    else:
        x = sim_mat.float()
    return -_diag_logsoftmax_mean(x) - _diag_logsoftmax_mean(x.T)
