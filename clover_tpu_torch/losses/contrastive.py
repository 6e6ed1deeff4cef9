"""Contrastive losses (port of ``clover_tpu/losses/contrastive.py``): the
retrieval finetune's in-batch InfoNCE and the pretrain step's exclusive-NCE
with margin ranking. Pure fp32 functions over the batch (reference
mmaction/models/losses/contrastive_loss.py)."""

from __future__ import annotations

from typing import Dict, Optional

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


def margin_ranking_loss(x1: torch.Tensor, x2: torch.Tensor, margin: float) -> torch.Tensor:
    """mean(max(0, margin - (x1 - x2))), torch MarginRankingLoss with y = 1."""
    return torch.clamp(margin - (x1 - x2), min=0.0).mean()


def _suppress_diag(sim: torch.Tensor) -> torch.Tensor:
    """The diagonal set to -10000 (reference diag_embed trick, :130-132)."""
    eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
    return torch.where(eye, torch.full_like(sim, -10000.0), sim)


def exclusive_nce_with_ranking(video_embd: torch.Tensor, text_embd: torch.Tensor,
                               text_mask_embd: torch.Tensor, text_recon_embd: torch.Tensor,
                               temperature: float = 0.05,
                               margin_ttm: float = 5.0) -> Dict[str, torch.Tensor]:
    """Clover's tri-modal exclusive-NCE with margin ranking (the JAX
    function with use_rank and use_rank_ttm on, as every config has them).

    The positives of video i are {T_i, T_mask_i, T_recon_i}; for each
    positive block the other two blocks' diagonals leave the negative pool
    (reference :127-141); t2v takes all 3B texts as queries over the B videos
    (:144-150); the ranking term asks sim(V, T) > sim(V, T_mask) + margin
    (:154-159). -> {'nce_loss', 'rank_t_tm_loss'}."""
    v = cos_norm(video_embd.float())
    t, tm, tr = (cos_norm(e.float()) for e in (text_embd, text_mask_embd, text_recon_embd))
    sim_vt, sim_vtm, sim_vtr = ((v @ e.T) / temperature for e in (t, tm, tr))
    B = sim_vt.shape[0]
    blocks = (sim_vt, sim_vtm, sim_vtr)
    loss_v = 0.0
    for i, own in enumerate(blocks):
        # block i as it is, the other two with their diagonals suppressed
        row = torch.cat([b if j == i else _suppress_diag(b) for j, b in enumerate(blocks)], dim=1)
        logsm = torch.log_softmax(row, dim=1)[:, i * B:(i + 1) * B]
        loss_v = loss_v + torch.diagonal(logsm)
    loss_v = -loss_v.mean()
    t2v = torch.cat(blocks, dim=1).T                      # (3B, B)
    t2v_diag = torch.diagonal(torch.log_softmax(t2v, dim=1).reshape(3, B, B), dim1=1, dim2=2)
    return {"nce_loss": loss_v - t2v_diag.mean(dim=1).mean(),
            "rank_t_tm_loss": margin_ranking_loss(torch.diagonal(sim_vt),
                                                  torch.diagonal(sim_vtm), margin_ttm)}
