"""Contrastive losses (port of ``clover_tpu/losses/contrastive.py``): the
retrieval finetune's in-batch InfoNCE and the pretrain step's exclusive-NCE
with margin ranking. Pure fp32 functions over the batch (reference
mmaction/models/losses/contrastive_loss.py).

Each loss is that of the global batch, as the JAX package's are under GSPMD:
under a process ``group`` (data parallel, ``parallel/``) each rank holds its
slice of the batch, scores its own queries against every rank's keys
(gathered by ``all_gather_with_grad``), reads the diagonals at the queries'
global rows and sums its rows over the global row count into
``psum_scalar``. The value is the global loss on every rank; each rank's
backward gives its share of the global gradient, and the train step sums the
shares (``engine/steps.py``). In one process (no group) every collective is
the identity.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from clover_tpu_torch.parallel.collectives import (all_gather_varied, all_gather_with_grad,
                                                   psum_scalar, rank, world)


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
                      cos_sim: bool = False, group=None) -> torch.Tensor:
    """Symmetric in-batch InfoNCE (reference NormSoftmaxLoss) of the global
    batch, each rank of ``group`` passing its rows
    (``norm_softmax_loss_sharded``); rows normalized with the max(norm, 1e-8)
    guard under ``cos_sim``, else F.normalize's 1e-12. A given ``sim_mat`` is
    one process's whole batch."""
    if sim_mat is None:
        return norm_softmax_loss_sharded(video_embd, text_embd, group, temperature,
                                         eps=1e-8 if cos_sim else 1e-12)
    if world(group) > 1:
        raise ValueError("norm_softmax_loss over a group takes embeddings, not sim_mat")
    x = sim_mat.float()
    return -_diag_logsoftmax_mean(x) - _diag_logsoftmax_mean(x.T)


def _diag_logsoftmax(queries: torch.Tensor, keys: torch.Tensor, gidx: torch.Tensor,
                     temperature: float, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log_softmax of each query's row over the keys, read at its global
    row ``gidx``; masked keys at -1e9."""
    logits = queries @ keys.T / temperature
    if key_mask is not None:
        logits = torch.where(key_mask[None, :], logits, torch.full_like(logits, -1e9))
    return torch.log_softmax(logits, dim=1).gather(1, gidx[:, None])[:, 0]


def norm_softmax_loss_sharded(v_local: torch.Tensor, t_local: torch.Tensor, group=None,
                              temperature: float = 0.07, eps: float = 1e-8) -> torch.Tensor:
    """NormSoftmaxLoss of the global batch from this rank's rows: its
    queries against every rank's keys, psum'd over the global B (JAX
    ``norm_softmax_loss_sharded``; each rank does B_local x B work). Rows
    normalized with the max(norm, ``eps``) guard."""
    vl, tl = cos_norm(v_local.float(), eps), cos_norm(t_local.float(), eps)
    n_local = vl.shape[0]
    v_all, t_all = all_gather_with_grad(torch.cat([vl, tl], dim=1), group).split(
        [vl.shape[1], tl.shape[1]], dim=1)
    gidx = rank(group) * n_local + torch.arange(n_local, device=vl.device)
    local = -(_diag_logsoftmax(vl, t_all, gidx, temperature).sum()
              + _diag_logsoftmax(tl, v_all, gidx, temperature).sum())
    return psum_scalar(local, group) / v_all.shape[0]


def norm_softmax_loss_sharded_varied(v_local: torch.Tensor, t_local: torch.Tensor,
                                     n_valid: int, group=None,
                                     temperature: float = 0.07) -> torch.Tensor:
    """NormSoftmaxLoss with ragged shards (JAX
    ``norm_softmax_loss_sharded_varied``): each rank's rows padded to a
    common count, the first ``n_valid`` real; padded keys leave every
    softmax and padded queries add nothing. Equal to the loss of the
    concatenated real rows."""
    vl, tl = cos_norm(v_local.float()), cos_norm(t_local.float())
    max_n = vl.shape[0]
    both, key_mask = all_gather_varied(torch.cat([vl, tl], dim=1), n_valid, group)
    v_all, t_all = both.split([vl.shape[1], tl.shape[1]], dim=1)
    rows = torch.arange(max_n, device=vl.device)
    gidx = rank(group) * max_n + rows
    local_valid = rows < n_valid
    diag = (_diag_logsoftmax(vl, t_all, gidx, temperature, key_mask)
            + _diag_logsoftmax(tl, v_all, gidx, temperature, key_mask))
    local = -torch.where(local_valid, diag, torch.zeros_like(diag)).sum()
    return psum_scalar(local, group) / key_mask.sum()


def margin_ranking_loss(x1: torch.Tensor, x2: torch.Tensor, margin: float) -> torch.Tensor:
    """mean(max(0, margin - (x1 - x2))), torch MarginRankingLoss with y = 1."""
    return torch.clamp(margin - (x1 - x2), min=0.0).mean()


def exclusive_nce_with_ranking(video_embd: torch.Tensor, text_embd: torch.Tensor,
                               text_mask_embd: torch.Tensor, text_recon_embd: torch.Tensor,
                               temperature: float = 0.05, margin_ttm: float = 5.0,
                               group=None) -> Dict[str, torch.Tensor]:
    """Clover's tri-modal exclusive-NCE with margin ranking (the JAX
    function with use_rank and use_rank_ttm on, as every config has them).

    The positives of video i are {T_i, T_mask_i, T_recon_i}; for each
    positive block the other two blocks' diagonals leave the negative pool
    (reference :127-141); t2v takes all 3B texts as queries over the B videos
    (:144-150); the ranking term asks sim(V, T) > sim(V, T_mask) + margin
    (:154-159). -> {'nce_loss', 'rank_t_tm_loss'} of the global batch: each
    rank of ``group`` scores its videos against every rank's three text
    blocks (the other blocks' entries at its videos' global rows suppressed)
    and its texts against every rank's videos; each sum goes over the global
    B (3B for t2v) into ``psum_scalar``. One gather of the four."""
    v = cos_norm(video_embd.float())
    t, tm, tr = (cos_norm(e.float()) for e in (text_embd, text_mask_embd, text_recon_embd))
    n = v.shape[0]
    widths = [e.shape[1] for e in (v, t, tm, tr)]
    v_all, *texts_all = all_gather_with_grad(torch.cat([v, t, tm, tr], dim=1), group).split(
        widths, dim=1)
    B = v_all.shape[0]
    rows = torch.arange(n, device=v.device)
    gidx = rank(group) * n + rows
    own = torch.zeros((n, B), dtype=torch.bool, device=v.device)
    own[rows, gidx] = True
    blocks = [(v @ e.T) / temperature for e in texts_all]              # (n, B) each
    loss_v = 0.0
    for i in range(3):
        row = torch.cat([b if j == i else torch.where(own, torch.full_like(b, -10000.0), b)
                         for j, b in enumerate(blocks)], dim=1)
        loss_v = loss_v + torch.log_softmax(row, dim=1)[:, i * B:(i + 1) * B][rows, gidx]
    t2v = sum(_diag_logsoftmax(e, v_all, gidx, temperature).sum() for e in (t, tm, tr))
    nce = -loss_v.sum() / B - t2v / (3 * B)
    rank_terms = torch.clamp(margin_ttm - (blocks[0][rows, gidx] - blocks[1][rows, gidx]), min=0.0)
    return {"nce_loss": psum_scalar(nce, group),
            "rank_t_tm_loss": psum_scalar(rank_terms.sum() / B, group)}
