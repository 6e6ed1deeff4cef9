"""Train and eval step factories (port of ``clover_tpu/engine/steps.py``).

A train step (retrieval, pretrain, QA) runs the forward in ``train()``
mode with dropout drawn from a generator derived from (seed, step) -- the
counterpart of ``jax.random.fold_in(rng, state.step)`` -- the loss, the
backward, one global gradient norm that serves both the clip and the
``grad_norm`` metric, and the AdamW update. Parameters and optimizer state
are fp32; the model computes in its own dtype. The eval steps run the
model's ``forward_test`` (retrieval embeddings or QA scores) and the ITM
eval's two halves, ``encode_visual`` and ``itm_pair_score``, under inference
mode.

Data parallel (``group``, a process group of the ranks that each hold a
slice of the global batch; ``parallel.mesh.data_group()``): the losses are
those of the global batch (``losses/``), each rank's backward gives its share
of the global gradient, and the shares are summed once a step, one
``all_reduce`` a flat bucket, before the norm, so that the norm, the clip,
the logged ``grad_norm`` and the update are the global batch's on every rank.
Each train-step factory binds the model's BatchNorm layers to its
``group`` (``BatchNorm.group``: their statistics over the group), so the
model follows the last factory called on it. Each rank draws its own dropout
masks (``fold_in`` of the rank; rank 0 draws the one-process masks).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from clover_tpu_torch.engine.train_state import TrainState
from clover_tpu_torch.losses import (PretrainLossConfig, pretrain_losses, qa_loss, retrieval_loss,
                                     total_loss)
from clover_tpu_torch.models.layers import BatchNorm
from clover_tpu_torch.parallel.collectives import all_reduce_grads, rank


def ema_momentum_schedule(kind: str = "constant", base: float = 0.9998,
                          ramp_steps: int = 2000) -> Callable[[int], float]:
    """EMA momentum schedules (reference ExpMomentumEMAHook /
    LinearMomentumEMAHook)."""

    def fn(step: int) -> float:
        if kind == "constant":
            return base
        if kind == "exp":
            return 1.0 - (1.0 - base) * (float(np.exp(-step / ramp_steps)) + 1.0)
        if kind == "linear":
            return min(base, (1.0 + step) / (ramp_steps + step))
        raise ValueError(kind)

    return fn


def fold_in(generator: torch.Generator, step: int, rank: int = 0) -> torch.Generator:
    """A generator on ``generator``'s device seeded from (its seed, step),
    and the rank where it is not 0."""
    entropy = [generator.initial_seed(), step] + ([rank] if rank else [])
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=generator.device).manual_seed(int(seed[0]) >> 1)


def _finalize(state: TrainState, losses: Dict[str, torch.Tensor], ema_momentum,
              grad_clip_norm: Optional[float]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    tot = total_loss(losses)
    if callable(ema_momentum):
        ema_momentum = ema_momentum(state.step)
    grads = [p.grad for p in state.model.parameters()]
    norms = torch._foreach_norm(grads, 2, dtype=torch.float64)
    gnorm = torch.linalg.vector_norm(torch.stack(norms)).float()
    if grad_clip_norm is not None:
        # optax.clip_by_global_norm's select(norm < max, g, g / norm * max)
        keep = gnorm < grad_clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / gnorm * grad_clip_norm))
    state.apply_gradients(ema_momentum)
    metrics = dict(losses)
    metrics["loss"] = tot
    metrics["grad_norm"] = gnorm
    return state, metrics


def _train_step(model, losses_of, ema_momentum, grad_clip_norm, group) -> Callable:
    """``step(state, batch, generator) -> (state, metrics)``: the model's
    ``forward_train`` in ``train()`` mode on ``fold_in(generator,
    state.step, rank)``, ``losses_of(outputs, batch)``, backward, the
    gradients summed over ``group``, ``_finalize``. Rebinds the model's
    BatchNorm layers to ``group``."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    me = rank(group)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        model.train()
        for p in model.parameters():
            p.grad = None
        losses = losses_of(model.forward_train(batch, fold_in(generator, state.step, me)),
                           batch)
        total_loss(losses).backward()
        all_reduce_grads(model.parameters(), group)
        return _finalize(state, {k: l.detach() for k, l in losses.items()}, ema_momentum,
                         grad_clip_norm)

    return step


def make_pretrain_train_step(model, loss_cfg: PretrainLossConfig = PretrainLossConfig(),
                             ema_momentum=None, grad_clip_norm: Optional[float] = None,
                             group=None) -> Callable:
    """The tri-modal pretrain step of ``CloverPretrain``: ``step(state,
    batch, generator) -> (state, metrics)`` with metrics the loss terms of
    ``pretrain_losses`` (``mlm_loss``, ``nce_loss``, ``rank_t_tm_loss``,
    ``v_nce_loss``, ``rank_v_vm_loss``), ``loss`` and ``grad_norm``.
    ``batch`` holds ``imgs``, ``token_ids``, ``input_mask``, ``mlm_label``
    and ``v_token_mask`` on the model's device; otherwise as
    ``make_retrieval_train_step``."""
    return _train_step(model, lambda out, batch: pretrain_losses(out, batch["mlm_label"],
                                                                 loss_cfg, group),
                       ema_momentum, grad_clip_norm, group)


def make_retrieval_train_step(model, temperature: float = 0.05, cos_sim: bool = True,
                              ema_momentum=None, grad_clip_norm: Optional[float] = None,
                              group=None) -> Callable:
    """Retrieval-finetune step: ``step(state, batch, generator) -> (state,
    metrics)`` with metrics ``retrieval_nce_loss``, ``loss`` and
    ``grad_norm`` (0-d tensors). ``batch`` holds ``imgs``, ``token_ids`` and
    ``input_mask`` on the model's device; ``generator`` is the run's seeded
    generator on that device. The state is updated in place. After the
    step the parameters' ``.grad`` hold the gradients the update used. With
    ``group`` the batch is this rank's slice of the global batch (module
    docstring)."""

    return _train_step(model, lambda out, batch: retrieval_loss(*out, temperature=temperature,
                                                               cos_sim=cos_sim, group=group),
                       ema_momentum, grad_clip_norm, group)


def make_qa_train_step(model, ema_momentum=None, grad_clip_norm: Optional[float] = None,
                       group=None) -> Callable:
    """QA / FIB finetune step: ``step(state, batch, generator) -> (state,
    metrics)`` with metrics ``qa_loss`` (CE of ``forward_train``'s (B,
    num_choices) logits against ``batch["label"]``), ``loss`` and
    ``grad_norm``; otherwise as ``make_retrieval_train_step``."""
    return _train_step(model, lambda out, batch: qa_loss(out, batch["label"], group),
                       ema_momentum, grad_clip_norm, group)


def make_embed_eval_step(model) -> Callable:
    """Dual-tower retrieval-eval step:
    ``step(imgs, token_ids, input_mask, bias_cache=None) -> (v_emb, t_emb)``.

    The parameters live in ``model``; ``bias_cache`` (optional) is
    ``swin_bias_cache(...)``, the precomputed relative-position biases."""

    def step(imgs, token_ids, input_mask, bias_cache=None):
        with torch.inference_mode():
            return model.forward_test(imgs, token_ids, input_mask, bias_cache)

    return step


def make_qa_eval_step(model) -> Callable:
    """QA / FIB eval step: ``step(imgs, token_ids, input_mask,
    bias_cache=None) -> (B, num_choices)`` scores (``forward_test``)."""
    return make_embed_eval_step(model)


def make_itm_embed_step(model) -> Callable:
    """The ITM retrieval eval's per-batch step: ``step(imgs, token_ids,
    input_mask, bias_cache=None) -> (visual tokens (B, T, S, C), v_emb,
    t_emb)``, the Swin tokens ``encode_visual`` caches and the dual-tower
    embeddings, from one Swin pass (the JAX step's two calls of the same
    backbone on the same clips)."""

    def step(imgs, token_ids, input_mask, bias_cache=None):
        with torch.inference_mode():
            tokens = model.encode_visual(imgs, token_ids.shape[0], bias_cache)
            # forward_vision pools over (T, H, W); (T, S, 1) holds the same tokens
            v = model.ssl_head.forward_vision(tokens[:, :, :, None])
            return tokens, v, model.forward_text(token_ids, input_mask)

    return step


def make_itm_score_step(model) -> Callable:
    """``step(visual_tokens, token_ids, input_mask) -> (B,)`` fp32 fused
    match probabilities of aligned (cached video tokens, text) pairs."""

    def step(visual_tokens, token_ids, input_mask):
        with torch.inference_mode():
            return model.itm_pair_score(visual_tokens, token_ids, input_mask)

    return step
