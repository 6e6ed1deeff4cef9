"""Eval step factories (port of ``clover_tpu/engine/steps.py``)."""

from __future__ import annotations

from typing import Callable

import torch


def make_embed_eval_step(model) -> Callable:
    """Dual-tower retrieval-eval step:
    ``step(imgs, token_ids, input_mask, bias_cache=None) -> (v_emb, t_emb)``.

    The parameters live in ``model``; ``bias_cache`` (optional) is
    ``swin_bias_cache(...)``, the precomputed relative-position biases."""

    def step(imgs, token_ids, input_mask, bias_cache=None):
        with torch.inference_mode():
            return model.forward_test(imgs, token_ids, input_mask, bias_cache)

    return step
