"""Optimizer and LR schedules (port of ``clover_tpu/engine/optim.py``).

AdamW with betas (0.9, 0.98), eps 1e-8 and the paramwise weight-decay
exemptions, decided on each parameter's leaf path in the JAX tree (norm
``scale``, ``bias``, ``embedding``, position tables); cosine annealing with
a linear warmup. The schedule is a plain function of the update count,
evaluated before each update as optax does (the first update uses
``schedule(0)``). torch's AdamW applies the decay to the old parameter and
adds eps outside the square root, as optax's ``adamw`` does; gradient
clipping happens in the train step (``engine/steps.py``), as in the JAX
package's ``_finalize``.

Freezing (the reference's ``freeze_stage`` / ``freeze_except``) is decided
on the same '/'-joined JAX leaf paths (``freeze_by_prefix``,
``freeze_mask_from_cfg``), so one config string freezes the same tensors in
both packages. ``make_optimizer(freeze_mask=...)`` is optax's
``multi_transform`` with ``set_to_zero`` on the frozen leaves: they stay out
of AdamW's groups (no update, no weight decay, no moments) but keep
``requires_grad``, so the step's global gradient norm and its clip still
count their gradients, as the JAX step's do.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from clover_tpu_torch.models.bridge import jax_leaf_paths

# parameter-path fragments that receive zero weight decay
NO_DECAY_LEAVES = ("bias", "scale", "embedding")
NO_DECAY_NAMES = (
    "relative_position_bias_table",
    "vis_space_pos",
    "vis_tempor_pos",
    "mask_token",
    "all_cls_token",
    "prompt_token",
    "absolute_pos_embed",
)

Schedule = Callable[[int], float]


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True where weight decay applies (matrix kernels)}."""
    return {name: path[-1] not in NO_DECAY_LEAVES and not any(k in NO_DECAY_NAMES for k in path)
            for name, path in jax_leaf_paths(model).items()}


def _linear(init: float, end: float, steps: int) -> Schedule:
    return lambda count: init + (end - init) * min(max(count, 0), steps) / steps


def _join(warmup: Schedule, after: Schedule, boundary: int) -> Schedule:
    return lambda count: warmup(count) if count < boundary else after(count - boundary)


def cosine_warmup_schedule(base_lr: float, total_steps: int, warmup_steps: int,
                           warmup_start_ratio: float = 0.001,
                           min_lr_ratio: float = 0.0) -> Schedule:
    """Linear warmup from base_lr*warmup_start_ratio, cosine decay to
    base_lr*min_lr_ratio (optax linear_schedule + cosine_decay_schedule,
    joined at warmup_steps)."""
    decay_steps = max(1, total_steps - warmup_steps)

    def cosine(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return base_lr * ((1 - min_lr_ratio) * 0.5 * (1 + math.cos(math.pi * frac))
                          + min_lr_ratio)

    if warmup_steps <= 0:
        return cosine
    return _join(_linear(base_lr * warmup_start_ratio, base_lr, warmup_steps), cosine,
                 warmup_steps)


def linear_annealing_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                              warmup_start_ratio: float = 0.001,
                              min_lr_ratio: float = 0.0) -> Schedule:
    """Linear decay to base_lr*min_lr_ratio after an optional linear warmup."""
    decay = _linear(base_lr, base_lr * min_lr_ratio, max(1, total_steps - warmup_steps))
    if warmup_steps <= 0:
        return decay
    return _join(_linear(base_lr * warmup_start_ratio, base_lr, warmup_steps), decay,
                 warmup_steps)


def step_schedule(base_lr: float,
                  boundaries_and_scales: Union[Mapping[int, float], Sequence[Tuple[int, float]]]
                  ) -> Schedule:
    """mmcv's StepLrUpdater as optax's ``piecewise_constant_schedule``: each
    (boundary, scale), in boundary order, multiplies the lr from count >=
    boundary on; the scales compound."""
    steps = sorted(dict(boundaries_and_scales).items())

    def schedule(count: int) -> float:
        lr = base_lr
        for boundary, scale in steps:
            if count >= boundary:
                lr *= scale
        return lr

    return schedule


SCHEDULES = {"cosine": cosine_warmup_schedule, "linear": linear_annealing_schedule}


def _joined_paths(model: nn.Module) -> Dict[str, str]:
    """{parameter name: its '/'-joined leaf path in the JAX tree}."""
    return {name: "/".join(path) for name, path in jax_leaf_paths(model).items()}


def freeze_by_prefix(model: nn.Module, prefixes: Tuple[str, ...]) -> Dict[str, bool]:
    """{parameter name: False (frozen) where its JAX leaf path starts with one
    of the '/'-joined ``prefixes``, e.g. ('text_backbone',
    'backbone/patch_embed')}."""
    return {name: not any(path.startswith(p) for p in prefixes)
            for name, path in _joined_paths(model).items()}


def freeze_mask_from_cfg(model: nn.Module, freeze_stage,
                         freeze_except=()) -> Dict[str, bool]:
    """{parameter name: True where trainable} from the reference's freeze
    config keys: a ``freeze_stage`` entry freezes every leaf whose JAX path
    contains it, a ``freeze_except`` entry keeps trainable every leaf whose
    path contains it and wins; dots in the entries become '/' (so
    'backbone.patch_embed.' and 'backbone/patch_embed' are one key)."""
    stage = tuple(s.replace(".", "/").strip("/") for s in (freeze_stage or ()))
    exempt = tuple(s.replace(".", "/").strip("/") for s in (freeze_except or ()))
    return {name: any(e in path for e in exempt) or not any(s in path for s in stage)
            for name, path in _joined_paths(model).items()}


def make_optimizer(model: nn.Module, base_lr: float, total_steps: int, warmup_steps: int = 0,
                   weight_decay: float = 0.01, betas: Tuple[float, float] = (0.9, 0.98),
                   eps: float = 1e-8, warmup_start_ratio: float = 0.001,
                   min_lr_ratio: float = 0.0, freeze_mask: Optional[Dict[str, bool]] = None,
                   policy: str = "cosine") -> Tuple[torch.optim.AdamW, Schedule]:
    """-> (AdamW over the model's parameters in a decay and a no-decay group,
    lr schedule). The train state sets each group's lr to schedule(count)
    before every update. ``freeze_mask`` ({parameter name: True where
    trainable}, as :func:`freeze_mask_from_cfg` gives it) leaves the frozen
    parameters out of both groups."""
    schedule = SCHEDULES[policy](base_lr, total_steps, warmup_steps, warmup_start_ratio,
                                 min_lr_ratio)
    mask = weight_decay_mask(model)
    named = [(n, p) for n, p in model.named_parameters()
             if freeze_mask is None or freeze_mask[n]]
    groups = [{"params": [p for n, p in named if mask[n]], "weight_decay": weight_decay},
              {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=schedule(0), betas=betas, eps=eps), schedule
