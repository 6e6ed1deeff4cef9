"""Train state (port of ``clover_tpu/engine/train_state.py``): the step
count, the model (which holds the parameters), its AdamW optimizer with the
lr schedule, and an optional EMA copy of the parameters.

Unlike the JAX pytree, the state is updated in place: the parameters,
moments and EMA copy are large, and one copy of each is what a train step
needs."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], ema: bool = False) -> "TrainState":
        ema_params = ({n: p.detach().clone() for n, p in model.named_parameters()}
                      if ema else None)
        return cls(model, optimizer, schedule, 0, ema_params)

    @torch.no_grad()
    def apply_gradients(self, ema_momentum: Optional[float] = None) -> "TrainState":
        """One AdamW update from the parameters' ``.grad`` at lr
        schedule(step), then the EMA update e * m + p * (1 - m) on the new
        parameters."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if self.ema_params is not None and ema_momentum is not None:
            for name, p in self.model.named_parameters():
                e = self.ema_params[name]
                e.copy_(e * ema_momentum + p * (1.0 - ema_momentum))
        self.step += 1
        return self
