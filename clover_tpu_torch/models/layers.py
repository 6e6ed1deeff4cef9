"""Shared building blocks (port of ``clover_tpu/models/layers.py``).

Dtype policy as in the JAX package: parameters are fp32, compute runs in
the dtype of the activations (bf16 on the card, fp32 in the CPU tests),
LayerNorm statistics and softmax are fp32. Randomness in training (dropout,
DropPath) is drawn from an explicit ``torch.Generator`` on the activations'
device, which the caller passes down the forward.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from clover_tpu_torch.ops import library
from clover_tpu_torch.ops.layer_norm import layer_norm_plain
from clover_tpu_torch.parallel.collectives import all_reduce_with_grad


class Linear(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in x's dtype.

    ``init`` names the initializer :func:`init_params` applies, as the JAX
    modules pick theirs: 'trunc_normal' (std .02, Swin), 'normal' (std .02,
    BERT), 'xavier' (projection heads)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init: str = "trunc_normal"):
        super().__init__(in_features, out_features, bias=bias)
        self.init = init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, output in the input's dtype.

    ``kernel=True`` marks the sites the JAX package runs through its fused
    LayerNorm kernel (``LayerNormAuto`` with ``fwd_only``, i.e. outside
    training); they go through the K4 op (``library.k4_layer_norm``:
    ``fused_layer_norm`` on the card) in eval mode and plain in training, as
    there. The other sites (e.g. the projector norms) stay plain, as in the
    reference."""

    def __init__(self, dim: int, eps: float = 1e-5, kernel: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.kernel = kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel and not self.training:
            return library.k4_layer_norm(x, self.weight, self.bias, self.eps)
        return layer_norm_plain(x, self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    """fc1 / fc2 of the transformer MLP (reference swin_transformer_3d.py
    :250-268). The block runs them through ``fused_ln_mlp_residual``; the
    forward is the plain route with its dropouts (the JAX ``Mlp``): fc1,
    GELU ('tanh' or 'erf'), dropout, fc2, dropout, the dropouts at ``rate``
    from ``generator`` in training."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor, gelu: str = "tanh", rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.gelu(self.fc1(x), approximate="tanh" if gelu == "tanh" else "none")
        h = dropout(h, rate, generator, self.training)
        return dropout(self.fc2(h), rate, generator, self.training)


def _keep_mask(shape, keep: float, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator")
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """The fp32 {0, 1/keep} mask of inverted dropout at ``rate``, one
    Bernoulli(keep) draw per element (the fused FFN route takes it as a
    tensor)."""
    keep = 1.0 - rate
    return _keep_mask(shape, keep, generator, device).float() / keep


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): x / keep where a Bernoulli(keep)
    draw holds, else 0; the identity outside training or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth (port of ``clover_tpu/models/layers.py::
    DropPath``): each sample of the leading axis keeps its branch with
    probability 1 - rate, scaled by 1 / (1 - rate)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def active(self) -> bool:
        return self.training and self.rate > 0.0

    def sample_scale(self, n: int, generator: Optional[torch.Generator],
                     device) -> torch.Tensor:
        """(n,) fp32 per-sample factor keep_mask / keep_prob (one draw)."""
        keep = 1.0 - self.rate
        return _keep_mask((n,), keep, generator, device).float() / keep

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.active():
            return x
        keep = 1.0 - self.rate
        mask = _keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), keep, generator, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def remat(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args, generator=generator)`` with its activations recomputed in the
    backward instead of saved (the port's ``nn.remat``):
    ``torch.utils.checkpoint`` (non-reentrant) around the call. The
    checkpoint restores only the global RNG, and the port draws dropout and
    DropPath from ``generator``; so the recompute runs on a fresh generator
    set to ``generator``'s state before the call, draws the forward's masks
    again, and leaves the live generator where the forward left it."""
    state = None if generator is None else generator.get_state()
    replays = []

    def run(*a):
        gen = generator
        if replays:   # the backward's recompute
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        elif generator is not None:
            replays.append(True)
        return fn(*a, generator=gen)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the leading
    axes of (..., C): ``weight`` / ``bias`` (flax ``scale`` / ``bias``), the
    running statistics as buffers ``mean`` / ``var`` (flax ``batch_stats``).
    In training it normalizes with the batch's fp32 mean and its biased
    variance max(0, E[x^2] - E[x]^2) and updates ra = 0.9 ra + 0.1 batch
    with the same two (``nn.BatchNorm1d`` keeps the unbiased variance); in
    eval it uses the running statistics. Output in x's dtype.

    ``group`` (a process group; None: this process alone, set by the train
    steps) makes the batch the global one, as flax's over a sharded batch:
    the row sums of x and x^2 and the row count are all-reduced, with the
    gradient, so the running statistics stay equal on every rank."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum, self.eps = momentum, eps
        self.group = None

    def _moments(self, xf: torch.Tensor):
        """(E[x], E[x^2]) over the rows of xf, the group's rows under a group."""
        rows = torch.full((1, xf.shape[1]), float(xf.shape[0]), device=xf.device)
        sums = all_reduce_with_grad(torch.cat([xf.sum(dim=0, keepdim=True),
                                               (xf * xf).sum(dim=0, keepdim=True), rows]),
                                    self.group)
        return sums[0] / sums[2], sums[1] / sums[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, sq = self._moments(x.float().reshape(-1, x.shape[-1]))
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (x.float() - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


class ProjectorNorm(nn.Module):
    """The contrastive heads' projector norm (the reference's ``ln`` switch):
    LayerNorm (every live config; a plain LayerNorm, not a kernel site) or,
    with ``use_ln=False``, :class:`BatchNorm`, as ``norm``."""

    def __init__(self, features: int, use_ln: bool = True):
        super().__init__()
        self.norm = LayerNorm(features) if use_ln else BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


@torch.no_grad()
def _draw(t: torch.Tensor, generator: torch.Generator, fill) -> None:
    """fill(buffer, generator) on a buffer on the generator's device, copied
    into t: the same seed gives the same values whatever t's device."""
    buf = torch.empty(t.shape, dtype=t.dtype, device=generator.device)
    fill(buf, generator)
    t.copy_(buf)


def trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = 0.02) -> None:
    """timm's trunc_normal_(std=.02): cut at two standard deviations."""
    _draw(t, generator, lambda b, g: nn.init.trunc_normal_(b, std=std, a=-2 * std, b=2 * std,
                                                           generator=g))


def normal_(t: torch.Tensor, generator: torch.Generator, std: float = 0.02) -> None:
    """normal(std=.02), the BERT and embedding initializer."""
    _draw(t, generator, lambda b, g: nn.init.normal_(b, std=std, generator=g))


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights with the JAX package's initializers, drawn on
    the generator's device (the CPU's for a ``torch.Generator()``) and copied
    to each parameter's device. Modules that own raw parameters initialise
    them in ``init_weights(generator)``."""
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)
        elif isinstance(m, Linear):
            if m.init == "xavier":
                bound = math.sqrt(6.0 / (m.in_features + m.out_features))
                _draw(m.weight, generator,
                      lambda b, g: nn.init.uniform_(b, -bound, bound, generator=g))
            elif m.init == "normal":
                normal_(m.weight, generator)
            else:
                trunc_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, generator)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
