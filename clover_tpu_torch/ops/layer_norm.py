"""LayerNorm over the last axis with fp32 statistics (kernel K4).

``fused_layer_norm`` launches the CUDA kernel (``csrc/layer_norm.cu``) for a
CUDA tensor, as :func:`k4_plan` plans it, and runs :func:`layer_norm_plain`
for a CPU tensor. Port of ``clover_tpu/ops/layer_norm.py::fused_layer_norm``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from clover_tpu_torch.ops import _build

_K4_WARPS = 4   # warps a block (kWarps in csrc/layer_norm.cu)
# C -> the instance csrc/layer_norm.cu builds for it: (threads, vectors,
# rows_per_group); Swin-B's stage, merging and final norms and BERT-base's
_K4_INSTANCES = {128: (16, 1, 2), 256: (32, 1, 2), 512: (32, 2, 2), 768: (32, 3, 1),
                 1024: (32, 4, 2), 2048: (32, 8, 1)}
_K4_STEPS = 3   # steps a warp walks


class K4Plan(NamedTuple):
    """K4's launch plan (:func:`k4_plan`)."""
    threads: int          # lanes a row
    vectors: int          # 16-byte vectors a lane holds of each row (0: the generic path)
    rows_per_group: int   # rows a lane group takes a step
    block_rows: int       # rows a block takes a step
    blocks: int


@functools.lru_cache(maxsize=None)
def k4_plan(rows: int, C: int, sms: int) -> K4Plan:
    """K4's plan for ``rows`` rows of width ``C`` on a card of ``sms`` SMs;
    the C entry point refuses plans it has no instance for.

    A width with an instance takes ``32 / threads * rows_per_group`` rows a
    warp step, and the blocks walk the steps with a stride, ``_K4_STEPS``
    steps a warp (at least a block an SM, at most a block a step); any
    other even C takes the generic path, a warp a row and a block per
    ``_K4_WARPS`` rows."""
    if C <= 0 or C % 2:
        raise ValueError(f"fused_layer_norm: C={C} must be even")
    if C not in _K4_INSTANCES:
        return K4Plan(32, 0, 1, _K4_WARPS, -(-rows // _K4_WARPS))
    threads, vectors, rpg = _K4_INSTANCES[C]
    block_rows = _K4_WARPS * 32 // threads * rpg
    need = -(-rows // block_rows)
    return K4Plan(threads, vectors, rpg, block_rows,
                  min(need, max(sms, -(-need // _K4_STEPS))))


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: stats in fp32, output in x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of ``x`` (..., C); fp32 ``weight``/``bias`` of shape (C,)."""
    if not x.is_cuda:
        return layer_norm_plain(x, weight, bias, eps)
    C = x.shape[-1]
    dev = x.device
    # a contiguous x goes as it is (no reshape or view: host time a call)
    x2 = x if x.is_contiguous() else x.reshape(-1, C)
    _build.require(x2, "x", torch.bfloat16, dev)
    _build.require(weight, "weight", torch.float32, dev, (C,))
    _build.require(bias, "bias", torch.float32, dev, (C,))
    rows = x2.numel() // C if C else 0
    p = k4_plan(rows, C, _build.sms(dev))
    out = torch.empty_like(x2)
    # every pointer's tensor is held here until the launch is queued
    _build.check("clover_layer_norm", _build.entry("clover_layer_norm")(
        x2.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, C, p.threads,
        p.vectors, p.rows_per_group, p.blocks, float(eps), _build.stream(dev)))
    fused_layer_norm.launches += 1
    return out if x2 is x else out.view(x.shape)


fused_layer_norm.launches = 0
