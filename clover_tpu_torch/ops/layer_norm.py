"""LayerNorm over the last axis with fp32 statistics (kernel K4).

``fused_layer_norm`` launches the CUDA kernel (``csrc/layer_norm.cu``) for a
CUDA tensor and runs :func:`layer_norm_plain` for a CPU tensor. Port of
``clover_tpu/ops/layer_norm.py::fused_layer_norm``.
"""

from __future__ import annotations

import torch

from clover_tpu_torch.ops import _build


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
    x2 = x.reshape(-1, C)
    _build.require(x2, "x", torch.bfloat16, x.device)
    _build.require(weight, "weight", torch.float32, x.device, (C,))
    _build.require(bias, "bias", torch.float32, x.device, (C,))
    if C % 2:
        raise ValueError(f"fused_layer_norm: C={C} must be even")
    out = torch.empty_like(x2)
    _build.launch("clover_layer_norm", x2, weight, bias, out, x2.shape[0], C, float(eps),
                  _build.stream(x.device))
    fused_layer_norm.launches += 1
    return out.view(x.shape)


fused_layer_norm.launches = 0
