"""Transformer MLP half-blocks with the hidden kept on chip (kernels K2, K3).

- ``fused_ln_mlp_residual``: ``x + gelu(LN(x) W1^T + b1) W2^T + b2``, the
  Swin pre-LN half (port of ``clover_tpu/ops/mlp_block.py::
  fused_ln_mlp_residual``, eval form: no row scale, no stash).
- ``fused_mlp_postln``: ``LN(x + gelu_erf(x W1^T + b1) W2^T + b2)``, the
  BERT post-LN half (port of ``::fused_mlp_postln``).

Both launch ``csrc/mlp_block.cu`` for a CUDA tensor and run their plain
version for a CPU tensor. Weights are torch ``Linear`` layouts: ``w1``
(H, C), ``w2`` (C, H); parameters may be fp32 and are cast to x's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops.layer_norm import layer_norm_plain

_GELU = {"tanh": "tanh", "erf": "none"}
_HIDDEN_CHUNK = 128      # the kernels walk the hidden in chunks of 128 columns
# K3 splits the hidden over this many blocks per 32 rows: BERT-base's
# B*L = 960 rows make 30 row blocks, too few for the card's 132 SMs
_POSTLN_SPLITS = 4


def ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                          gelu: str = "erf"):
    """Plain PyTorch version of ``fused_ln_mlp_residual`` (x: (rows, C))."""
    dt = x.dtype
    xn = layer_norm_plain(x, ln_w, ln_b, eps)
    h = F.linear(xn, w1.to(dt), b1.to(dt))
    h = F.gelu(h.float(), approximate=_GELU[gelu]).to(dt)
    y = F.linear(h, w2.to(dt), b2.to(dt))
    return (x.float() + y.float()).to(dt)


def mlp_postln_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-12):
    """Plain PyTorch version of ``fused_mlp_postln`` (x: (rows, C))."""
    dt = x.dtype
    h = F.linear(x, w1.to(dt), b1.to(dt))
    h = F.gelu(h.float()).to(dt)
    y = F.linear(h, w2.to(dt), b2.to(dt))
    return layer_norm_plain(x.float() + y.float(), ln_w, ln_b, eps).to(dt)


def _kernel_args(x, ln_w, ln_b, w1, b1, w2, b2, widths, hidden_multiple):
    rows, C = x.shape
    H = w1.shape[0]
    dev = x.device
    _build.require(x, "x", torch.bfloat16, dev)
    w1b, w2b = w1.to(torch.bfloat16).contiguous(), w2.to(torch.bfloat16).contiguous()
    _build.require(w1b, "w1", torch.bfloat16, dev, (H, C))
    _build.require(w2b, "w2", torch.bfloat16, dev, (C, H))
    for name, t, n in (("ln_w", ln_w, C), ("ln_b", ln_b, C), ("b1", b1, H), ("b2", b2, C)):
        _build.require(t, name, torch.float32, dev, (n,))
    if C not in widths or H % hidden_multiple:
        raise ValueError(f"MLP kernel takes C in {widths} and H % {hidden_multiple} == 0; "
                         f"got C={C}, H={H}")
    out = torch.empty_like(x)
    # w1b/w2b must outlive the launch call, so the caller holds them until
    # then; freed after it, the caching allocator only reuses their memory
    # for work queued later on the same stream
    return out, (x, ln_w, ln_b, w1b, b1, w2b, b2, out)


def fused_ln_mlp_residual(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                          gelu: str = "erf"):
    """``x + MLP(LN(x))`` over 2-D x (rows, C); gelu is 'erf' or 'tanh'."""
    if gelu not in _GELU:
        raise ValueError(f"gelu must be 'erf' or 'tanh', got {gelu!r}")
    if not x.is_cuda:
        return ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu)
    out, bufs = _kernel_args(x, ln_w, ln_b, w1, b1, w2, b2, (128, 256, 512, 1024),
                             _HIDDEN_CHUNK)
    _build.launch("clover_ln_mlp_residual", *bufs, *x.shape, w1.shape[0], float(eps),
                  int(gelu == "tanh"), _build.stream(x.device))
    fused_ln_mlp_residual.launches += 1
    return out


def fused_mlp_postln(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-12):
    """``LN(x + fc2(gelu_erf(fc1(x))))`` over 2-D x (rows, C)."""
    if not x.is_cuda:
        return mlp_postln_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    out, bufs = _kernel_args(x, ln_w, ln_b, w1, b1, w2, b2, (768,),
                             _POSTLN_SPLITS * _HIDDEN_CHUNK)
    # the splits' fp32 partial sums, added up by the kernel's second pass
    partial = torch.empty((_POSTLN_SPLITS,) + tuple(x.shape), dtype=torch.float32,
                          device=x.device)
    _build.launch("clover_mlp_postln", *bufs, partial, *x.shape, w1.shape[0],
                  _POSTLN_SPLITS, float(eps), _build.stream(x.device))
    fused_mlp_postln.launches += 1
    return out


fused_ln_mlp_residual.launches = 0
fused_mlp_postln.launches = 0
