"""Transformer MLP half-blocks with the hidden kept on chip (kernels K2, K3).

- ``fused_ln_mlp_residual``: ``x + gelu(LN(x) W1^T + b1) W2^T + b2``, the
  Swin pre-LN half (port of ``clover_tpu/ops/mlp_block.py::
  fused_ln_mlp_residual``, eval form: no row scale, no stash).
- ``fused_ln_mlp_residual_stash``: the same half in its training form (the
  JAX ``_forward(..., want_stash=True)``): ``x + s * MLP(LN(x))`` with the
  optional per-row DropPath scale s, and the stash the backward reads
  (z = LN(x) W1^T + b1 in x's dtype, the LN mean and rstd in fp32).
  ``ln_mlp_residual_bwd_stash`` is that backward (the JAX
  ``_xla_backward_stash``, plain PyTorch GEMMs), and
  ``FusedLnMlpResidualFn`` ties the two into autograd.
- ``fused_mlp_postln``: ``LN(x + gelu_erf(x W1^T + b1) W2^T + b2)``, the
  BERT post-LN half (port of ``::fused_mlp_postln``).
- ``fused_mlp_postln_dropout``: the same half in training, with its hidden
  dropout as a precomputed {0, 1/keep} fp32 mask m:
  ``LN(x + m * (fc2(gelu_erf(fc1(x))) + b2))`` (port of
  ``::fused_mlp_postln_dropout``); ``mlp_postln_mask_bwd`` is its backward
  (the JAX ``_xla_backward_postln_mask``, plain PyTorch GEMMs), and
  ``FusedMlpPostlnDropoutFn`` ties the two into autograd.

The wrappers launch ``csrc/mlp_block.cu`` for a CUDA tensor and run their
plain version for a CPU tensor. Weights are torch ``Linear`` layouts: ``w1``
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
                          gelu: str = "erf", row_scale=None, want_stash: bool = False):
    """Plain PyTorch version of ``fused_ln_mlp_residual`` (x: (rows, C)) and,
    with ``row_scale`` (rows,) / ``want_stash``, of its training form:
    -> out, or (out, (z, mean, rstd)) with ``want_stash``."""
    dt = x.dtype
    xn = layer_norm_plain(x, ln_w, ln_b, eps)
    z = F.linear(xn, w1.to(dt), b1.to(dt))
    h = F.gelu(z.float(), approximate=_GELU[gelu]).to(dt)
    y = F.linear(h, w2.to(dt), b2.to(dt)).float()
    if row_scale is not None:
        y = y * row_scale.float()[:, None]
    out = (x.float() + y).to(dt)
    if not want_stash:
        return out
    x32 = x.float()
    mean = x32.mean(-1)
    xc = x32 - mean[:, None]
    return out, (z, mean, torch.rsqrt((xc * xc).mean(-1) + eps))


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
    _build.launch("clover_ln_mlp_residual", *bufs[:7], None, out, None, None, None, *x.shape,
                  w1.shape[0], float(eps), int(gelu == "tanh"), _build.stream(x.device))
    fused_ln_mlp_residual.launches += 1
    return out


def fused_ln_mlp_residual_stash(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                                gelu: str = "erf", row_scale=None):
    """Training form of ``fused_ln_mlp_residual``: -> (x + row_scale * MLP(LN(x)),
    (z (rows, H) in x's dtype, mean (rows,) fp32, rstd (rows,) fp32))."""
    if gelu not in _GELU:
        raise ValueError(f"gelu must be 'erf' or 'tanh', got {gelu!r}")
    if not x.is_cuda:
        return ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu, row_scale,
                                     want_stash=True)
    out, bufs = _kernel_args(x, ln_w, ln_b, w1, b1, w2, b2, (128, 256, 512, 1024),
                             _HIDDEN_CHUNK)
    rows, H = x.shape[0], w1.shape[0]
    if row_scale is not None:
        _build.require(row_scale, "row_scale", torch.float32, x.device, (rows,))
    z = torch.empty((rows, H), dtype=x.dtype, device=x.device)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    _build.launch("clover_ln_mlp_residual", *bufs[:7], row_scale, out, z, mean, rstd, *x.shape,
                  H, float(eps), int(gelu == "tanh"), _build.stream(x.device))
    fused_ln_mlp_residual_stash.launches += 1
    return out, (z, mean, rstd)


def _mm_f32(a, b):
    """a @ b of compute-dtype operands with an fp32 (or wider) result, as
    ``preferred_element_type=f32`` gives it in the JAX package (cuBLAS's
    bf16-in / fp32-out GEMM on the card)."""
    if a.dtype in (torch.float32, torch.float64):
        return torch.mm(a, b)
    if not a.is_cuda:   # no mixed-dtype mm on the CPU; bf16 products are exact in fp32
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


def ln_mlp_residual_bwd_stash(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, stash,
                              eps: float, gelu: str, g):
    """Backward of the training form from its stash: port of the JAX
    ``_xla_backward_stash`` (with its default bf16 crossing of dh). Every
    product takes compute-dtype operands; dx comes back in x's dtype, the
    parameter gradients in fp32. ``row_scale`` takes no gradient. GELU and
    dz = dh * GELU'(z) over the (rows, H) hidden are one elementwise pass
    each, in fp32 arithmetic rounded once to x's dtype.
    -> (dx, dln_w, dln_b, dw1, db1, dw2, db2)."""
    del eps   # the stash carries the LN statistics
    z_b, mean, rstd = stash
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    xn_raw = (x.to(acc) - mean[:, None]) * rstd[:, None]
    y_b = (xn_raw * ln_w + ln_b).to(dt)
    w1_b, w2_b = w1.to(dt), w2.to(dt)
    h_b = F.gelu(z_b, approximate=_GELU[gelu])
    g32 = g.to(acc)
    gy = g32 * row_scale.to(acc)[:, None] if row_scale is not None else g32
    gy_b = gy.to(dt)
    dh_b = torch.mm(gy_b, w2_b)                       # crosses as dt, like _BWD_HBM_BF16
    dz_b = torch.ops.aten.gelu_backward(dh_b, z_b, approximate=_GELU[gelu])
    dy = _mm_f32(dz_b, w1_b)
    dw1 = _mm_f32(dz_b.t(), y_b)
    db1 = dz_b.to(acc).sum(0)
    dw2 = _mm_f32(gy_b.t(), h_b)
    db2 = gy.sum(0)
    dyt = dy * ln_w
    m1 = dyt.mean(-1, keepdim=True)
    m2 = (dyt * xn_raw).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dyt - m1 - xn_raw * m2) + g32
    dln_w = (dy * xn_raw).sum(0)
    dln_b = dy.sum(0)
    return (dx.to(dt), dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype), dw1.to(w1.dtype),
            db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


class FusedLnMlpResidualFn(torch.autograd.Function):
    """The Swin MLP half in training: forward K2's stash form
    (``kernels=True``; its plain version for CPU tensors) or the plain one
    (``kernels=False``), backward ``ln_mlp_residual_bwd_stash``.

    ``FusedLnMlpResidualFn.apply(x, ln_w, ln_b, w1, b1, w2, b2, row_scale,
    eps, gelu, kernels)``"""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps, gelu, kernels):
        if kernels:
            out, stash = fused_ln_mlp_residual_stash(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu,
                                                     row_scale)
        else:
            out, stash = ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu,
                                               row_scale, want_stash=True)
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, *stash)
        ctx.args = (eps, gelu)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w1, b1, w2, b2, row_scale, *stash = ctx.saved_tensors
        grads = ln_mlp_residual_bwd_stash(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, stash,
                                          *ctx.args, g.contiguous())
        return (*grads, None, None, None, None)


def _launch_postln(x, ln_w, ln_b, w1, b1, w2, b2, mask, eps):
    """K3 (mask None) or K3M: out = LN(x + [mask *] (fc2(gelu(fc1 x)) + b2))."""
    out, bufs = _kernel_args(x, ln_w, ln_b, w1, b1, w2, b2, (768,),
                             _POSTLN_SPLITS * _HIDDEN_CHUNK)
    if mask is not None:
        _build.require(mask, "mask", torch.float32, x.device, x.shape)
    # the splits' fp32 partial sums, added up by the kernel's second pass
    partial = torch.empty((_POSTLN_SPLITS,) + tuple(x.shape), dtype=torch.float32,
                          device=x.device)
    _build.launch("clover_mlp_postln", *bufs, mask, partial, *x.shape, w1.shape[0],
                  _POSTLN_SPLITS, float(eps), _build.stream(x.device))
    return out


def fused_mlp_postln(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-12):
    """``LN(x + fc2(gelu_erf(fc1(x))))`` over 2-D x (rows, C)."""
    if not x.is_cuda:
        return mlp_postln_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    out = _launch_postln(x, ln_w, ln_b, w1, b1, w2, b2, None, eps)
    fused_mlp_postln.launches += 1
    return out


def mlp_postln_mask_plain(x, ln_w, ln_b, w1, b1, w2, b2, mask, eps: float = 1e-12):
    """Plain PyTorch version of ``fused_mlp_postln_dropout`` (the JAX
    ``_xla_reference_postln_mask``): the hidden and y = fc2(h) + b2 in fp32
    (``preferred_element_type=f32``), h rounded once to x's dtype for fc2,
    then LN(x + y * mask) in fp32. ``mask`` None is a mask of ones."""
    dt = x.dtype
    h = F.gelu(_mm_f32(x, w1.to(dt).t()) + b1).to(dt)
    y = _mm_f32(h, w2.to(dt).t()) + b2
    if mask is not None:
        y = y * mask
    return layer_norm_plain(x.float() + y, ln_w, ln_b, eps).to(dt)


def fused_mlp_postln_dropout(x, ln_w, ln_b, w1, b1, w2, b2, mask, eps: float = 1e-12):
    """``LN(x + mask * (fc2(gelu_erf(fc1(x))) + b2))`` over 2-D x (rows, C),
    ``mask`` the (rows, C) fp32 {0, 1/keep} hidden-dropout mask (None: no
    dropout). K3M on the card."""
    if not x.is_cuda:
        return mlp_postln_mask_plain(x, ln_w, ln_b, w1, b1, w2, b2, mask, eps)
    out = _launch_postln(x, ln_w, ln_b, w1, b1, w2, b2, mask, eps)
    fused_mlp_postln_dropout.launches += 1
    return out


def mlp_postln_mask_bwd(x, ln_w, ln_b, w1, b1, w2, b2, mask, eps: float, g):
    """Backward of ``fused_mlp_postln_dropout`` by recompute: port of the JAX
    ``_xla_backward_postln_mask`` with its default bf16 crossings of the
    pre-GELU hidden zpre and of dh (``_BWD_HBM_BF16``). Every product takes
    compute-dtype operands with an fp32 result; dx comes back in x's dtype,
    the parameter gradients in fp32. The mask takes no gradient.
    -> (dx, dln_w, dln_b, dw1, db1, dw2, db2)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    w1_b, w2_b = w1.to(dt), w2.to(dt)
    zpre = (_mm_f32(x, w1_b.t()) + b1).to(dt).to(acc)
    h_b = F.gelu(zpre).to(dt)
    y = _mm_f32(h_b, w2_b.t()) + b2
    if mask is not None:
        y = y * mask
    z = x.to(acc) + y
    mean = z.mean(-1, keepdim=True)
    zc = z - mean
    inv = torch.rsqrt((zc * zc).mean(-1, keepdim=True) + eps)
    zn = zc * inv
    g32 = g.to(acc)
    dln_w = (g32 * zn).sum(0)
    dln_b = g32.sum(0)
    dzn = g32 * ln_w
    dz = inv * (dzn - dzn.mean(-1, keepdim=True) - zn * (dzn * zn).mean(-1, keepdim=True))
    dy = dz * mask if mask is not None else dz
    dy_b = dy.to(dt)
    dh = _mm_f32(dy_b, w2_b).to(dt).to(acc)
    dzpre_b = torch.ops.aten.gelu_backward(dh, zpre).to(dt)
    dx = (dz + _mm_f32(dzpre_b, w1_b)).to(dt)
    dw1 = _mm_f32(dzpre_b.t(), x)
    db1 = dzpre_b.to(acc).sum(0)
    dw2 = _mm_f32(dy_b.t(), h_b)
    db2 = dy.sum(0)
    return (dx, dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype), dw1.to(w1.dtype),
            db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


class FusedMlpPostlnDropoutFn(torch.autograd.Function):
    """The BERT FFN half in training on the fused route: forward K3M
    (``kernels=True``; its plain version for CPU tensors) or the plain one
    (``kernels=False``), backward ``mlp_postln_mask_bwd``.

    ``FusedMlpPostlnDropoutFn.apply(x, ln_w, ln_b, w1, b1, w2, b2, mask,
    eps, kernels)``"""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, mask, eps, kernels):
        op = fused_mlp_postln_dropout if kernels else mlp_postln_mask_plain
        out = op(x, ln_w, ln_b, w1, b1, w2, b2, mask, eps)
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2, mask)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        *args, mask = ctx.saved_tensors
        grads = mlp_postln_mask_bwd(*args, mask, ctx.eps, g.contiguous())
        return (*grads, None, None, None)


fused_ln_mlp_residual.launches = 0
fused_ln_mlp_residual_stash.launches = 0
fused_mlp_postln.launches = 0
fused_mlp_postln_dropout.launches = 0
