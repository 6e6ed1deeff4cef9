"""Transformer MLP half-blocks (kernels K2, K3) and the Swin half's backwards.

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
- ``fused_ln_mlp_residual_train``: the training form with the stash off
  (the JAX ``_forward(..., row_scale)`` that ``_fwd`` runs when
  ``CLOVER_MLP_STASH=0``): ``x + s * MLP(LN(x))``, nothing saved but x.
  Its backward recomputes LN, fc1 and GELU: ``ln_mlp_residual_bwd_recompute``
  (the JAX ``_xla_backward``, plain PyTorch GEMMs), K7
  (``ln_mlp_residual_bwd_onepass``, the JAX ``_backward_onepass``, as the
  passes of ``csrc/mlp_block_bwd_passes.cu``; their plain forms are
  ``ln_mlp_residual_bwd_passes``) or K8 (``ln_mlp_residual_bwd_pair``, the
  JAX ``_backward_pallas``, erf only: the same passes, counted apart),
  picked by ``FusedLnMlpResidualFn``'s ``mlp_bwd``.
- ``fused_mlp_postln``: ``LN(x + gelu_erf(x W1^T + b1) W2^T + b2)``, the
  BERT post-LN half (port of ``::fused_mlp_postln``).
- ``fused_mlp_postln_dropout``: the same half in training, with its hidden
  dropout as a precomputed {0, 1/keep} fp32 mask m:
  ``LN(x + m * (fc2(gelu_erf(fc1(x))) + b2))`` (port of
  ``::fused_mlp_postln_dropout``); ``mlp_postln_mask_bwd`` is its backward
  (the JAX ``_xla_backward_postln_mask``, plain PyTorch GEMMs), and
  ``FusedMlpPostlnDropoutFn`` ties the two into autograd.

The wrappers launch ``csrc/mlp_block.cu`` for a CUDA tensor and run their
plain version for a CPU tensor. On the card K2 and K3 run as passes over
chunks of rows (:func:`k2_plan`): K2 as LN rows, the fc1 GEMM and the fc2
GEMM with the residual (:func:`ln_mlp_residual_passes`), K3 / K3M as the
fc1 GEMM, the fc2 GEMM into an fp32 partial and the LayerNorm finish
(:func:`mlp_postln_passes`); on CPU tensors those chunk loops run each
pass's plain step. Weights are torch ``Linear`` layouts: ``w1`` (H, C),
``w2`` (C, H); parameters may be fp32 and are cast to x's dtype.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops.layer_norm import layer_norm_plain

_GELU = {"tanh": "tanh", "erf": "none"}
# K2 and K3 (csrc/mlp_block.cu) run as passes over chunks of rows whose y
# and hidden h, 2 (C + H) bf16 bytes a row, stay under _K2_CHUNK_BYTES; a
# chunk is a whole number of the GEMM passes' _K2_TILE-row tiles
_K2_CHUNK_BYTES = 256 << 20
_K2_TILE = 128
# K2's chunk also keeps its h under this many times the call's x bytes: the
# MLP half's workspace (out + h <= 3 x) then stays below the attention
# half's (LN1 output, qkv and attention output, >= 5 x), so it sets no new
# peak (one chunk, h = 4 x, did on E8P's stage 0). K3's h and fp32 partial
# (6 x) stay under the 8 x of fp32 partials its fused kernel held.
_K2_HIDDEN_OVER_X = 2
# the widths K7's passes (csrc/mlp_block_bwd_passes.cu) are built for
_K7_WIDTHS = (128, 256, 512, 1024)
# K7 (csrc/mlp_block_bwd_passes.cu): its GEMM passes' output tiles are
# _K7_TILE x _K7_TILE; its rows go in chunks whose dz and s h (two bf16
# (rows, H) buffers) stay under _K7_HIDDEN_BYTES; its LN pass takes
# _K7_LN_BLOCKS_PER_SM blocks an SM
_K7_TILE = 128
_K7_HIDDEN_BYTES = 1 << 29
_K7_LN_BLOCKS_PER_SM = 4


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


def _check_gelu(gelu: str) -> None:
    if gelu not in _GELU:
        raise ValueError(f"gelu must be 'erf' or 'tanh', got {gelu!r}")


def k2_plan(rows: int, C: int, H: int, hidden_over_x=None) -> tuple:
    """K2 / K3's chunks of rows: ((first row, rows), ...), in order. Each
    chunk's y and h, 2 (C + H) bytes a row, stay under ``_K2_CHUNK_BYTES``
    and, with ``hidden_over_x``, its h (2 H bytes a row) under that many
    times the call's x (2 rows C bytes), one tile where a tile alone is
    larger; as few chunks as that allows, each but the last the same whole
    number of ``_K2_TILE``-row tiles, the fewest that keep the count."""
    T = _K2_TILE
    per = _K2_CHUNK_BYTES // (2 * (C + H))                   # rows a chunk may hold
    if hidden_over_x is not None:
        per = min(per, hidden_over_x * rows * C // H)
    if per >= rows:
        return ((0, rows),)
    per = max(T, per // T * T)
    chunks = -(-rows // per)
    step = -(-(-(-rows // chunks)) // T) * T
    return tuple((r0, min(step, rows - r0)) for r0 in range(0, rows, step))


def _k2_ln_rows_plain(x, ln_w, ln_b, eps):
    """K2's (and K7's) LN rows: y = LN(x) ln_w + ln_b in x's dtype, from the
    fp32 (or wider) row mean and rstd. -> (y, mean, rstd)."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x32.mean(-1)
    xc = x32 - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + eps)
    return (xc * rstd[:, None] * ln_w + ln_b).to(x.dtype), mean, rstd


def _k2_fc1_plain(a, w1, b1, gelu):
    """The fc1 pass: acc = a W1^T + b1 in fp32; -> (h = gelu(acc), z = acc),
    each rounded once to a's dtype."""
    dt = a.dtype
    acc = _mm_f32(a, w1.to(dt).t()) + b1.to(torch.promote_types(dt, torch.float32))
    return F.gelu(acc, approximate=_GELU[gelu]).to(dt), acc.to(dt)


def _k2_fc2_plain(h, w2, b2, x, row_scale):
    """K2's fc2 pass: x + s (h W2^T + b2) in fp32 (s the per-row scale, or
    1), rounded once to x's dtype."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    y = _mm_f32(h, w2.to(dt).t()) + b2.to(acc)
    if row_scale is not None:
        y = y * row_scale.to(acc)[:, None]
    return (x.to(acc) + y).to(dt)


def _k3_fc2_plain(h, w2):
    """K3's fc2 pass: h W2^T as an fp32 (rows, C) partial."""
    return _mm_f32(h, w2.to(h.dtype).t())


def _k3_finish_plain(x, partial, b2, ln_w, ln_b, mask, eps):
    """K3's last pass: LN(x + b2 + partial), or with the mask LN(x +
    (partial + b2) m), in fp32, rounded to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    z = x.to(acc) + b2 + partial if mask is None else x.to(acc) + (partial + b2) * mask
    return layer_norm_plain(z, ln_w, ln_b, eps).to(x.dtype)


def _check_call(x, ln_w, ln_b, w1, b1, w2, b2, postln: bool):
    """Check a K2 / K3 call's CUDA inputs once; -> W1, W2 in bf16, which the
    caller holds until its launches are queued (freed before, their memory
    could go to a buffer the kernels write)."""
    rows, C = x.shape
    H = w1.shape[0]
    dev = x.device
    if C % _K2_TILE or H % _K2_TILE or (postln and C > 1024):
        raise ValueError(f"the MLP passes take C and H multiples of {_K2_TILE}"
                         + (", C <= 1024" if postln else "") + f"; got C={C}, H={H}")
    _build.require(x, "x", torch.bfloat16, dev)
    w1b, w2b = w1.to(torch.bfloat16).contiguous(), w2.to(torch.bfloat16).contiguous()
    _build.require(w1b, "w1", torch.bfloat16, dev, (H, C))
    _build.require(w2b, "w2", torch.bfloat16, dev, (C, H))
    for name, t, n in (("ln_w", ln_w, C), ("ln_b", ln_b, C), ("b1", b1, H), ("b2", b2, C)):
        _build.require(t, name, torch.float32, dev, (n,))
    return w1b, w2b


def ln_mlp_residual_passes(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                           gelu: str = "erf", row_scale=None, want_stash: bool = False,
                           hidden=None):
    """K2 as its passes over :func:`k2_plan`'s chunks (h under
    ``_K2_HIDDEN_OVER_X`` x x): per chunk LN rows into the chunk's rows of
    out, fc1 into the workspace ``hidden`` (the first chunk's rows by H;
    allocated when None), fc2 from it into out; the stash written in place.
    On a CUDA tensor one C call queues every chunk's kernels (the inputs
    checked and the weights cast to bf16 once a call); on a CPU tensor the
    same loop runs each pass's plain step. -> out, or (out, (z, mean,
    rstd)) with ``want_stash``."""
    rows, C = x.shape
    H = w1.shape[0]
    plan = k2_plan(rows, C, H, _K2_HIDDEN_OVER_X)
    chunk = plan[0][1]
    out = torch.empty_like(x)
    z = mean = rstd = None
    if want_stash:
        mean = torch.empty(rows, dtype=torch.promote_types(x.dtype, torch.float32),
                           device=x.device)
        z, rstd = x.new_empty((rows, H)), torch.empty_like(mean)
    hidden = x.new_empty((chunk, H)) if hidden is None else hidden
    if not x.is_cuda:
        for r0, n in plan:
            rs = slice(r0, r0 + n)
            y, m, r = _k2_ln_rows_plain(x[rs], ln_w, ln_b, eps)
            hidden[:n], zz = _k2_fc1_plain(y, w1, b1, gelu)
            if want_stash:
                z[rs], mean[rs], rstd[rs] = zz, m, r
            out[rs] = _k2_fc2_plain(hidden[:n], w2, b2, x[rs],
                                    None if row_scale is None else row_scale[rs])
        return (out, (z, mean, rstd)) if want_stash else out
    w1b, w2b = _check_call(x, ln_w, ln_b, w1, b1, w2, b2, False)
    if row_scale is not None:
        _build.require(row_scale, "row_scale", torch.float32, x.device, (rows,))
    _build.require(hidden, "hidden", torch.bfloat16, x.device, (chunk, H))
    _build.launch("clover_ln_mlp_residual", x, ln_w, ln_b, w1b, b1, w2b, b2, row_scale, hidden,
                  out, z, mean, rstd, rows, C, H, chunk, float(eps), int(gelu == "tanh"),
                  _build.stream(x.device))
    return (out, (z, mean, rstd)) if want_stash else out


def mlp_postln_passes(x, ln_w, ln_b, w1, b1, w2, b2, mask, eps: float = 1e-12, hidden=None,
                      partial=None):
    """K3 (``mask`` None) or K3M as their passes over :func:`k2_plan`'s
    chunks: fc1 with the erf GELU on x into the workspace ``hidden``
    (chunk, H), fc2 into the fp32 workspace ``partial`` (chunk, C) (each
    allocated when None), the finish (LN, the mask). On a CUDA tensor one C
    call queues every chunk's kernels (the inputs checked and the weights
    cast to bf16 once a call); on a CPU tensor the same loop runs each
    pass's plain step. -> out."""
    rows, C = x.shape
    H = w1.shape[0]
    plan = k2_plan(rows, C, H)
    chunk = plan[0][1]
    out = torch.empty_like(x)
    hidden = x.new_empty((chunk, H)) if hidden is None else hidden
    if partial is None:
        partial = torch.empty((chunk, C), device=x.device,
                              dtype=torch.promote_types(x.dtype, torch.float32))
    if not x.is_cuda:
        for r0, n in plan:
            rs = slice(r0, r0 + n)
            hidden[:n] = _k2_fc1_plain(x[rs], w1, b1, "erf")[0]
            partial[:n] = _k3_fc2_plain(hidden[:n], w2)
            out[rs] = _k3_finish_plain(x[rs], partial[:n], b2, ln_w, ln_b,
                                       None if mask is None else mask[rs], eps)
        return out
    w1b, w2b = _check_call(x, ln_w, ln_b, w1, b1, w2, b2, True)
    if mask is not None:
        _build.require(mask, "mask", torch.float32, x.device, (rows, C))
    _build.require(hidden, "hidden", torch.bfloat16, x.device, (chunk, H))
    _build.require(partial, "partial", torch.float32, x.device, (chunk, C))
    _build.launch("clover_mlp_postln", x, ln_w, ln_b, w1b, b1, w2b, b2, mask, hidden, partial,
                  out, rows, C, H, chunk, float(eps), _build.stream(x.device))
    return out


def fused_ln_mlp_residual(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                          gelu: str = "erf"):
    """``x + MLP(LN(x))`` over 2-D x (rows, C); gelu is 'erf' or 'tanh'."""
    _check_gelu(gelu)
    if not x.is_cuda:
        return ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu)
    out = ln_mlp_residual_passes(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu)
    fused_ln_mlp_residual.launches += 1
    return out


def fused_ln_mlp_residual_stash(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                                gelu: str = "erf", row_scale=None):
    """Training form of ``fused_ln_mlp_residual``: -> (x + row_scale * MLP(LN(x)),
    (z (rows, H) in x's dtype, mean (rows,) fp32, rstd (rows,) fp32))."""
    _check_gelu(gelu)
    if not x.is_cuda:
        return ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu, row_scale,
                                     want_stash=True)
    out, stash = ln_mlp_residual_passes(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu, row_scale,
                                        want_stash=True)
    fused_ln_mlp_residual_stash.launches += 1
    return out, stash


def fused_ln_mlp_residual_train(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                                gelu: str = "erf", row_scale=None):
    """Training form of ``fused_ln_mlp_residual`` with the stash off:
    x + row_scale * MLP(LN(x)) (K2 with the row scale and no stash)."""
    _check_gelu(gelu)
    if not x.is_cuda:
        return ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu, row_scale)
    out = ln_mlp_residual_passes(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu, row_scale)
    fused_ln_mlp_residual_train.launches += 1
    return out


def _mm_f32(a, b):
    """a @ b of compute-dtype operands with an fp32 (or wider) result, as
    ``preferred_element_type=f32`` gives it in the JAX package (cuBLAS's
    bf16-in / fp32-out GEMM on the card)."""
    if a.dtype in (torch.float32, torch.float64):
        return torch.mm(a, b)
    if not a.is_cuda:   # no mixed-dtype mm on the CPU; bf16 products are exact in fp32
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


def _ln_mlp_bwd(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, gelu, g, xn_raw, rstd, z_b,
                want_drs):
    """The MLP half's backward from LN's normalised x (xn_raw (rows, C),
    rstd (rows, 1)) and the pre-GELU hidden z_b in x's dtype (the bf16
    crossing of the JAX ``_BWD_HBM_BF16``). dh crosses as x's dtype too;
    GELU and dz = dh * GELU'(z) over the (rows, H) hidden are one
    elementwise pass each, in fp32 arithmetic rounded once to x's dtype; db1
    sums the rounded dz. -> (dx, dln_w, dln_b, dw1, db1, dw2, db2, drs)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    y_b = (xn_raw * ln_w + ln_b).to(dt)
    w1_b, w2_b = w1.to(dt), w2.to(dt)
    h_b = F.gelu(z_b, approximate=_GELU[gelu])
    g32 = g.to(acc)
    gy = g32 * row_scale.to(acc)[:, None] if row_scale is not None else g32
    gy_b = gy.to(dt)
    dh_b = torch.mm(gy_b, w2_b)
    dz_b = torch.ops.aten.gelu_backward(dh_b, z_b, approximate=_GELU[gelu])
    dy = _mm_f32(dz_b, w1_b)
    dw1 = _mm_f32(dz_b.t(), y_b)
    db1 = dz_b.to(acc).sum(0)
    dw2 = _mm_f32(gy_b.t(), h_b)
    db2 = gy.sum(0)
    dyt = dy * ln_w
    m1 = dyt.mean(-1, keepdim=True)
    m2 = (dyt * xn_raw).mean(-1, keepdim=True)
    dx = rstd * (dyt - m1 - xn_raw * m2) + g32
    drs = None
    if want_drs and row_scale is not None:
        mlp_out = _mm_f32(h_b, w2_b.t()) + b2
        drs = (g32 * mlp_out).sum(-1).to(row_scale.dtype)
    return (dx.to(dt), (dy * xn_raw).sum(0).to(ln_w.dtype), dy.sum(0).to(ln_b.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype), drs)


def ln_mlp_residual_bwd_stash(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, stash,
                              eps: float, gelu: str, g):
    """Backward of the training form from its stash: port of the JAX
    ``_xla_backward_stash`` (with its default bf16 crossing of dh). Every
    product takes compute-dtype operands; dx comes back in x's dtype, the
    parameter gradients in fp32. ``row_scale`` takes no gradient.
    -> (dx, dln_w, dln_b, dw1, db1, dw2, db2)."""
    del eps   # the stash carries the LN statistics
    z_b, mean, rstd = stash
    acc = torch.promote_types(x.dtype, torch.float32)
    xn_raw = (x.to(acc) - mean[:, None]) * rstd[:, None]
    return _ln_mlp_bwd(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, gelu, g, xn_raw,
                       rstd[:, None], z_b, False)[:7]


def ln_mlp_residual_bwd_recompute(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps: float,
                                  gelu: str, g, want_drs: bool = True):
    """Backward of the training form by recompute: port of the JAX
    ``_xla_backward`` with its default bf16 crossings of z and dh
    (``_BWD_HBM_BF16``; identities in fp32). Every product takes
    compute-dtype operands with an fp32 result; db1 sums the rounded dz.
    dx comes back in x's dtype, the parameter gradients in fp32, and drs =
    sum_c g * (h W2^T + b2) per row where ``row_scale`` is given (else
    None; ``want_drs=False`` skips it for autograd, where the row scale
    takes no gradient). -> (dx, dln_w, dln_b, dw1, db1, dw2, db2, drs)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xn_raw = xc * rstd
    y_b = (xn_raw * ln_w + ln_b).to(x.dtype)
    z_b = (_mm_f32(y_b, w1.to(x.dtype).t()) + b1).to(x.dtype)
    return _ln_mlp_bwd(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, gelu, g, xn_raw, rstd, z_b,
                       want_drs)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class K7Plan(NamedTuple):
    """K7's schedule (:func:`k7_plan`): rows in chunks of ``chunk_rows``;
    per chunk, pass D's row groups of ``split_rows`` rows (one fp32 slot of
    dW1, dW2 and db1 each, ``dw_slots`` in all) and at most ``ln_blocks``
    blocks of the LN pass (one slot of dscale, dbias and db2 each,
    ``ln_slots`` in all); the GEMM passes' grids of the largest chunk (``buf_rows`` rows); the bytes of
    the one scratch allocation (:func:`_k7_scratch`'s buffers, each 256-byte
    aligned) and of the output."""
    chunk_rows: int
    chunks: int
    buf_rows: int
    split_rows: int
    dw_slots: int
    ln_blocks: int
    ln_slots: int
    a_blocks: int
    b_blocks: int
    d_blocks: int
    workspace_bytes: int


def k7_plan(rows: int, C: int, H: int, sms: int = 132,
            hidden_bytes: int = _K7_HIDDEN_BYTES) -> K7Plan:
    """K7's schedule on a card of ``sms`` SMs (the kernel checks that the
    slots it fills are the ones planned here). Pass D's row groups are whole
    128-row tiles, as many as make its 2 (H / 128) (C / 128) output tiles
    fill the card's two blocks an SM once (never more groups than the
    chunk's row tiles)."""
    T = _K7_TILE
    chunks = _cdiv(4 * rows * H, hidden_bytes)
    chunk_rows = _cdiv(_cdiv(rows, chunks), T) * T
    sizes = [min(chunk_rows, rows - r0) for r0 in range(0, rows, chunk_rows)]
    n, row_tiles = sizes[0], _cdiv(sizes[0], T)
    tiles = 2 * _cdiv(H, T) * _cdiv(C, T)
    groups = min(row_tiles, max(1, 2 * sms // tiles))
    split_rows = _cdiv(row_tiles, groups) * T
    ln_blocks = _K7_LN_BLOCKS_PER_SM * sms
    dw_slots = sum(_cdiv(m, split_rows) for m in sizes)
    ln_slots = sum(min(ln_blocks, _cdiv(m, 8)) for m in sizes)
    plan = K7Plan(chunk_rows, len(sizes), n, split_rows, dw_slots, ln_blocks, ln_slots,
                  _cdiv(H, T) * row_tiles, _cdiv(C, T) * row_tiles,
                  tiles * _cdiv(n, split_rows), 0)
    scratch = sum(_align256(math.prod(shape) * dt.itemsize)
                  for shape, dt in _k7_scratch(plan, C, H))
    return plan._replace(workspace_bytes=scratch + 4 * (2 * H * C + H + 3 * C))


def _align256(nbytes: int) -> int:
    return _cdiv(nbytes, 256) * 256


def _k7_scratch(plan: K7Plan, C: int, H: int):
    """K7's scratch buffers, in the C entry point's order, as (shape,
    dtype): W1 and W2^T in bf16; y, dz and s h of a chunk; dy; pass A's drs
    partials (used with a row scale) and db1 partials; the slots of pass D
    and of the LN backward."""
    n, bf16, f32 = plan.buf_rows, torch.bfloat16, torch.float32
    return [((H, C), bf16), ((H, C), bf16), ((n, C), bf16), ((n, H), bf16), ((n, H), bf16),
            ((n, C), f32), ((n, _cdiv(H, _K7_TILE)), f32), ((_cdiv(n, _K7_TILE), H), f32),
            ((plan.dw_slots, 2 * H * C + H), f32), ((plan.ln_slots, 3 * C), f32)]


def _k7_pass_a_plain(y, g, w1, b1, w2, row_scale, gelu):
    """Pass A: z = y W1^T + b1 and u = g W2 in fp32; -> (dz = s u gelu'(z),
    s h in y's dtype (rows, H); drs partials sum_j h u over each 128-column
    hidden tile (rows, H / 128), None without a row scale; db1 partials
    sum_r dz over each 128-row tile, from the unrounded dz (row tiles,
    H))."""
    dt = y.dtype
    z = _mm_f32(y, w1.to(dt).t()) + b1
    u = _mm_f32(g, w2.to(dt))
    mode = _GELU[gelu]
    h = F.gelu(z, approximate=mode)
    dg = torch.ops.aten.gelu_backward(torch.ones_like(z), z, approximate=mode)
    s = row_scale.to(z.dtype)[:, None] if row_scale is not None else torch.ones_like(z[:, :1])
    dz = s * u * dg
    rows, H = z.shape
    drs_part = None
    if row_scale is not None:
        T = _K7_TILE
        drs_part = F.pad(h * u, (0, _cdiv(H, T) * T - H)).view(rows, -1, T).sum(-1)
    tiles = -(-rows // _K7_TILE)
    db1_part = F.pad(dz, (0, 0, 0, tiles * _K7_TILE - rows)).view(tiles, _K7_TILE, H).sum(1)
    return dz.to(dt), (s * h).to(dt), drs_part, db1_part


def _k7_pass_b_plain(dz, w1):
    """Pass B: dy = dz W1, fp32 (rows, C)."""
    return _mm_f32(dz, w1.to(dz.dtype))


def _k7_ln_bwd_plain(x, g, dy, ln_w, b2, row_scale, drs_part, eps, ln_blocks):
    """Pass C, the LN backward of dy: -> (dx in x's dtype; drs = the pass-A
    partials + g . b2 per row, None without a row scale; the LN blocks'
    partials (blocks, 3 C) of [dscale | dbias | db2], block b summing rows r
    with (r // 8) % blocks == b, as the kernel's warps walk them)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    xc = x32 - x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xn = xc * rstd
    dyt = dy * ln_w
    m1 = dyt.mean(-1, keepdim=True)
    m2 = (dyt * xn).mean(-1, keepdim=True)
    g32 = g.to(acc)
    dx = (rstd * (dyt - m1 - xn * m2) + g32).to(x.dtype)
    gs = g32 * row_scale.to(acc)[:, None] if row_scale is not None else g32
    drs = drs_part.sum(1) + (g32 * b2).sum(1) if row_scale is not None else None
    rows, C = x.shape
    blocks = min(ln_blocks, -(-rows // 8))
    which = (torch.arange(rows, device=x.device) // 8) % blocks
    part = torch.zeros((blocks, 3 * C), dtype=acc, device=x.device)
    part.index_add_(0, which, torch.cat([dy * xn, dy, gs], dim=1))
    return dx, drs, part


def _k7_pass_d_plain(dz, hs, y, g, db1_part, split_rows):
    """Pass D: per group of split_rows rows, dW1 = dz^T y (H, C), dW2 = g^T
    s h (C, H) and db1 = the group's row tiles' partials, fp32; -> (groups,
    2 H C + H), each row [dW1 | dW2 | db1] as the kernel's slots."""
    parts = []
    for k0 in range(0, dz.shape[0], split_rows):
        rs = slice(k0, k0 + split_rows)
        tiles = slice(k0 // _K7_TILE, -(-min(k0 + split_rows, dz.shape[0]) // _K7_TILE))
        parts.append(torch.cat([_mm_f32(dz[rs].t(), y[rs]).flatten(),
                                _mm_f32(g[rs].t(), hs[rs]).flatten(),
                                db1_part[tiles].sum(0)]))
    return torch.stack(parts)


def ln_mlp_residual_bwd_passes(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps: float,
                               gelu: str, g, plan: K7Plan = None):
    """K7's passes in plain PyTorch, chunk by chunk as the kernels run them
    (``plan``: ``k7_plan``'s for 132 SMs by default): LN rows, pass A, pass
    B, the LN backward and pass D, then the slots summed in fp64. -> (dx,
    dln_w, dln_b, dw1, db1, dw2, db2, drs)."""
    rows, C = x.shape
    H = w1.shape[0]
    plan = plan or k7_plan(rows, C, H)
    dxs, drss, dw_parts, ln_parts = [], [], [], []
    for r0 in range(0, rows, plan.chunk_rows):
        rs = slice(r0, r0 + plan.chunk_rows)
        xc, gc = x[rs], g[rs]
        sc = row_scale[rs] if row_scale is not None else None
        y = _k2_ln_rows_plain(xc, ln_w, ln_b, eps)[0]   # K7's first pass
        dz, hs, drs_part, db1_part = _k7_pass_a_plain(y, gc, w1, b1, w2, sc, gelu)
        dy = _k7_pass_b_plain(dz, w1)
        dx, drs, ln_part = _k7_ln_bwd_plain(xc, gc, dy, ln_w, b2, sc, drs_part, eps,
                                            plan.ln_blocks)
        dw_parts.append(_k7_pass_d_plain(dz, hs, y, gc, db1_part, plan.split_rows))
        dxs.append(dx)
        drss.append(drs)
        ln_parts.append(ln_part)
    dw = torch.cat(dw_parts).double().sum(0)
    dscale, dbias, db2 = torch.cat(ln_parts).double().sum(0).view(3, C)
    dw1, dw2, db1 = dw.split((H * C, H * C, H))
    drs = torch.cat(drss).to(row_scale.dtype) if row_scale is not None else None
    return (torch.cat(dxs), dscale.to(ln_w.dtype), dbias.to(ln_b.dtype),
            dw1.view(H, C).to(w1.dtype), db1.to(b1.dtype), dw2.view(C, H).to(w2.dtype),
            db2.to(b2.dtype), drs)


def _launch_passes(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps, gelu, g):
    """K7 on CUDA tensors. -> (dx, drs, [dW1 | dW2 | db1 | dscale | dbias |
    db2] fp32)."""
    rows, C = x.shape
    H = w1.shape[0]
    dev = x.device
    _build.require(x, "x", torch.bfloat16, dev)
    _build.require(g, "g", torch.bfloat16, dev, (rows, C))
    _build.require(w1, "w1", torch.float32, dev, (H, C))
    _build.require(w2, "w2", torch.float32, dev, (C, H))
    for name, t, n in (("ln_w", ln_w, C), ("ln_b", ln_b, C), ("b1", b1, H), ("b2", b2, C)):
        _build.require(t, name, torch.float32, dev, (n,))
    if C not in _K7_WIDTHS or H % _K7_TILE:
        raise ValueError(f"K7 takes C in {_K7_WIDTHS} and H % {_K7_TILE} == 0; got C={C}, "
                         f"H={H}")
    plan = k7_plan(rows, C, H, _build.sms(dev))
    drs = None
    if row_scale is not None:
        _build.require(row_scale, "row_scale", torch.float32, dev, (rows,))
        drs = torch.empty(rows, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    out = torch.empty(2 * H * C + H + 3 * C, dtype=torch.float32, device=dev)
    # one allocation for the scratch, carved in _k7_scratch's order
    ws = torch.empty(plan.workspace_bytes - out.numel() * 4, dtype=torch.uint8, device=dev)
    bufs, off = [], 0
    for shape, dt in _k7_scratch(plan, C, H):
        nbytes = math.prod(shape) * dt.itemsize
        bufs.append(ws[off:off + nbytes].view(dt).view(shape))
        off += _align256(nbytes)
    if row_scale is None:
        bufs[6] = None   # no drs partials
    _build.launch("clover_mlp_bwd_passes", x, ln_w, ln_b, w1, b1, w2, b2, g, row_scale, dx, drs,
                  *bufs, out, rows, C, H, plan.chunk_rows, plan.split_rows, plan.ln_blocks,
                  plan.dw_slots, plan.ln_slots, float(eps), int(gelu == "tanh"),
                  _build.stream(dev))
    return dx, drs, out


def ln_mlp_residual_bwd_onepass(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps: float,
                                gelu: str, g):
    """K7, the recompute backward of the JAX ``_backward_onepass`` (tanh or
    erf), as the passes of ``csrc/mlp_block_bwd_passes.cu``; for CPU tensors
    their plain forms, ``ln_mlp_residual_bwd_passes``. The weights are fp32
    on the card. -> (dx, dln_w, dln_b, dw1, db1, dw2, db2, drs)."""
    _check_gelu(gelu)
    if not x.is_cuda:
        return ln_mlp_residual_bwd_passes(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps, gelu, g)
    C, H = x.shape[1], w1.shape[0]
    dx, drs, out = _launch_passes(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps, gelu, g)
    ln_mlp_residual_bwd_onepass.launches += 1
    dw1, dw2, db1, tail = out.split((H * C, H * C, H, 3 * C))
    dscale, dbias, db2 = tail.view(3, C)
    return dx, dscale, dbias, dw1.view(H, C), db1, dw2.view(C, H), db2, drs


def _erf_only(gelu: str) -> None:
    if gelu != "erf":
        raise ValueError(f"the MLP backward pair takes the erf GELU only (as the JAX "
                         f"_backward_pallas), got {gelu!r}")


def ln_mlp_residual_bwd_pair(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps: float, gelu: str,
                             g):
    """K8, the recompute backward of the JAX ``_backward_pallas`` (the pair
    ``_kernel_bwd_dx`` / ``_kernel_bwd_dw``), erf only: K7's passes
    (``csrc/mlp_block_bwd_passes.cu``, one C call) with the erf GELU,
    counted on this wrapper; for CPU tensors their plain forms,
    ``ln_mlp_residual_bwd_passes``. The weights are fp32 on the card.
    -> (dx, dln_w, dln_b, dw1, db1, dw2, db2, drs)."""
    _erf_only(gelu)
    if not x.is_cuda:
        return ln_mlp_residual_bwd_passes(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps, gelu, g)
    C, H = x.shape[1], w1.shape[0]
    dx, drs, out = _launch_passes(x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps, gelu, g)
    ln_mlp_residual_bwd_pair.launches += 1
    dw1, dw2, db1, tail = out.split((H * C, H * C, H, 3 * C))
    dscale, dbias, db2 = tail.view(3, C)
    return dx, dscale, dbias, dw1.view(H, C), db1, dw2.view(C, H), db2, drs


# the recompute backward by route; the plain one skips drs (autograd takes
# no row-scale gradient), which the kernels form at no extra product
_RECOMPUTE_BWD = {"xla": functools.partial(ln_mlp_residual_bwd_recompute, want_drs=False),
                  "onepass": ln_mlp_residual_bwd_onepass, "pair": ln_mlp_residual_bwd_pair}


class FusedLnMlpResidualFn(torch.autograd.Function):
    """The Swin MLP half in training.

    With the stash on (``mlp_stash``): forward K2's stash form
    (``kernels=True``; its plain version for CPU tensors) or the plain one,
    backward ``ln_mlp_residual_bwd_stash``. With it off: forward K2's
    training form without a stash (or the plain one), saving x and the
    parameters only; the backward recomputes by ``mlp_bwd``: 'xla'
    ``ln_mlp_residual_bwd_recompute``, 'onepass' K7, 'pair' K8 (K7's passes,
    erf only)
    (``kernels=False``: the plain recompute for every route). The row scale
    takes no gradient.

    ``FusedLnMlpResidualFn.apply(x, ln_w, ln_b, w1, b1, w2, b2, row_scale,
    eps, gelu, kernels[, mlp_stash, mlp_bwd])``"""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, row_scale, eps, gelu, kernels,
                mlp_stash=True, mlp_bwd="xla"):
        if mlp_bwd not in _RECOMPUTE_BWD:
            raise ValueError(f"mlp_bwd must be one of {tuple(_RECOMPUTE_BWD)}, got {mlp_bwd!r}")
        ctx.args = (eps, gelu)
        params = (x, ln_w, ln_b, w1, b1, w2, b2)
        if not mlp_stash:
            op = fused_ln_mlp_residual_train if kernels else ln_mlp_residual_plain
            out = op(*params, eps, gelu, row_scale)
            ctx.save_for_backward(*params, row_scale)
            ctx.bwd = _RECOMPUTE_BWD[mlp_bwd if kernels else "xla"]
            return out
        if kernels:
            out, stash = fused_ln_mlp_residual_stash(*params, eps, gelu, row_scale)
        else:
            out, stash = ln_mlp_residual_plain(*params, eps, gelu, row_scale, want_stash=True)
        ctx.save_for_backward(*params, row_scale, *stash)
        ctx.bwd = None
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w1, b1, w2, b2, row_scale, *stash = ctx.saved_tensors
        params = (x, ln_w, ln_b, w1, b1, w2, b2)
        if ctx.bwd is None:
            grads = ln_mlp_residual_bwd_stash(*params, row_scale, stash, *ctx.args, g.contiguous())
        else:
            grads = ctx.bwd(*params, row_scale, *ctx.args, g.contiguous())[:7]
        return (*grads, None, None, None, None, None, None)


def fused_mlp_postln(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-12):
    """``LN(x + fc2(gelu_erf(fc1(x))))`` over 2-D x (rows, C)."""
    if not x.is_cuda:
        return mlp_postln_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    out = mlp_postln_passes(x, ln_w, ln_b, w1, b1, w2, b2, None, eps)
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
    out = mlp_postln_passes(x, ln_w, ln_b, w1, b1, w2, b2, mask, eps)
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
fused_ln_mlp_residual_train.launches = 0
ln_mlp_residual_bwd_onepass.launches = 0
ln_mlp_residual_bwd_pair.launches = 0
fused_mlp_postln.launches = 0
fused_mlp_postln_dropout.launches = 0
