"""The fused window-attention half-block (kernel K6).

``fused_window_attn_block(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids,
wproj, bproj, scale, num_heads, N, eps, row_scale=None)``: over windows of
N tokens, x (Bn*N, C) row-major as ``flat2_window_attention`` takes qkv,

    out = x + s * (proj(window_attention(qkv(LN1(x)))) + b_proj)

with the per-head (nH, N, N) relative-position bias and, for shifted blocks,
the region mask (region ids (nW, N) int32, window b uses row b % nW, keys of
another region get -100). s is the optional per-window fp32 row scale (Bn,)
(DropPath's keep / keep_prob; 1 when None; eval passes None). Port of
``clover_tpu/ops/attn_block.py::fused_window_attn_block`` (``_forward`` and
its head-group form ``_forward_grouped``: the same function). Weights are
torch ``Linear`` layouts: ``wqkv`` (3C, C), ``wproj`` (C, C); parameters may
be fp32 and are cast to x's dtype.

Rounding points, as the JAX kernel (``attn_block.py::_kernel``): LayerNorm
statistics in fp32, LN(x) rounded to the compute dtype; the qkv product in
fp32 plus b_qkv, rounded; the attention as K1 takes it (bias rounded to the
compute dtype, fp32 logits with the scale applied to the fp32 q.k -- the
JAX kernel scales q in bf16 -- true row max, probabilities rounded before
the product with v, output rounded); the proj product in fp32 plus b_proj,
times s, plus x in fp32, rounded once. The JAX eval kernel's static softmax
shift (30, or 130 with region lanes) is a TPU device; K6 takes the true row
max, as K1 does.

The wrapper launches ``csrc/attn_block.cu`` for a CUDA tensor and runs
:func:`window_attn_block_plain` for a CPU tensor.

``FusedAttnBlockFn`` is the half-block in training, the port of the JAX
custom vjp (``_fwd`` / ``_bwd``): the forward is K6 (with DropPath's row
scale) and saves only its inputs; the backward recomputes the same function
from ops that carry their own backward (``_composed_reference``: LN1, the
qkv product, ``WindowAttentionFn`` -- K1 forward, K5 backward --, proj) and
takes its gradients with ``torch.autograd.grad``.
"""

from __future__ import annotations

import torch

from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops.layer_norm import layer_norm_plain
from clover_tpu_torch.ops.mlp_block import _mm_f32
from clover_tpu_torch.ops.window_attention import (
    WindowAttentionFn,
    fragment_bias,
    window_attention_plain,
    window_chunk,
)

KEY_TILES = (13, 25)     # K6's instances: N <= 208 (4x7x7 windows), N <= 400 (8x7x7)
# the plain version's (chunk, nH, N, N) fp32 logits stay under this many
# elements: unchunked, stage 0 of the 32-frame eval at B=32 would hold
# (4096, 4, 392, 392) fp32, 10 GB
_PLAIN_LOGITS = 1 << 27


def _window_chunk(Bn: int, nW: int, num_heads: int, N: int) -> int:
    """Windows per chunk of the plain version (LN1, qkv, attention, proj)."""
    return window_chunk(Bn, nW, num_heads, N, _PLAIN_LOGITS)


def window_attn_block_plain(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj,
                            scale: float, num_heads: int, N: int, eps: float = 1e-5,
                            row_scale=None):
    """Plain PyTorch version, over chunks of windows: (Bn*N, C) -> same."""
    M, C = x.shape
    Bn = M // N
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    w_qkv, w_p = wqkv.to(dt).t(), wproj.to(dt).t()
    nW = 1 if region_ids is None else region_ids.shape[0]
    step = _window_chunk(Bn, nW, num_heads, N) * N
    out = torch.empty_like(x)
    for r0 in range(0, M, step):
        xc = x[r0:r0 + step]
        xn = layer_norm_plain(xc, ln_w, ln_b, eps)
        qkv = (_mm_f32(xn, w_qkv) + bqkv.to(acc)).to(dt)
        o = window_attention_plain(qkv, bias, region_ids, scale, num_heads, N)
        y = _mm_f32(o, w_p) + bproj.to(acc)
        if row_scale is not None:
            rs = row_scale[r0 // N:(r0 + xc.shape[0]) // N].to(acc)
            y = (y.view(-1, N, C) * rs[:, None, None]).view(-1, C)
        out[r0:r0 + step] = (xc.to(acc) + y).to(dt)
    return out


def fused_window_attn_block(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj,
                            scale: float, num_heads: int, N: int, eps: float = 1e-5,
                            row_scale=None):
    """x (Bn*N, C) -> x + s * proj(window_attention(LN1(x))); bias (nH, N, N);
    region_ids (nW, N) int32 or None (unshifted block); row_scale (Bn,) fp32
    or None."""
    if not x.is_cuda:
        return window_attn_block_plain(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj,
                                       bproj, scale, num_heads, N, eps, row_scale)
    M, C = x.shape
    hd = C // num_heads
    Bn = M // N
    dev = x.device
    if hd != 32 or C != num_heads * hd or Bn * N != M or C % 128 or N > 16 * KEY_TILES[-1]:
        raise ValueError(f"fused attention block kernel takes head dim 32, C % 128 == 0 and "
                         f"N <= {16 * KEY_TILES[-1]}; got C={C}, heads={num_heads}, N={N}, "
                         f"rows={M}")
    _build.require(x, "x", torch.bfloat16, dev)
    wq = wqkv.to(torch.bfloat16).contiguous()
    wp = wproj.to(torch.bfloat16).contiguous()
    _build.require(wq, "wqkv", torch.bfloat16, dev, (3 * C, C))
    _build.require(wp, "wproj", torch.bfloat16, dev, (C, C))
    for name, t, n in (("ln_w", ln_w, C), ("ln_b", ln_b, C), ("bqkv", bqkv, 3 * C),
                       ("bproj", bproj, C)):
        _build.require(t, name, torch.float32, dev, (n,))
    if bias.device != dev or tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"bias: {tuple(bias.shape)} on {bias.device}, expected "
                         f"{(num_heads, N, N)} on {dev}")
    nW = 1
    if region_ids is not None:
        nW = region_ids.shape[0]
        _build.require(region_ids, "region_ids", torch.int32, dev, (nW, N))
        if Bn % nW:
            raise ValueError(f"{Bn} windows are not a multiple of nW={nW}")
    if row_scale is not None:
        _build.require(row_scale, "row_scale", torch.float32, dev, (Bn,))
    key_tiles = next(t for t in KEY_TILES if N <= 16 * t)
    bias_f = fragment_bias(bias, N, key_tiles)
    attn = torch.empty_like(x)      # the attention output, read back by the proj pass
    out = torch.empty_like(x)
    _build.launch("clover_attn_block", x, ln_w, ln_b, wq, bqkv, bias_f, region_ids, wp, bproj,
                  row_scale, attn, out, Bn, N, C, nW, key_tiles, float(scale), float(eps),
                  _build.stream(dev))
    fused_window_attn_block.launches += 1
    return out


class LinearF32Fn(torch.autograd.Function):
    """``x w^T + b`` of compute-dtype operands with an fp32 result (the JAX
    ``dot(..., preferred_element_type=f32)``; cuBLAS's bf16-in / fp32-out
    GEMM on the card). Backward: the fp32 output gradient rounded to x's
    dtype, then products of compute-dtype operands; dx in x's dtype, dw and
    db in the parameters' dtypes.

    ``LinearF32Fn.apply(x, w, b)``: x (rows, K), w (O, K), b (O,)"""

    @staticmethod
    def forward(ctx, x, w, b):
        wd = w.to(x.dtype)
        ctx.save_for_backward(x, wd)
        ctx.dtypes = (w.dtype, b.dtype)
        return _mm_f32(x, wd.t()) + b.to(torch.promote_types(x.dtype, torch.float32))

    @staticmethod
    def backward(ctx, g):
        x, wd = ctx.saved_tensors
        g_d = g.to(x.dtype)
        dx = _mm_f32(g_d, wd).to(x.dtype)
        dw = _mm_f32(g_d.t(), x)
        return dx, dw.to(ctx.dtypes[0]), g.sum(0).to(ctx.dtypes[1])


def composed_attn_block(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj,
                        row_scale, scale: float, num_heads: int, N: int, eps: float,
                        kernels: bool):
    """The half-block from ops that each carry a backward (the JAX
    ``_composed_reference``): LN1 in fp32 rounded to x's dtype, the qkv
    product in fp32 plus b_qkv rounded, ``WindowAttentionFn`` (K1 and K5 with
    ``kernels``, else their plain versions), the proj product in fp32 plus
    b_proj, times the row scale, plus x in fp32, rounded once."""
    M, C = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    xn = layer_norm_plain(x, ln_w, ln_b, eps)
    qkv = LinearF32Fn.apply(xn, wqkv, bqkv).to(x.dtype)
    o = WindowAttentionFn.apply(qkv, bias, region_ids, scale, num_heads, N, kernels)
    y = LinearF32Fn.apply(o, wproj, bproj)
    if row_scale is not None:
        y = (y.view(-1, N, C) * row_scale.to(acc)[:, None, None]).view(M, C)
    return (x.to(acc) + y).to(x.dtype)


class FusedAttnBlockFn(torch.autograd.Function):
    """The fused half-block with its backward. Forward: K6 with the row scale
    (``kernels=True``; its plain version for CPU tensors) or the plain
    version (``kernels=False``); it saves x, the parameters, the bias and the
    row scale, not K6's attention output. Backward: :func:`composed_attn_block`
    recomputed under ``torch.enable_grad()`` (with ``kernels``, K1 runs once
    more there and K5 takes its backward), then ``torch.autograd.grad`` to x,
    the LN1 and qkv / proj parameters and the bias. The region ids and the
    row scale get no gradient (the JAX package's zero shift-mask-gradient
    contract; the row scale is DropPath's draw).

    ``FusedAttnBlockFn.apply(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids,
    wproj, bproj, row_scale, scale, num_heads, N, eps, kernels)``"""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj, row_scale,
                scale, num_heads, N, eps, kernels):
        fwd = fused_window_attn_block if kernels else window_attn_block_plain
        out = fwd(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj, scale, num_heads,
                  N, eps, row_scale)
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj,
                              row_scale)
        ctx.args = (scale, num_heads, N, eps, kernels)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj, row_scale = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (x, ln_w, ln_b, wqkv, bqkv, bias, wproj,
                                                         bproj)]
        with torch.enable_grad():
            out = composed_attn_block(*leaves[:6], region_ids, *leaves[6:], row_scale,
                                      *ctx.args)
        dx, dln_w, dln_b, dwqkv, dbqkv, dbias, dwproj, dbproj = torch.autograd.grad(
            out, leaves, g)
        return (dx, dln_w, dln_b, dwqkv, dbqkv, dbias, None, dwproj, dbproj, None, None, None,
                None, None, None)


fused_window_attn_block.launches = 0
