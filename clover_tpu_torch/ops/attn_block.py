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
fp32 plus b_qkv, rounded; the attention (bias rounded to the compute dtype,
fp32 logits with the scale applied to the fp32 q.k -- the JAX kernel scales
q in bf16 --, probabilities rounded before the product with v, output
rounded); the proj product in fp32 plus b_proj, times s, plus x in fp32,
rounded once. The plain version takes the attention as K1 does (the true
row max over all keys); the kernel path as K11 does (an online softmax over
64-key tiles, the logits in log2 units: fp32 re-associated). The JAX eval
kernel's static softmax shift (30, or 130 with region lanes) is a TPU
device.

On the card K6 runs as three passes over chunks of whole windows
(:func:`k6_plan`): the LN1 + qkv GEMM pass, K11's attention on the chunk's
flat qkv, and the proj + residual GEMM pass (``csrc/attn_block.cu``; the
attention through ``csrc/window_attention_flash.cu``). :func:`attn_block_passes`
walks the chunks and runs each pass's kernel on a CUDA tensor and its plain
step on a CPU tensor (K11's online softmax, ``_flash_plain``, for the
attention); the public wrapper runs :func:`window_attn_block_plain` (K1's
softmax) for a CPU tensor.

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
    _check_bias,
    _flash_kernel_args,
    _region_nW,
    window_attention_flat_flash_plain,
    window_attention_plain,
    window_chunk,
)

# a chunk of K6's passes holds its LN1 output, qkv and attention output,
# (1 + 3 + 1) C bf16 a row, in at most this many bytes (4 clips a chunk at
# stage 0 of the 32-frame eval)
_K6_CHUNK_BYTES = 256 << 20
# the plain version's (chunk, nH, N, N) fp32 logits stay under this many
# elements: unchunked, stage 0 of the 32-frame eval at B=32 would hold
# (4096, 4, 392, 392) fp32, 10 GB
_PLAIN_LOGITS = 1 << 27


def _window_chunk(Bn: int, nW: int, num_heads: int, N: int) -> int:
    """Windows per chunk of the plain version (LN1, qkv, attention, proj)."""
    return window_chunk(Bn, nW, num_heads, N, _PLAIN_LOGITS)


def ln_qkv_plain(x, ln_w, ln_b, wqkv, bqkv, eps: float = 1e-5):
    """LN1 in fp32 rounded to x's dtype, then the qkv product in fp32 plus
    b_qkv, rounded: x (rows, C) -> (rows, 3C)."""
    dt = x.dtype
    xn = layer_norm_plain(x, ln_w, ln_b, eps)
    return (_mm_f32(xn, wqkv.to(dt).t()) + bqkv.to(torch.promote_types(dt, torch.float32))).to(dt)


def proj_residual_plain(o, x, wproj, bproj, row_scale, N: int):
    """The proj product of the attention output o in fp32 plus b_proj, times
    the per-window row scale (or 1), plus x in fp32, rounded once: (rows,
    C) -> (rows, C)."""
    C = x.shape[1]
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    y = _mm_f32(o, wproj.to(dt).t()) + bproj.to(acc)
    if row_scale is not None:
        y = (y.view(-1, N, C) * row_scale.to(acc)[:, None, None]).view(-1, C)
    return (x.to(acc) + y).to(dt)


def window_attn_block_plain(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj,
                            scale: float, num_heads: int, N: int, eps: float = 1e-5,
                            row_scale=None):
    """Plain PyTorch version, over chunks of windows: (Bn*N, C) -> same."""
    M = x.shape[0]
    nW = 1 if region_ids is None else region_ids.shape[0]
    step = _window_chunk(M // N, nW, num_heads, N) * N
    out = torch.empty_like(x)
    for r0 in range(0, M, step):
        xc = x[r0:r0 + step]
        qkv = ln_qkv_plain(xc, ln_w, ln_b, wqkv, bqkv, eps)
        o = window_attention_plain(qkv, bias, region_ids, scale, num_heads, N)
        rs = None if row_scale is None else row_scale[r0 // N:(r0 + xc.shape[0]) // N]
        out[r0:r0 + step] = proj_residual_plain(o, xc, wproj, bproj, rs, N)
    return out


def k6_plan(Bn: int, N: int, C: int, nW: int) -> tuple:
    """K6's chunks of Bn windows of N tokens: ((first window, windows), ...).
    Each chunk is a whole number of nW-groups (so window b of a chunk uses
    region-id row b % nW) whose LN1 output, qkv and attention output, 10 N C
    bytes a window, stay under ``_K6_CHUNK_BYTES`` (one group where a group
    alone is larger); the chunks are as even as whole groups allow."""
    groups = Bn // nW
    per = max(1, _K6_CHUNK_BYTES // (10 * N * C * nW))      # groups a chunk
    per = -(-groups // -(-groups // per))
    return tuple((g0 * nW, min(per, groups - g0) * nW) for g0 in range(0, groups, per))


def ln_qkv_pass(x, ln_w, ln_b, wqkv, bqkv, eps: float = 1e-5, xn=None, out=None):
    """K6's pass 1, LN1 + the qkv product: x (rows, C) -> qkv (rows, 3C). On
    the card k6_ln_rows and k6_qkv_pass (wqkv taken in bf16, xn (rows, C)
    and out the workspace, allocated when None); on the CPU
    :func:`ln_qkv_plain`."""
    if not x.is_cuda:
        return ln_qkv_plain(x, ln_w, ln_b, wqkv, bqkv, eps)
    rows, C = x.shape
    dev = x.device
    wq = wqkv.to(torch.bfloat16).contiguous()
    _build.require(x, "x", torch.bfloat16, dev)
    _build.require(wq, "wqkv", torch.bfloat16, dev, (3 * C, C))
    xn = torch.empty_like(x) if xn is None else xn
    out = x.new_empty((rows, 3 * C)) if out is None else out
    _build.require(xn, "xn", torch.bfloat16, dev, (rows, C))
    _build.require(out, "qkv", torch.bfloat16, dev, (rows, 3 * C))
    _build.launch("clover_attn_block_qkv", x, ln_w, ln_b, wq, bqkv, xn, out, rows, C,
                  float(eps), _build.stream(dev))
    return out


def attention_pass(qkv, bias, region_ids, scale: float, num_heads: int, N: int, terms=None,
                   out=None):
    """K6's pass 2, the window attention on the flat qkv (rows, 3C) -> (rows,
    C). On the card K11's kernel under K6's own layout type (``terms``: the
    bias as ``_flash_kernel_args`` lays it out, made when None); on the CPU
    K11's plain version (the online softmax over 64-key tiles)."""
    if not qkv.is_cuda:
        return window_attention_flat_flash_plain(qkv, bias, region_ids, scale, num_heads, N)
    rows = qkv.shape[0]
    C = 32 * num_heads
    dev = qkv.device
    _build.require(qkv, "qkv", torch.bfloat16, dev, (rows, 3 * C))
    if terms is None:
        terms = _flash_kernel_args(bias, region_ids, rows // N, num_heads, N, dev)[0]
    nW = 1 if region_ids is None else region_ids.shape[0]
    out = qkv.new_empty((rows, C)) if out is None else out
    _build.require(out, "attn", torch.bfloat16, dev, (rows, C))
    _build.launch("clover_attn_block_attention", qkv, terms, region_ids, out, rows // N, N,
                  num_heads, nW, float(scale), _build.stream(dev))
    return out


def proj_pass(o, x, wproj, bproj, row_scale, N: int, out=None):
    """K6's pass 3, x + s * (o Wproj^T + b_proj): (rows, C) -> (rows, C), s
    the per-window row scale (rows / N,) or None; written into ``out`` when
    given. On the card k6_proj_pass (wproj taken in bf16); on the CPU
    :func:`proj_residual_plain`."""
    if not o.is_cuda:
        y = proj_residual_plain(o, x, wproj, bproj, row_scale, N)
        return y if out is None else out.copy_(y)
    rows, C = x.shape
    dev = x.device
    wp = wproj.to(torch.bfloat16).contiguous()
    for name, t in (("attn", o), ("x", x)):
        _build.require(t, name, torch.bfloat16, dev, (rows, C))
    _build.require(wp, "wproj", torch.bfloat16, dev, (C, C))
    if row_scale is not None and (row_scale.device != dev or row_scale.dtype != torch.float32
                                  or tuple(row_scale.shape) != (rows // N,)
                                  or not row_scale.is_contiguous()):
        # read one float a row: a chunk's slice, at any window, is aligned enough
        raise ValueError(f"row_scale: {tuple(row_scale.shape)} {row_scale.dtype} on "
                         f"{row_scale.device}, expected a contiguous ({rows // N},) float32 "
                         f"on {dev}")
    out = torch.empty_like(x) if out is None else out
    _build.require(out, "out", torch.bfloat16, dev, (rows, C))
    _build.launch("clover_attn_block_proj", o, wp, bproj, row_scale, x, out, rows, C, N,
                  _build.stream(dev))
    return out


def attn_block_passes(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj,
                      scale: float, num_heads: int, N: int, eps: float = 1e-5, row_scale=None):
    """The half-block as K6's three passes over :func:`k6_plan`'s chunks:
    each pass's kernel on a CUDA tensor (the weights cast to bf16 and the
    bias laid out once a call, one workspace for every chunk), its plain
    step on a CPU tensor. (Bn*N, C) -> same."""
    M, C = x.shape
    nW = 1 if region_ids is None else region_ids.shape[0]
    plan = k6_plan(M // N, N, C, nW)
    out = torch.empty_like(x)
    terms = xn = qkv = attn = None
    if x.is_cuda:
        wqkv, wproj = (w.to(torch.bfloat16).contiguous() for w in (wqkv, wproj))
        terms = _flash_kernel_args(bias, region_ids, plan[0][1], num_heads, N, x.device)[0]
        rows = max(n for _, n in plan) * N
        xn, attn = x.new_empty((rows, C)), x.new_empty((rows, C))
        qkv = x.new_empty((rows, 3 * C))
    for w0, n in plan:
        r0, r1 = w0 * N, (w0 + n) * N
        ws = [None if t is None else t[:r1 - r0] for t in (xn, qkv, attn)]
        q = ln_qkv_pass(x[r0:r1], ln_w, ln_b, wqkv, bqkv, eps, ws[0], ws[1])
        o = attention_pass(q, bias, region_ids, scale, num_heads, N, terms, ws[2])
        rs = None if row_scale is None else row_scale[w0:w0 + n]
        proj_pass(o, x[r0:r1], wproj, bproj, rs, N, out[r0:r1])
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
    if hd != 32 or C != num_heads * hd or Bn * N != M or C % 128:
        raise ValueError(f"fused attention block kernel takes head dim 32 and C % 128 == 0; "
                         f"got C={C}, heads={num_heads}, N={N}, rows={M}")
    _build.require(x, "x", torch.bfloat16, dev)     # the passes check the weights
    for name, t, n in (("ln_w", ln_w, C), ("ln_b", ln_b, C), ("bqkv", bqkv, 3 * C),
                       ("bproj", bproj, C)):
        _build.require(t, name, torch.float32, dev, (n,))
    _check_bias(bias, num_heads, N, dev)
    _region_nW(region_ids, Bn, N, dev)
    if row_scale is not None:
        _build.require(row_scale, "row_scale", torch.float32, dev, (Bn,))
    out = attn_block_passes(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj, scale,
                            num_heads, N, eps, row_scale)
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
                        kernels: bool, terms=None):
    """The half-block from ops that each carry a backward (the JAX
    ``_composed_reference``): LN1 in fp32 rounded to x's dtype, the qkv
    product in fp32 plus b_qkv rounded, ``WindowAttentionFn`` (K1 and K5 with
    ``kernels``, on ``terms`` where given, else their plain versions), the
    proj product in fp32 plus b_proj, times the row scale, plus x in fp32,
    rounded once."""
    M, C = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    xn = layer_norm_plain(x, ln_w, ln_b, eps)
    qkv = LinearF32Fn.apply(xn, wqkv, bqkv).to(x.dtype)
    o = WindowAttentionFn.apply(qkv, bias, region_ids, scale, num_heads, N, kernels, "off",
                                terms)
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
    contract; the row scale is DropPath's draw). ``terms``: K1's bias terms
    for the recompute (and K5), as ``WindowAttentionFn`` takes them.

    ``FusedAttnBlockFn.apply(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids,
    wproj, bproj, row_scale, scale, num_heads, N, eps, kernels[, terms])``"""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj, row_scale,
                scale, num_heads, N, eps, kernels, terms=None):
        fwd = fused_window_attn_block if kernels else window_attn_block_plain
        out = fwd(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj, scale, num_heads,
                  N, eps, row_scale)
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj,
                              row_scale, terms)
        ctx.args = (scale, num_heads, N, eps, kernels)
        return out

    @staticmethod
    def backward(ctx, g):
        (x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj, row_scale, terms
         ) = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (x, ln_w, ln_b, wqkv, bqkv, bias, wproj,
                                                         bproj)]
        with torch.enable_grad():
            out = composed_attn_block(*leaves[:6], region_ids, *leaves[6:], row_scale,
                                      *ctx.args, terms)
        dx, dln_w, dln_b, dwqkv, dbqkv, dbias, dwproj, dbproj = torch.autograd.grad(
            out, leaves, g)
        return (dx, dln_w, dln_b, dwqkv, dbqkv, dbias, None, dwproj, dbproj, None, None, None,
                None, None, None, None)


fused_window_attn_block.launches = 0
