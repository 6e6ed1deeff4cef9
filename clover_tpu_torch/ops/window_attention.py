"""Shifted-window attention on the flat qkv (kernels K1 and K5).

``flat2_window_attention(qkv2, bias, region_ids, scale, num_heads, N)``:
qkv2 (Bn*N, 3C) row-major, windows of N tokens back to back, sample-major
(window b of the batch uses mask row b % nW). For each window and head it
computes ``softmax(scale * q k^T + bias[h] + mask) v`` and returns
(Bn*N, C). Port of ``clover_tpu/ops/window_attention.py::
flat2_window_attention`` (and its ``_forward_flat`` fallback, which is the
same function on a (Bn, N, 3C) view of the same memory).

``flat2_window_attention_bwd(qkv2, bias, region_ids, g2, scale, num_heads,
N) -> (dqkv2, dbias)`` is its backward (K5), the port of ``_backward_flat2``
(and ``_backward_flat``): the softmax recomputed from qkv2, dbias (nH, N, N)
fp32 summed over the windows, no gradient for the mask.
``WindowAttentionFn`` ties the two into autograd. At N=392 (the 32-frame
8x7x7 window) the same kernels, at 25 key tiles, also stand for the TPU's
head-group forms ``_forward_flat_grouped`` and ``_backward_flat_grouped``:
a block per (window, head) never needs head groups.

The shift mask is given as per-window region ids (nW, N) int32: keys in
another region than the query get -100, which is the reference's additive
mask (``swin3d.shift_attn_mask``); the TPU kernels' region-lanes form is a
TPU device and is not used here. As in the reference, the bias is rounded
to the compute dtype before the kernel (and before the plain version).
"""

from __future__ import annotations

import torch

from clover_tpu_torch.ops import _build

MASK_VALUE = -100.0
KEY_TILES = (4, 7, 13, 16, 19, 25)   # the kernels' instances: N <= 16 * key tiles
# the plain versions' (chunk, nH, N, N) fp32 logits stay under this many
# elements: unchunked, stage 0 of the 32-frame train step at B=16 would hold
# several (2048, 4, 392, 392) fp32 tensors, 5.0 GB each
_PLAIN_LOGITS = 1 << 27


def region_mask(region_ids: torch.Tensor, dtype) -> torch.Tensor:
    """(nW, N) region ids -> (nW, N, N) additive mask (0 / -100)."""
    diff = region_ids[:, :, None] != region_ids[:, None, :]
    return torch.where(diff, MASK_VALUE, 0.0).to(dtype)


def window_chunk(Bn: int, nW: int, num_heads: int, N: int, budget=None) -> int:
    """Windows per chunk of a plain version: a multiple of nW (so each chunk
    starts at mask row 0) that divides Bn, with the chunk's (chunk, nH, N, N)
    logits under ``budget`` elements (``_PLAIN_LOGITS`` when None) where one
    nW-group allows it."""
    budget = _PLAIN_LOGITS if budget is None else budget
    groups = Bn // nW
    per = min(groups, max(1, budget // (nW * num_heads * N * N)))
    while groups % per:
        per -= 1
    return per * nW


def window_attention_plain(qkv2, bias, region_ids, scale: float, num_heads: int,
                           N: int):
    """Plain PyTorch version: fp32 logits and softmax (float64 for float64
    inputs), probabilities rounded to the compute dtype before the product
    with v; over chunks of windows (:func:`window_chunk`)."""
    M, threeC = qkv2.shape
    nW = 1 if region_ids is None else region_ids.shape[0]
    step = window_chunk(M // N, nW, num_heads, N) * N
    if step >= M:
        return _attention_plain(qkv2, bias, region_ids, scale, num_heads, N)
    out = qkv2.new_empty((M, threeC // 3))
    for r0 in range(0, M, step):
        out[r0:r0 + step] = _attention_plain(qkv2[r0:r0 + step], bias, region_ids, scale,
                                             num_heads, N)
    return out


def _attention_plain(qkv2, bias, region_ids, scale: float, num_heads: int, N: int):
    M, threeC = qkv2.shape
    C = threeC // 3
    hd = C // num_heads
    Bn = M // N
    dt = qkv2.dtype
    acc = torch.promote_types(dt, torch.float32)
    qkv = qkv2.view(Bn, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                      # (Bn, nH, N, hd)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    logits = logits + bias.to(dt).to(acc)[None]
    if region_ids is not None:
        mask = region_mask(region_ids, dt).to(acc)
        nW = mask.shape[0]
        logits = (logits.view(Bn // nW, nW, num_heads, N, N)
                  + mask[None, :, None]).view(Bn, num_heads, N, N)
    probs = torch.softmax(logits, dim=-1).to(dt)
    out = torch.matmul(probs, v)                          # (Bn, nH, N, hd)
    return out.permute(0, 2, 1, 3).reshape(M, C)


def fragment_bias(bias, N: int, key_tiles: int) -> torch.Tensor:
    """(nH, N, N) bias -> bf16 in the order the kernel's mma accumulators
    hold the logits: [h][16-row strip][8-key tile][lane] x 4, lane 4*g + t
    holding rows g and g+8 of the strip at keys 2t and 2t+1 of the tile.
    Padded keys get -inf (they drop out of the softmax), padded rows 0."""
    nH, Np = bias.shape[0], 16 * key_tiles
    full = torch.zeros((nH, Np, Np), dtype=torch.bfloat16, device=bias.device)
    full[:, :, N:] = float("-inf")
    full[:, :N, :N] = bias
    # row = strip*16 + half*8 + g, key = tile*8 + t*2 + e
    full = full.view(nH, key_tiles, 2, 8, 2 * key_tiles, 4, 2)
    return full.permute(0, 1, 4, 3, 5, 2, 6).contiguous()


def window_attention_bwd_plain(qkv2, bias, region_ids, g2, scale: float, num_heads: int,
                               N: int):
    """Plain PyTorch version of the backward: the same math as K5 (and as
    ``_bwd_softmax_core``'s p32 form with the true row max), with products
    of compute-dtype values taken in fp32, over chunks of windows
    (:func:`window_chunk`), dbias summed over them in fp32. -> (dqkv2
    (Bn*N, 3C) in qkv2's dtype, dbias (nH, N, N) fp32, float64 for float64
    inputs)."""
    M, threeC = qkv2.shape
    nW = 1 if region_ids is None else region_ids.shape[0]
    step = window_chunk(M // N, nW, num_heads, N) * N
    if step >= M:
        return _attention_bwd_plain(qkv2, bias, region_ids, g2, scale, num_heads, N)
    dqkv2, dbias = torch.empty_like(qkv2), None
    for r0 in range(0, M, step):
        d, db = _attention_bwd_plain(qkv2[r0:r0 + step], bias, region_ids, g2[r0:r0 + step],
                                     scale, num_heads, N)
        dqkv2[r0:r0 + step] = d
        dbias = db if dbias is None else dbias.add_(db)
    return dqkv2, dbias


def _attention_bwd_plain(qkv2, bias, region_ids, g2, scale: float, num_heads: int, N: int):
    M, threeC = qkv2.shape
    C = threeC // 3
    hd = C // num_heads
    Bn = M // N
    dt = qkv2.dtype
    acc = torch.promote_types(dt, torch.float32)
    qkv = qkv2.view(Bn, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = (t.to(acc) for t in qkv)                    # (Bn, nH, N, hd)
    qs = (q * scale).to(dt).to(acc)
    logits = torch.matmul(qs, k.transpose(-1, -2)) + bias.to(dt).to(acc)[None]
    if region_ids is not None:
        mask = region_mask(region_ids, dt).to(acc)
        nW = mask.shape[0]
        logits = (logits.view(Bn // nW, nW, num_heads, N, N)
                  + mask[None, :, None]).view(Bn, num_heads, N, N)
    p32 = torch.softmax(logits, dim=-1)
    del logits
    gh = g2.view(Bn, N, num_heads, hd).permute(0, 2, 1, 3).to(acc)
    dv = torch.matmul(p32.to(dt).to(acc).transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    dlog = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
    del dp, p32
    dlog_b = dlog.to(dt).to(acc)
    dq = torch.matmul(dlog_b, k) * scale
    dk = torch.matmul(dlog_b.transpose(-1, -2), qs)
    dbias = dlog.sum(0)
    dqkv = torch.stack([dq, dk, dv]).to(dt)               # (3, Bn, nH, N, hd)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(M, threeC), dbias


def _kernel_shapes(qkv2, bias, region_ids, num_heads: int, N: int):
    """Check what K1 and K5 take; -> (Bn, C, nW, key tiles)."""
    M, threeC = qkv2.shape
    C = threeC // 3
    hd = C // num_heads
    Bn = M // N
    dev = qkv2.device
    if hd != 32 or C != num_heads * hd or Bn * N != M or N > 16 * KEY_TILES[-1]:
        raise ValueError(f"window-attention kernel takes head dim 32 and "
                         f"N <= {16 * KEY_TILES[-1]}; got C={C}, heads={num_heads}, N={N}, "
                         f"rows={M}")
    _build.require(qkv2, "qkv2", torch.bfloat16, dev)
    if bias.device != dev or tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"bias: {tuple(bias.shape)} on {bias.device}, expected "
                         f"{(num_heads, N, N)} on {dev}")
    nW = 1
    if region_ids is not None:
        nW = region_ids.shape[0]
        _build.require(region_ids, "region_ids", torch.int32, dev, (nW, N))
        if Bn % nW:
            raise ValueError(f"{Bn} windows are not a multiple of nW={nW}")
    return Bn, C, nW, next(t for t in KEY_TILES if N <= 16 * t)


def flat2_window_attention(qkv2, bias, region_ids, scale: float, num_heads: int,
                           N: int):
    """qkv2 (Bn*N, 3C) -> (Bn*N, C); bias (nH, N, N); region_ids (nW, N)
    int32 or None (unshifted block)."""
    if not qkv2.is_cuda:
        return window_attention_plain(qkv2, bias, region_ids, scale, num_heads, N)
    Bn, C, nW, key_tiles = _kernel_shapes(qkv2, bias, region_ids, num_heads, N)
    M, dev = qkv2.shape[0], qkv2.device
    bias_f = fragment_bias(bias, N, key_tiles)
    out = torch.empty((M, C), dtype=qkv2.dtype, device=dev)
    _build.launch("clover_window_attention", qkv2, bias_f, region_ids, out, Bn, N, num_heads,
                  nW, key_tiles, float(scale), _build.stream(dev))
    flat2_window_attention.launches += 1
    return out


def _bwd_chunks(Bn: int, num_heads: int, device) -> int:
    """Window chunks per head for K5: about two blocks per SM in all,
    preferring a divisor of Bn so every block walks as many windows."""
    target = max(1, 2 * torch.cuda.get_device_properties(device).multi_processor_count
                 // num_heads)
    for c in range(min(Bn, target), 0, -1):
        if Bn % c == 0 and 2 * c > target:
            return c
    return min(Bn, target)


def flat2_window_attention_bwd(qkv2, bias, region_ids, g2, scale: float, num_heads: int,
                               N: int):
    """Backward of ``flat2_window_attention`` for the output gradient g2
    (Bn*N, C): -> (dqkv2 (Bn*N, 3C), dbias (nH, N, N) fp32)."""
    if not qkv2.is_cuda:
        return window_attention_bwd_plain(qkv2, bias, region_ids, g2, scale, num_heads, N)
    Bn, C, nW, key_tiles = _kernel_shapes(qkv2, bias, region_ids, num_heads, N)
    M, dev = qkv2.shape[0], qkv2.device
    _build.require(g2, "g2", torch.bfloat16, dev, (M, C))
    bias_r = fragment_bias(bias, N, key_tiles)
    bias_c = fragment_bias(bias.transpose(1, 2), N, key_tiles)
    chunks = _bwd_chunks(Bn, num_heads, dev)
    Np = 16 * key_tiles
    # each chunk's dbias partial; the kernel writes it before it reads it
    part = torch.empty((chunks, num_heads, Np, Np), dtype=torch.float32, device=dev)
    dqkv2 = torch.empty_like(qkv2)
    dbias = torch.empty((num_heads, N, N), dtype=torch.float32, device=dev)
    _build.launch("clover_window_attention_bwd", qkv2, g2, bias_r, bias_c, region_ids, dqkv2,
                  part, dbias, Bn, N, num_heads, nW, key_tiles, chunks, float(scale),
                  _build.stream(dev))
    flat2_window_attention_bwd.launches += 1
    return dqkv2, dbias


class WindowAttentionFn(torch.autograd.Function):
    """Window attention with its backward: K1 forward and K5 backward
    (``kernels=True``; their plain versions for CPU tensors), or both plain
    versions (``kernels=False``). Saves qkv2, the bias rounded to qkv2's
    dtype and the region ids; returns dbias in the bias's dtype so that it
    flows back through ``bias_from_table`` into the table. The region ids
    get no gradient (the JAX package's zero-mask-gradient contract).

    ``WindowAttentionFn.apply(qkv2, bias, region_ids, scale, num_heads, N,
    kernels)``"""

    @staticmethod
    def forward(ctx, qkv2, bias, region_ids, scale, num_heads, N, kernels):
        bias_c = bias.detach().to(qkv2.dtype)
        fwd = flat2_window_attention if kernels else window_attention_plain
        out = fwd(qkv2, bias_c, region_ids, scale, num_heads, N)
        ctx.save_for_backward(qkv2, bias_c, region_ids)
        ctx.args = (scale, num_heads, N, kernels, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv2, bias_c, region_ids = ctx.saved_tensors
        scale, num_heads, N, kernels, bias_dtype = ctx.args
        bwd = flat2_window_attention_bwd if kernels else window_attention_bwd_plain
        dqkv2, dbias = bwd(qkv2, bias_c, region_ids, g.contiguous(), scale, num_heads, N)
        return dqkv2, dbias.to(bias_dtype), None, None, None, None, None


flat2_window_attention.launches = 0
flat2_window_attention_bwd.launches = 0
