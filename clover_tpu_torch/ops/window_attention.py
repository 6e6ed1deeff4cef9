"""Shifted-window attention on the flat qkv (kernel K1).

``flat2_window_attention(qkv2, bias, region_ids, scale, num_heads, N)``:
qkv2 (Bn*N, 3C) row-major, windows of N tokens back to back, sample-major
(window b of the batch uses mask row b % nW). For each window and head it
computes ``softmax(scale * q k^T + bias[h] + mask) v`` and returns
(Bn*N, C). Port of ``clover_tpu/ops/window_attention.py::
flat2_window_attention`` (and its ``_forward_flat`` fallback, which is the
same function on a (Bn, N, 3C) view of the same memory).

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
KEY_TILES = (4, 7, 13, 16)   # the kernel's instances: N <= 16 * key tiles


def region_mask(region_ids: torch.Tensor, dtype) -> torch.Tensor:
    """(nW, N) region ids -> (nW, N, N) additive mask (0 / -100)."""
    diff = region_ids[:, :, None] != region_ids[:, None, :]
    return torch.where(diff, MASK_VALUE, 0.0).to(dtype)


def window_attention_plain(qkv2, bias, region_ids, scale: float, num_heads: int,
                           N: int):
    """Plain PyTorch version: fp32 logits and softmax, probabilities rounded
    to the compute dtype before the product with v."""
    M, threeC = qkv2.shape
    C = threeC // 3
    hd = C // num_heads
    Bn = M // N
    dt = qkv2.dtype
    qkv = qkv2.view(Bn, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                      # (Bn, nH, N, hd)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits + bias.to(dt).float()[None]
    if region_ids is not None:
        mask = region_mask(region_ids, dt).float()
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


def flat2_window_attention(qkv2, bias, region_ids, scale: float, num_heads: int,
                           N: int):
    """qkv2 (Bn*N, 3C) -> (Bn*N, C); bias (nH, N, N); region_ids (nW, N)
    int32 or None (unshifted block)."""
    if not qkv2.is_cuda:
        return window_attention_plain(qkv2, bias, region_ids, scale, num_heads, N)
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
    key_tiles = next(t for t in KEY_TILES if N <= 16 * t)
    bias_f = fragment_bias(bias, N, key_tiles)
    nW = 1
    if region_ids is not None:
        nW = region_ids.shape[0]
        _build.require(region_ids, "region_ids", torch.int32, dev, (nW, N))
        if Bn % nW:
            raise ValueError(f"{Bn} windows are not a multiple of nW={nW}")
    out = torch.empty((M, C), dtype=qkv2.dtype, device=dev)
    _build.launch("clover_window_attention", qkv2, bias_f, region_ids, out, Bn, N, num_heads,
                  nW, key_tiles, float(scale), _build.stream(dev))
    flat2_window_attention.launches += 1
    return out


flat2_window_attention.launches = 0
