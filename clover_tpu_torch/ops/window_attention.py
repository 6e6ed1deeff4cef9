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
fp32 summed over the windows, no gradient for the mask. It is three
launches: a row pass (dq and each query's logsumexp and rowsum(dp * P)), a
key pass (dk, dv, and dbias shares held on chip across the windows a block
walks) and a finish that sums the shares; ``_bwd_grid`` sizes them, and
``window_attention_bwd_rows_plain`` / ``window_attention_bwd_keys_plain``
are the two passes in plain PyTorch.
``WindowAttentionFn`` ties the two into autograd. At N=392 (the 32-frame
8x7x7 window) the same kernels, at 25 key tiles, also stand for the TPU's
head-group forms ``_forward_flat_grouped`` and ``_backward_flat_grouped``:
a block per (window, head) never needs head groups.

The shift mask is given as per-window region ids (nW, N) int32: keys in
another region than the query get -100, which is the reference's additive
mask (``swin3d.shift_attn_mask``); the TPU kernels' region-lanes form is a
TPU device and is not used here. As in the reference, the bias is rounded
to the compute dtype before the kernel (and before the plain version).

The other window-attention forwards of the JAX module:

- ``fused_window_attention(q, k, v, bias, mask, scale)`` (K9): head-major
  q/k/v (Bn, nH, N, hd), the fp32 bias (nH, N, N) and an fp32 additive mask
  (nW, N, N) or None, fp32 logits; the port of ``_forward`` and
  ``_forward_v2`` (v2 / v4), three TPU blockings of one function.
  ``HeadsWindowAttentionFn`` adds ``_bwd``'s plain backward, the mask's
  gradient included.
- ``spatial_window_attention(qkv5, bias, mask_grid, window, scale)`` (K10):
  the same attention with each window read straight from the padded
  (B, Dp, Hp, Wp, 3, nH, hd) qkv grid, the mask as a (gd, gh, gw, N, N)
  grid; the port of ``fused_partition_window_attention``.
  ``SpatialWindowAttentionFn`` adds ``_spatial_bwd``'s plain backward.
- K9 and K10 read the bias and mask as fp32 in accumulator order
  (``bias_terms``, ``mask_terms``: one 16-byte load per lane and 8-key
  tile). The wrappers lay them out, or take them laid out already through
  ``terms=``: the Swin model caches the mask's as a device constant and,
  in eval, the bias's beside its bias cache.
- ``flash_window_attention`` and ``flat_flash_window_attention`` (K11): the
  key-tiled online softmax of ``_forward_long`` (head-major, reached from the
  flat qkv through ``long_window_attention_from_flat``, the port of
  ``_forward_long_from_flat``) and ``_forward_flat_flash`` (the flat qkv),
  bias rounded to the compute dtype, the mask as region ids. The kernel
  reads K1's terms (the bf16 bias in accumulator order at ceil(N / 16)
  16-key steps, the region ids) and walks only those steps; ``flash_grid``
  mirrors its launch shape. They feed the forward of ``WindowAttentionFn``
  (``long_attn``); its backward stays K5.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from clover_tpu_torch.ops import _build

MASK_VALUE = -100.0
KEY_TILES = (4, 7, 13, 16, 19, 25)   # the kernels' instances: N <= 16 * key tiles
# the plain versions' (chunk, nH, N, N) fp32 logits stay under this many
# elements: unchunked, stage 0 of the 32-frame train step at B=16 would hold
# several (2048, 4, 392, 392) fp32 tensors, 5.0 GB each
_PLAIN_LOGITS = 1 << 27


@functools.lru_cache(maxsize=None)
def key_tiles(N: int) -> int:
    """The 16-key tiles of the kernel instance that takes windows of N tokens."""
    return next(t for t in KEY_TILES if N <= 16 * t)


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


def fragment_terms(t, N: int, key_tiles: int, pad: float, dtype=None) -> torch.Tensor:
    """(X, N, N) -> the same values, in ``dtype`` (default ``t``'s), in the
    order the kernels' mma accumulators hold the logits: [x][16-row
    strip][8-key tile][lane] x 4, lane 4*g + t holding rows g and g+8 of the
    strip at keys 2t and 2t+1 of the tile, as a (X, strips, tiles, 8, 4, 2,
    2) tensor. Padded keys get ``pad`` in every row (-inf for a bias: they
    drop out of the softmax), the rest of the padding 0."""
    X, Np = t.shape[0], 16 * key_tiles
    full = torch.zeros((X, Np, Np), dtype=dtype or t.dtype, device=t.device)
    if pad != 0:
        full[:, :, N:] = pad
    full[:, :N, :N] = t
    # row = strip*16 + half*8 + g, key = tile*8 + t*2 + e
    full = full.view(X, key_tiles, 2, 8, 2 * key_tiles, 4, 2)
    return full.permute(0, 1, 4, 3, 5, 2, 6).contiguous()


def fragment_bias(bias, N: int, key_tiles: int) -> torch.Tensor:
    """(nH, N, N) bias -> bf16 in accumulator order (:func:`fragment_terms`),
    -inf in the padded keys: what K1, K5 and K6 read."""
    return fragment_terms(bias, N, key_tiles, float("-inf"), torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _transpose_index(N: int, kt: int, device) -> torch.Tensor:
    """int32 (16 kt)^2: position p of the transposed bias's layout ->
    the position of :func:`fragment_bias`'s layout of the bias that holds
    its value: bias[h, k, q] for (q, k) both below N, else a position that
    holds the same padding (-inf in a padded key, 0 in a padded query)."""
    with torch.inference_mode(False):
        Np = 16 * kt
        logical = fragment_terms(torch.arange(Np * Np).view(1, Np, Np), Np, kt, 0).flatten()
        where = torch.empty_like(logical)
        where[logical] = torch.arange(Np * Np)        # logical (q, k) -> layout position
        src = torch.arange(Np * Np).view(Np, Np).t().clone()   # (q, k) <- (k, q)
        src[:, N:] = N                                  # a padded key: (0, N), -inf
        src[N:, :N] = N * Np                            # a padded query: (N, 0), 0
        return where[src.flatten()[logical]].to(device, torch.int32)


def transposed_terms(terms, N: int) -> torch.Tensor:
    """:func:`fragment_bias` of the bias transposed, bitwise, from
    :func:`fragment_bias` of the bias: one gather with a permutation (K5's
    column form of K1's terms)."""
    nH, kt = terms.shape[0], terms.shape[1]
    idx = _transpose_index(N, kt, terms.device)
    return terms.view(nH, -1).index_select(1, idx).view(terms.shape)


def fragment_index(index, table_len: int, key_tiles: int) -> torch.Tensor:
    """(X, N, N) int64 rows of a (table_len, ...) table -> the same rows in
    accumulator order (:func:`fragment_terms`), with row ``table_len`` (a
    row of zeros) in the padded queries of the real keys and ``table_len +
    1`` (a row of -inf) in the padded keys: gathering a table extended by
    those two rows with it gives :func:`fragment_bias` of the gathered bias
    in one step."""
    return fragment_terms(index - table_len, index.shape[-1], key_tiles, 1) + table_len


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


def _bwd_operands(qkv2, bias, region_ids, g2, scale: float, num_heads: int, N: int):
    """What every form of the backward recomputes, in fp32 (float64 for
    float64 inputs): qs = q * scale rounded to the compute dtype, k, v and
    the output gradient g as (Bn, nH, N, hd), and the logits (Bn, nH, N,
    N) with the bias and the region mask."""
    M, threeC = qkv2.shape
    hd = threeC // 3 // num_heads
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
    gh = g2.view(Bn, N, num_heads, hd).permute(0, 2, 1, 3).to(acc)
    return qs, k, v, gh, logits


def _heads_to_rows(t, dt):
    """(Bn, nH, N, hd) -> (Bn*N, nH*hd) in ``dt``."""
    Bn, nH, N, hd = t.shape
    return t.to(dt).permute(0, 2, 1, 3).reshape(Bn * N, nH * hd)


def _attention_bwd_plain(qkv2, bias, region_ids, g2, scale: float, num_heads: int, N: int):
    M, threeC = qkv2.shape
    dt = qkv2.dtype
    qs, k, v, gh, logits = _bwd_operands(qkv2, bias, region_ids, g2, scale, num_heads, N)
    acc = logits.dtype
    p32 = torch.softmax(logits, dim=-1)
    del logits
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


def window_attention_bwd_rows_plain(qkv2, bias, region_ids, g2, scale: float, num_heads: int,
                                    N: int):
    """K5's row pass in plain PyTorch, on all windows at once (for the
    tests' shapes): -> (dq (Bn*N, C) in qkv2's dtype,
    stats (Bn, nH, N, 2) fp32 (float64 for float64 inputs), each query's
    logsumexp of the logits and rowsum(dp * P))."""
    qs, k, v, gh, logits = _bwd_operands(qkv2, bias, region_ids, g2, scale, num_heads, N)
    acc = logits.dtype
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - lse)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    D = (dp * p).sum(-1, keepdim=True)
    dlog = (p * (dp - D)).to(qkv2.dtype).to(acc)
    dq = torch.matmul(dlog, k) * scale
    return _heads_to_rows(dq, qkv2.dtype), torch.cat([lse, D], dim=-1)


def window_attention_bwd_keys_plain(qkv2, bias, region_ids, g2, stats, scale: float,
                                    num_heads: int, N: int):
    """K5's key pass in plain PyTorch from the row pass's ``stats``, on all
    windows at once: P = exp(logits - logsumexp), dlog = P * (dp - D) ->
    (dk, dv (Bn*N, C) in qkv2's dtype, dbias (nH, N, N) summed over the
    windows, fp32 or float64)."""
    dt = qkv2.dtype
    qs, k, v, gh, logits = _bwd_operands(qkv2, bias, region_ids, g2, scale, num_heads, N)
    acc = logits.dtype
    p = torch.exp(logits - stats[..., :1].to(acc))
    dp = torch.matmul(gh, v.transpose(-1, -2))
    dlog = p * (dp - stats[..., 1:].to(acc))
    dv = torch.matmul(p.to(dt).to(acc).transpose(-1, -2), gh)
    dk = torch.matmul(dlog.to(dt).to(acc).transpose(-1, -2), qs)
    return _heads_to_rows(dk, dt), _heads_to_rows(dv, dt), dlog.sum(0)


def _check_bias(bias, num_heads: int, N: int, dev) -> None:
    if bias.device != dev or tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"bias: {tuple(bias.shape)} on {bias.device}, expected "
                         f"{(num_heads, N, N)} on {dev}")


def _region_nW(region_ids, Bn: int, N: int, dev) -> int:
    """Check the (nW, N) int32 region ids a kernel takes; -> nW (1 if None)."""
    if region_ids is None:
        return 1
    nW = region_ids.shape[0]
    _build.require(region_ids, "region_ids", torch.int32, dev, (nW, N))
    if Bn % nW:
        raise ValueError(f"{Bn} windows are not a multiple of nW={nW}")
    return nW


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
    _check_bias(bias, num_heads, N, dev)
    return Bn, C, _region_nW(region_ids, Bn, N, dev), key_tiles(N)


# K1's blocks, mirrored from csrc/window_attention.cu: 4 warps, two an SM
# where their registers are not capped, three where they are
_K1_WALK_MAX = 16          # clips a block walks at most
_K1_STAGE_LIMIT = 116224   # two staging buffers fit where their bytes stay under half an SM's
_K1_SMEM_SM = 233472       # shared memory of an SM


class K1Grid(NamedTuple):
    """K1's launch plan (:func:`k1_grid`)."""
    per: int           # clips of one mask row a block walks
    min_blocks: int    # blocks an SM the registers are capped for (1: no cap, or 3)
    blocks: int
    smem: int          # dynamic shared memory of a block, bytes


def _k1_smem(kt: int, tiles: int, stages: int) -> int:
    """Shared memory of a K1 block: ``stages`` buffers of ``tiles`` staged
    (16 kt, 40) bf16 tiles, then the region ids."""
    return _align128(stages * tiles * 16 * kt * _LD * 2) + 16 * kt * 4


def _k1_tiles(kt: int) -> int:
    """Tiles a K1 buffer stages: q, k and v where three blocks' single
    buffers fit an SM (up to 19 key tiles), else k and v."""
    return 3 if 3 * _k1_smem(kt, 3, 1) <= _K1_SMEM_SM else 2


def _k1_stages(kt: int, per: int) -> int:
    """K1's staging buffers: two where a block walks more than one clip and
    two fit (up to 13 key tiles), else one."""
    return 2 if per > 1 and 2 * _k1_smem(kt, _k1_tiles(kt), 1) <= _K1_STAGE_LIMIT else 1


@functools.lru_cache(maxsize=None)
def k1_grid(Bn: int, num_heads: int, N: int, sms: int, nW: int = 1) -> K1Grid:
    """K1's plan for Bn windows (nW mask rows) of N tokens on a card of
    ``sms`` SMs; the C entry point refuses plans that disagree with it.

    A block takes one head and ``per`` clips of one mask row and stages
    the next window by cp.async while one runs where two buffers fit (up to
    13 key tiles). q is staged with k and v where three blocks' buffers fit
    an SM (up to 19 key tiles), else each warp reads its q strip. A call of
    at least four waves of one-window blocks at three an SM (12 sms (window,
    head) pairs) takes one window a block with the registers capped for
    three blocks an SM; a smaller one, where two buffers fit, the most clips
    a block (a power of two, at most 16) that still give a full wave at two
    blocks an SM, else one window a block. The choice is the fastest of the
    variants measured at each call shape of the eval and train paths, or
    within 3% of it (PERF.md, section 6)."""
    kt, pairs, clips = key_tiles(N), Bn * num_heads, Bn // nW
    large = pairs >= 4 * 3 * sms
    per = 1
    if not large and _k1_stages(kt, 2) == 2:
        full = 0.95 * 2 * sms
        per = max(p for p in (1, 2, 4, 8, _K1_WALK_MAX)
                  if p == 1 or (p <= clips and num_heads * nW * -(-clips // p) >= full))
    return K1Grid(per, 3 if large else 1, num_heads * nW * -(-clips // per),
                  _k1_smem(kt, _k1_tiles(kt), _k1_stages(kt, per)))


def _k1_bias_terms(terms, bias, N: int, kt: int):
    """K1's bias terms: ``terms`` (bf16 in accumulator order, checked) or,
    when None, the wrapper's layout of ``bias``."""
    if terms is None:
        return fragment_bias(bias, N, kt)
    _build.require(terms, "terms", torch.bfloat16, bias.device,
                   (bias.shape[0], kt, 2 * kt, 8, 4, 2, 2))
    return terms


def k1_launch(qkv2, terms, region_ids, out, grid: K1Grid, scale: float, num_heads: int, N: int):
    """One launch of K1 under ``grid`` on checked CUDA tensors (terms laid out)."""
    Bn, nW = qkv2.shape[0] // N, 1 if region_ids is None else region_ids.shape[0]
    _build.launch("clover_window_attention", qkv2, terms, region_ids, out, Bn, N, num_heads, nW,
                  key_tiles(N), grid.per, grid.min_blocks, float(scale),
                  _build.stream(qkv2.device))


def flat2_window_attention(qkv2, bias, region_ids, scale: float, num_heads: int,
                           N: int, terms=None):
    """qkv2 (Bn*N, 3C) -> (Bn*N, C); bias (nH, N, N); region_ids (nW, N)
    int32 or None (unshifted block). ``terms``: the bias already in
    accumulator order (:func:`fragment_bias`; the model's cached or
    table-gathered form), None for the wrapper to lay it out."""
    if not qkv2.is_cuda:
        return window_attention_plain(qkv2, bias, region_ids, scale, num_heads, N)
    Bn, C, nW, kt = _kernel_shapes(qkv2, bias, region_ids, num_heads, N)
    terms = _k1_bias_terms(terms, bias, N, kt)
    out = torch.empty((qkv2.shape[0], C), dtype=qkv2.dtype, device=qkv2.device)
    k1_launch(qkv2, terms, region_ids, out, k1_grid(Bn, num_heads, N, _build.sms(qkv2.device), nW),
              scale, num_heads, N)
    flat2_window_attention.launches += 1
    return out


# K5's blocks, mirrored from csrc/window_attention_bwd.cu: a row-pass block
# is 8 warps, one 16-row query strip each, three blocks an SM; a key-pass
# block is 2 key tiles x 8 strip groups, 16 warps, one block an SM
_ROW_WARPS, _KEY_TILES, _KEY_STRIP_GROUPS, _KEY_BLOCKS_PER_SM = 8, 2, 8, 1
_LD = 40   # the staged tiles' row stride in bf16


class BwdGrid(NamedTuple):
    """K5's launch shape (:func:`_bwd_grid`)."""
    row_groups: int        # row pass: query-strip groups of a window (grid x)
    key_groups: int        # key pass: pairs of 16-key tiles (grid x)
    chunks: int            # key pass: windows b = c, c + chunks, ... a block walks
    row_blocks: int        # blocks of each pass
    key_blocks: int
    row_smem: int          # shared memory of a block, bytes
    key_smem: int
    stats_bytes: int       # the row statistics, (Bn, nH, 16 key tiles) x (fp32, fp32)
    workspace_bytes: int   # the key pass's dbias shares, chunks x nH x 16 strips x Np fp32


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _bwd_grid(Bn: int, num_heads: int, N: int, sms: int) -> BwdGrid:
    """K5's grid on a card of ``sms`` SMs. The row pass takes a block per
    (strip group, window, head). The key pass's blocks hold their dbias
    share across the windows they walk, so its grid is nH x key groups x
    chunks; the chunks are picked from at least one block per SM to about
    four waves, for the fewest windows a block slot walks (whole waves x
    windows a block), the fewest chunks on a tie: fewer shares to write and
    sum."""
    kt = key_tiles(N)
    Np, strips = 16 * kt, -(-N // 16)
    tile = lambda rows: _align128(2 * rows * _LD * 2)   # noqa: E731  two bf16 tiles
    row_groups = -(-strips // _ROW_WARPS)
    key_groups = -(-strips // _KEY_TILES)
    per_chunk, slots = num_heads * key_groups, _KEY_BLOCKS_PER_SM * sms
    hi = min(Bn, max(1, -(-4 * slots // per_chunk)))
    lo = min(hi, -(-slots // per_chunk))
    chunks = min(range(lo, hi + 1),
                 key=lambda c: (-(-per_chunk * c // slots) * -(-Bn // c), c))
    key_buf = _align128(tile(Np) + tile(16 * _KEY_TILES) + Np * 12)
    return BwdGrid(row_groups, key_groups, chunks, row_groups * Bn * num_heads,
                   per_chunk * chunks, tile(Np) + Np * 4,
                   2 * key_buf + _KEY_TILES * _KEY_STRIP_GROUPS * 32 * 32 * 4,
                   Bn * num_heads * Np * 8, chunks * num_heads * strips * 16 * Np * 4)


def _bwd_launch(qkv2, bias, region_ids, g2, scale: float, num_heads: int, N: int,
                terms=None):
    """K5's three launches (row pass, key pass, finish) on CUDA tensors ->
    (dqkv2, dbias, stats): stats (Bn, nH, 16 key tiles, 2) fp32 is the row
    pass's (logsumexp, rowsum(dp * P)) per query, (+inf, 0) in the padded
    rows of each strip, unwritten past the last strip. ``terms``: K1's
    (checked; the key pass's transposed form gathered from them), or None
    for both forms laid out here."""
    Bn, C, nW, kt = _kernel_shapes(qkv2, bias, region_ids, num_heads, N)
    M, dev = qkv2.shape[0], qkv2.device
    _build.require(g2, "g2", torch.bfloat16, dev, (M, C))
    if terms is None:
        bias_r, bias_c = fragment_bias(bias, N, kt), fragment_bias(bias.transpose(1, 2), N, kt)
    else:
        bias_r = _k1_bias_terms(terms, bias, N, kt)
        bias_c = transposed_terms(bias_r, N)
    grid = _bwd_grid(Bn, num_heads, N, _build.sms(dev))
    Np, strips = 16 * kt, -(-N // 16)
    f32 = dict(dtype=torch.float32, device=dev)
    stats = torch.empty((Bn, num_heads, Np, 2), **f32)
    part = torch.empty((grid.chunks, num_heads, 16 * strips, Np), **f32)
    dqkv2 = torch.empty_like(qkv2)
    dbias = torch.empty((num_heads, N, N), **f32)
    _build.launch("clover_window_attention_bwd", qkv2, g2, bias_r, bias_c, region_ids, dqkv2,
                  stats, part, dbias, Bn, N, num_heads, nW, kt, grid.row_groups,
                  grid.key_groups, grid.chunks, float(scale), _build.stream(dev))
    return dqkv2, dbias, stats


def flat2_window_attention_bwd(qkv2, bias, region_ids, g2, scale: float, num_heads: int,
                               N: int, terms=None):
    """Backward of ``flat2_window_attention`` for the output gradient g2
    (Bn*N, C): -> (dqkv2 (Bn*N, 3C), dbias (nH, N, N) fp32). ``terms``:
    as :func:`flat2_window_attention` takes them."""
    if not qkv2.is_cuda:
        return window_attention_bwd_plain(qkv2, bias, region_ids, g2, scale, num_heads, N)
    dqkv2, dbias, _ = _bwd_launch(qkv2, bias, region_ids, g2, scale, num_heads, N, terms)
    flat2_window_attention_bwd.launches += 1
    return dqkv2, dbias


class WindowAttentionFn(torch.autograd.Function):
    """Window attention with its backward: K1 forward and K5 backward
    (``kernels=True``; their plain versions for CPU tensors), or both plain
    versions (``kernels=False``). ``long_attn`` 'v7' / 'v6' takes the
    forward through K11 instead of K1 (``flat_flash_window_attention`` /
    ``long_window_attention_from_flat``, the JAX ``CLOVER_WA_LONG``
    routes), with the same K5 backward, as the JAX ``_flat_bwd`` is for
    them. Saves qkv2, the bias rounded to qkv2's dtype and the region ids;
    returns dbias in the bias's dtype so that it flows back through
    ``bias_from_table`` into the table. The region ids get no gradient (the
    JAX package's zero-mask-gradient contract). ``terms``: the bias in
    accumulator order (:func:`fragment_bias`) for K1 and K5, saved for the
    backward, or None for the wrappers to lay it out; detached values, so
    no gradient changes.

    ``WindowAttentionFn.apply(qkv2, bias, region_ids, scale, num_heads, N,
    kernels[, long_attn, terms])``"""

    @staticmethod
    def forward(ctx, qkv2, bias, region_ids, scale, num_heads, N, kernels, long_attn="off",
                terms=None):
        bias_c = bias.detach().to(qkv2.dtype)
        terms = terms if kernels else None
        fwd = {"off": (flat2_window_attention, window_attention_plain),
               "v7": (flat_flash_window_attention, window_attention_flat_flash_plain),
               "v6": (long_window_attention_from_flat, window_attention_flat_flash_plain),
               }[long_attn][0 if kernels else 1]
        kw = {"terms": terms} if fwd is flat2_window_attention else {}
        out = fwd(qkv2, bias_c, region_ids, scale, num_heads, N, **kw)
        ctx.save_for_backward(qkv2, bias_c, region_ids, terms)
        ctx.args = (scale, num_heads, N, kernels, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv2, bias_c, region_ids, terms = ctx.saved_tensors
        scale, num_heads, N, kernels, bias_dtype = ctx.args
        bwd = flat2_window_attention_bwd if kernels else window_attention_bwd_plain
        kw = {"terms": terms} if kernels else {}
        dqkv2, dbias = bwd(qkv2, bias_c, region_ids, g.contiguous(), scale, num_heads, N, **kw)
        return dqkv2, dbias.to(bias_dtype), None, None, None, None, None, None, None


# ----------------------------------------------------- K9: head-major (#7, #8)

def _heads_logits(q, k, bias, mask, scale: float, acc):
    """fp32 (float64 for float64 inputs) scale * q k^T + bias (+ mask of
    window b % nW) of (Bn, nH, N, hd) q, k -> (Bn, nH, N, N)."""
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale + bias.to(acc)[None]
    if mask is not None:
        Bn, nH, N, _ = logits.shape
        nW = mask.shape[0]
        logits = (logits.view(Bn // nW, nW, nH, N, N) + mask.to(acc)[None, :, None]).view(
            Bn, nH, N, N)
    return logits


def _over_window_chunks(fn, Bn: int, nW: int, nH: int, N: int, *tensors):
    """fn over chunks of whole nW-groups of windows (:func:`window_chunk`);
    ``tensors`` are cut along dim 0, fn's one output concatenated."""
    step = window_chunk(Bn, nW, nH, N)
    if step >= Bn:
        return fn(*tensors)
    return torch.cat([fn(*(t[b0:b0 + step] for t in tensors)) for b0 in range(0, Bn, step)])


def window_attention_heads_plain(q, k, v, bias, mask, scale: float):
    """Plain version of K9: q, k, v (Bn, nH, N, hd) -> (Bn, nH, N, hd);
    fp32 logits with the fp32 bias and mask, probabilities rounded to the
    compute dtype before the product with v; over chunks of windows."""
    Bn, nH, N, _ = q.shape
    nW = 1 if mask is None else mask.shape[0]
    acc = torch.promote_types(q.dtype, torch.float32)

    def run(q, k, v):
        probs = torch.softmax(_heads_logits(q, k, bias, mask, scale, acc), dim=-1)
        return torch.matmul(probs.to(q.dtype), v)

    return _over_window_chunks(run, Bn, nW, nH, N, q, k, v)


def window_attention_heads_bwd_plain(q, k, v, bias, mask, g, scale: float):
    """``_bwd``'s math: the fp32 softmax recomputed from q, k, bias and mask,
    products in fp32 -> (dq, dk, dv in q's dtype, dbias (nH, N, N) fp32,
    dmask (nW, N, N) fp32 or None), over chunks of windows, dbias and dmask
    summed over them."""
    Bn, nH, N, _ = q.shape
    nW = 1 if mask is None else mask.shape[0]
    acc = torch.promote_types(q.dtype, torch.float32)
    step = window_chunk(Bn, nW, nH, N)
    dqkv, dbias, dmask = [], 0, 0
    for b0 in range(0, Bn, step):
        qc, kc, vc, gc = (t[b0:b0 + step].to(acc) for t in (q, k, v, g))
        probs = torch.softmax(_heads_logits(qc, kc, bias, mask, scale, acc), dim=-1)
        dv = torch.matmul(probs.transpose(-1, -2), gc)
        dp = torch.matmul(gc, vc.transpose(-1, -2))
        dlog = probs * (dp - (dp * probs).sum(-1, keepdim=True))
        del probs, dp
        dqkv.append(torch.stack([torch.matmul(dlog, kc) * scale,
                                 torch.matmul(dlog.transpose(-1, -2), qc) * scale, dv]))
        dbias = dbias + dlog.sum(0)
        if mask is not None:
            dmask = dmask + dlog.view(-1, nW, nH, N, N).sum((0, 2))
    dq, dk, dv = torch.cat(dqkv, dim=1).to(q.dtype).unbind(0)
    return dq, dk, dv, dbias, (None if mask is None else dmask)


def _heads_kernel_args(q, k, v, bias, mask):
    """Check what K9 takes; -> (Bn, nH, N, nW, key tiles)."""
    Bn, nH, N, hd = q.shape
    dev = q.device
    if hd != 32 or N > 16 * KEY_TILES[-1]:
        raise ValueError(f"window-attention kernel takes head dim 32 and N <= "
                         f"{16 * KEY_TILES[-1]}; got head dim {hd}, N={N}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, name, torch.bfloat16, dev, (Bn, nH, N, hd))
    _build.require(bias, "bias", torch.float32, dev, (nH, N, N))
    nW = 1
    if mask is not None:
        nW = mask.shape[0]
        _build.require(mask, "mask", torch.float32, dev, (nW, N, N))
        if Bn % nW:
            raise ValueError(f"{Bn} windows are not a multiple of nW={nW}")
    return Bn, nH, N, nW, key_tiles(N)


def bias_terms(bias, N: int) -> torch.Tensor:
    """K9 and K10's bias term: the fp32 (nH, N, N) bias in accumulator order
    (:func:`fragment_terms`), -inf in the padded keys."""
    return fragment_terms(bias, N, key_tiles(N), float("-inf"))


def mask_terms(mask, N: int) -> torch.Tensor:
    """K9 and K10's mask term: the fp32 (nW, N, N) mask in accumulator order,
    0 in the padding."""
    return fragment_terms(mask, N, key_tiles(N), 0.0)


def _kernel_terms(terms, bias, mask, N: int):
    """(bias, mask) terms for K9 / K10: those of ``terms`` (a pair, each
    already in accumulator order or None) and, for each None, the wrapper's
    layout of ``bias`` / ``mask`` (None without a mask), each checked
    against the shape the kernel reads."""
    bt, mt = (None, None) if terms is None else terms
    bt = bias_terms(bias, N) if bt is None else bt
    mt = None if mask is None else (mask_terms(mask, N) if mt is None else mt)
    tile = (key_tiles(N), 2 * key_tiles(N), 8, 4, 2, 2)
    _build.require(bt, "bias terms", torch.float32, bias.device, (bias.shape[0], *tile))
    if mask is not None:
        _build.require(mt, "mask terms", torch.float32, bias.device, (mask.shape[0], *tile))
    return bt, mt


def windows_per_block(windows: int, num_heads: int, sms: int) -> int:
    """Windows a K9 / K10 block walks on a card of ``sms`` SMs: the most, up
    to 16, that still leave four blocks for each of the card's block slots
    (two an SM: 192 registers a thread at 13 key tiles), so the grid fills
    the card and its last wave is short."""
    return max(1, min(16, windows * num_heads // (8 * sms)))


def fused_window_attention(q, k, v, bias, mask, scale: float, terms=None):
    """softmax(scale * q k^T + bias (+ mask)) v: q, k, v (Bn, nH, N, hd)
    bf16 -> (Bn, nH, N, hd); bias (nH, N, N) fp32; mask (nW, N, N) fp32
    additive or None (window b takes row b % nW). ``terms``: (bias terms,
    mask terms) already in accumulator order (:func:`bias_terms`,
    :func:`mask_terms`), either None for the wrapper to lay out; the model
    passes its cached forms."""
    if not q.is_cuda:
        return window_attention_heads_plain(q, k, v, bias, mask, scale)
    Bn, nH, N, nW, kt = _heads_kernel_args(q, k, v, bias, mask)
    bt, mt = _kernel_terms(terms, bias, mask, N)
    out = torch.empty_like(q)
    _build.launch("clover_window_attention_heads", q, k, v, bt, mt, out, Bn, N, nH, nW, kt,
                  windows_per_block(Bn, nH, _build.sms(q.device)), float(scale),
                  _build.stream(q.device))
    fused_window_attention.launches += 1
    return out


class HeadsWindowAttentionFn(torch.autograd.Function):
    """``fused_window_attention`` with ``_bwd``'s plain backward: K9 forward
    (``kernels=True``; its plain version for CPU tensors) or the plain
    version. dbias and dmask come back fp32, in the bias's and the mask's
    dtypes. ``terms``: K9's (bias terms, mask terms), as
    :func:`fused_window_attention` takes them.

    ``HeadsWindowAttentionFn.apply(q, k, v, bias, mask, scale, kernels[,
    terms])``"""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, kernels, terms=None):
        if kernels:
            out = fused_window_attention(q, k, v, bias, mask, scale, terms)
        else:
            out = window_attention_heads_plain(q, k, v, bias, mask, scale)
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias, dmask = window_attention_heads_bwd_plain(q, k, v, bias, mask, g,
                                                                    ctx.scale)
        dmask = None if mask is None else dmask.to(mask.dtype)
        return dq, dk, dv, dbias.to(bias.dtype), dmask, None, None, None


# ------------------------------------------------------ K10: spatial grid (#9)

def _grid_windows(x, window):
    """(B, Dp, Hp, Wp, *rest) -> (B * gd * gh * gw, N, *rest), windows in
    (b, i, j, k) order, tokens in (d, h, w) order (``window_partition``)."""
    B, Dp, Hp, Wp = x.shape[:4]
    wd, wh, ww = window
    rest = tuple(x.shape[4:])
    x = x.reshape(B, Dp // wd, wd, Hp // wh, wh, Wp // ww, ww, *rest)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, *range(7, 7 + len(rest)))
    return x.reshape(-1, wd * wh * ww, *rest)


def _grid_reverse(x, window, B, Dp, Hp, Wp):
    """Inverse of :func:`_grid_windows`."""
    wd, wh, ww = window
    rest = tuple(x.shape[2:])
    x = x.reshape(B, Dp // wd, Hp // wh, Wp // ww, wd, wh, ww, *rest)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, *range(7, 7 + len(rest)))
    return x.reshape(B, Dp, Hp, Wp, *rest)


def spatial_heads(qkv5, window):
    """(B, Dp, Hp, Wp, 3, nH, hd) -> head-major q, k, v (Bn, nH, N, hd)."""
    x = _grid_windows(qkv5, window)                     # (Bn, N, 3, nH, hd)
    return (x[:, :, i].transpose(1, 2) for i in range(3))


def spatial_window_attention_plain(qkv5, bias, mask_grid, window, scale: float):
    """Plain version of K10 (``_xla_spatial_reference``): partition the grid,
    :func:`window_attention_heads_plain`, reverse. -> (B, Dp, Hp, Wp, nH,
    hd)."""
    B, Dp, Hp, Wp = qkv5.shape[:4]
    N = int(window[0] * window[1] * window[2])
    mask = None if mask_grid is None else mask_grid.reshape(-1, N, N)
    out = window_attention_heads_plain(*spatial_heads(qkv5, window), bias, mask, scale)
    return _grid_reverse(out.transpose(1, 2), window, B, Dp, Hp, Wp)


def spatial_window_attention(qkv5, bias, mask_grid, window, scale: float, terms=None):
    """Window attention straight on the padded spatial grid: qkv5 (B, Dp,
    Hp, Wp, 3, nH, hd) bf16, padded and (for a shifted block) rolled; bias
    (nH, N, N) fp32; mask_grid (gd, gh, gw, N, N) fp32 additive or None ->
    (B, Dp, Hp, Wp, nH, hd). Dp, Hp, Wp are multiples of the window.
    ``terms``: as :func:`fused_window_attention`'s, the mask's of its
    (gd * gh * gw, N, N) rows: tile w is the window at grid position (i, j,
    k), w = (i * gh + j) * gw + k."""
    if not qkv5.is_cuda:
        return spatial_window_attention_plain(qkv5, bias, mask_grid, window, scale)
    B, Dp, Hp, Wp, three, nH, hd = qkv5.shape
    wd, wh, ww = (int(w) for w in window)
    N = wd * wh * ww
    dev = qkv5.device
    if three != 3 or hd != 32 or N > 16 * KEY_TILES[-1] or Dp % wd or Hp % wh or Wp % ww:
        raise ValueError(f"spatial window attention takes head dim 32, N <= "
                         f"{16 * KEY_TILES[-1]} and a grid of whole windows; got qkv "
                         f"{tuple(qkv5.shape)}, window {tuple(window)}")
    _build.require(qkv5, "qkv5", torch.bfloat16, dev)
    _build.require(bias, "bias", torch.float32, dev, (nH, N, N))
    grid = (Dp // wd) * (Hp // wh) * (Wp // ww)
    if mask_grid is not None:
        _build.require(mask_grid, "mask_grid", torch.float32, dev,
                       (Dp // wd, Hp // wh, Wp // ww, N, N))
    bt, mt = _kernel_terms(terms, bias, None if mask_grid is None else mask_grid.view(-1, N, N),
                           N)
    out = torch.empty((B, Dp, Hp, Wp, nH, hd), dtype=qkv5.dtype, device=dev)
    _build.launch("clover_window_attention_spatial", qkv5, bt, mt, out, B, Dp, Hp, Wp, wd, wh,
                  ww, nH, key_tiles(N), windows_per_block(B * grid, nH, _build.sms(dev)),
                  float(scale), _build.stream(dev))
    spatial_window_attention.launches += 1
    return out


class SpatialWindowAttentionFn(torch.autograd.Function):
    """``spatial_window_attention`` with ``_spatial_bwd``'s math (the
    backward of the partitioned reference): K10 forward (``kernels=True``;
    its plain version for CPU tensors) or the plain version; dqkv5 in the
    grid layout, dbias fp32, the mask grid's gradient. ``terms``: K10's
    (bias terms, mask terms), as :func:`spatial_window_attention` takes them.

    ``SpatialWindowAttentionFn.apply(qkv5, bias, mask_grid, window, scale,
    kernels[, terms])``"""

    @staticmethod
    def forward(ctx, qkv5, bias, mask_grid, window, scale, kernels, terms=None):
        if kernels:
            out = spatial_window_attention(qkv5, bias, mask_grid, window, scale, terms)
        else:
            out = spatial_window_attention_plain(qkv5, bias, mask_grid, window, scale)
        ctx.save_for_backward(qkv5, bias, mask_grid)
        ctx.args = (tuple(window), scale)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv5, bias, mask_grid = ctx.saved_tensors
        window, scale = ctx.args
        B, Dp, Hp, Wp = qkv5.shape[:4]
        N = int(window[0] * window[1] * window[2])
        mask = None if mask_grid is None else mask_grid.reshape(-1, N, N)
        q, k, v = spatial_heads(qkv5, window)
        gh = _grid_windows(g, window).transpose(1, 2)          # (Bn, nH, N, hd)
        dq, dk, dv, dbias, dmask = window_attention_heads_bwd_plain(q, k, v, bias, mask, gh,
                                                                    scale)
        dqkv = torch.stack([dq, dk, dv], dim=2).transpose(1, 3)   # (Bn, N, 3, nH, hd)
        dqkv5 = _grid_reverse(dqkv, window, B, Dp, Hp, Wp)
        dmask = None if mask_grid is None else dmask.view(mask_grid.shape).to(mask_grid.dtype)
        return dqkv5, dbias.to(bias.dtype), dmask, None, None, None, None


# ------------------------------------------------ K11: key-tiled flash (#10, #11)

FLASH_KEYS = 64   # K11's key tile: the plain versions take the same online-softmax steps
# K11's block, mirrored from csrc/window_attention_flash.cu: 5 warps, one
# 16-row query strip each (N=392's 25 strips in 5 blocks); K / V tiles of
# FLASH_KEYS rows and their region ids in a double buffer
_FLASH_WARPS = 5


class FlashGrid(NamedTuple):
    """K11's launch shape (:func:`flash_grid`)."""
    rows: int              # query rows a block: a 16-row strip a warp
    query_tiles: int       # blocks of one (window, head)
    grid: tuple            # (windows x query tiles, heads)
    key_steps: tuple       # 16-key steps of each key tile; the last one's may be fewer
    smem: int              # static shared memory of a block, bytes (any N: within 48 KB)


def flash_grid(Bn: int, num_heads: int, N: int) -> FlashGrid:
    """K11's grid for Bn windows of N tokens and ``num_heads`` heads. A block
    takes 80 query rows (strips past N only stage) and walks the keys in
    tiles of FLASH_KEYS up to 16 * ceil(N / 16): whole tiles, then the last
    one's remaining 16-key steps."""
    rows, strips, per = 16 * _FLASH_WARPS, -(-N // 16), FLASH_KEYS // 16
    q_tiles = -(-N // rows)
    steps = tuple(min(per, strips - j) for j in range(0, strips, per))
    smem = (rows + 2 * 2 * FLASH_KEYS) * _LD * 2 + 2 * FLASH_KEYS * 4
    return FlashGrid(rows, q_tiles, (Bn * q_tiles, num_heads), steps, smem)


def _flash_plain(q, k, v, bias, region_ids, scale: float, tile: int = FLASH_KEYS):
    """The key-tiled online softmax of ``_forward_long``: q, k, v (Bn, nH,
    N, hd), tiles of ``tile`` keys, fp32 running max / sum / accumulator,
    the bias and the -100 region mask in the compute dtype, probabilities
    rounded to it before P.V. -> (Bn, nH, N, hd)."""
    Bn, nH, N, hd = q.shape
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    bias_a = bias.to(dt).to(acc)
    mask = None
    if region_ids is not None:
        nW = region_ids.shape[0]
        mask = region_mask(region_ids, dt).to(acc)[None, :, None]   # (1, nW, 1, N, N)
    qa = q.to(acc)
    m = torch.full((Bn, nH, N, 1), float("-inf"), dtype=acc, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((Bn, nH, N, hd), dtype=acc, device=q.device)
    for k0 in range(0, N, tile):
        ks = slice(k0, min(N, k0 + tile))
        s = torch.matmul(qa, k[:, :, ks].to(acc).transpose(-1, -2)) * scale + bias_a[None, :, :, ks]
        if mask is not None:
            s = (s.view(Bn // nW, nW, nH, N, -1) + mask[..., ks]).view(Bn, nH, N, -1)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.matmul(p.to(dt).to(acc), v[:, :, ks].to(acc))
        m = m_new
    return (o / l).to(dt)


def window_attention_long_plain(q, k, v, bias, region_ids, scale: float):
    """Plain version of K11's head-major layout (``_forward_long``): q, k, v
    (Bn, nH, N, hd) -> (Bn, nH, N, hd), over chunks of windows."""
    Bn, nH, N, _ = q.shape
    nW = 1 if region_ids is None else region_ids.shape[0]
    return _over_window_chunks(lambda a, b, c: _flash_plain(a, b, c, bias, region_ids, scale),
                               Bn, nW, nH, N, q, k, v)


def heads_from_flat(qkv2, num_heads: int, N: int):
    """(Bn*N, 3C) -> contiguous head-major q, k, v (Bn, nH, N, hd)."""
    M, threeC = qkv2.shape
    x = qkv2.view(M // N, N, 3, num_heads, threeC // (3 * num_heads)).permute(2, 0, 3, 1, 4)
    return (t.contiguous() for t in x.unbind(0))


def flat_from_heads(out):
    """(Bn, nH, N, hd) -> (Bn*N, C)."""
    Bn, nH, N, hd = out.shape
    return out.transpose(1, 2).reshape(Bn * N, nH * hd)


def window_attention_flat_flash_plain(qkv2, bias, region_ids, scale: float, num_heads: int,
                                      N: int):
    """Plain version of K11 on the flat qkv, both of ``_forward_flat_flash``
    and of ``_forward_long_from_flat`` (one function in two layouts): qkv2
    (Bn*N, 3C) -> (Bn*N, C), the same steps as :func:`_flash_plain`."""
    out = window_attention_long_plain(*heads_from_flat(qkv2, num_heads, N), bias, region_ids,
                                      scale)
    return flat_from_heads(out)


def _flash_kernel_args(bias, region_ids, Bn: int, nH: int, N: int, dev):
    """Check the launch and the bias and region ids K11 takes; -> (the bf16
    bias in accumulator order at ceil(N / 16) key steps, nW)."""
    grid = flash_grid(Bn, nH, N)
    if grid.grid[0] > 2 ** 31 - 1 or grid.grid[1] > 65535:
        raise ValueError(f"flash window attention: grid {grid.grid} past the card's limits "
                         f"(Bn={Bn}, nH={nH}, N={N})")
    _check_bias(bias, nH, N, dev)
    return fragment_bias(bias, N, sum(grid.key_steps)), _region_nW(region_ids, Bn, N, dev)


def flash_window_attention(q, k, v, bias, region_ids, scale: float):
    """K11, head-major (``_forward_long``): q, k, v (Bn, nH, N, 32) bf16 ->
    (Bn, nH, N, 32); bias (nH, N, N), used in bf16; region ids (nW, N) int32
    or None. Any N."""
    if not q.is_cuda:
        return window_attention_long_plain(q, k, v, bias, region_ids, scale)
    Bn, nH, N, hd = q.shape
    if hd != 32:
        raise ValueError(f"flash window attention takes head dim 32, got {hd}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, name, torch.bfloat16, q.device, (Bn, nH, N, hd))
    bias_f, nW = _flash_kernel_args(bias, region_ids, Bn, nH, N, q.device)
    out = torch.empty_like(q)
    _build.launch("clover_flash_heads", q, k, v, bias_f, region_ids, out, Bn, N, nH, nW,
                  float(scale), _build.stream(q.device))
    flash_window_attention.launches += 1
    return out


def flat_flash_window_attention(qkv2, bias, region_ids, scale: float, num_heads: int, N: int):
    """K11, flat (``_forward_flat_flash``): qkv2 (Bn*N, 3C) bf16 -> (Bn*N,
    C); bias (nH, N, N), used in bf16; region ids (nW, N) int32 or None.
    Any N."""
    if not qkv2.is_cuda:
        return window_attention_flat_flash_plain(qkv2, bias, region_ids, scale, num_heads, N)
    M, threeC = qkv2.shape
    C = threeC // 3
    if C != num_heads * 32 or M % N:
        raise ValueError(f"flash window attention takes head dim 32 and whole windows; got "
                         f"C={C}, heads={num_heads}, N={N}, rows={M}")
    _build.require(qkv2, "qkv2", torch.bfloat16, qkv2.device)
    bias_f, nW = _flash_kernel_args(bias, region_ids, M // N, num_heads, N, qkv2.device)
    out = torch.empty((M, C), dtype=qkv2.dtype, device=qkv2.device)
    _build.launch("clover_flash_flat", qkv2, bias_f, region_ids, out, M // N, N, num_heads, nW,
                  float(scale), _build.stream(qkv2.device))
    flat_flash_window_attention.launches += 1
    return out


def long_window_attention_from_flat(qkv2, bias, region_ids, scale: float, num_heads: int,
                                    N: int):
    """``_forward_long_from_flat``: the flat qkv relayouted to heads (PyTorch
    copies), :func:`flash_window_attention`, and back. -> (Bn*N, C)."""
    out = flash_window_attention(*heads_from_flat(qkv2, num_heads, N), bias, region_ids, scale)
    return flat_from_heads(out)


flat2_window_attention.launches = 0
flat2_window_attention_bwd.launches = 0
fused_window_attention.launches = 0
spatial_window_attention.launches = 0
flash_window_attention.launches = 0
flat_flash_window_attention.launches = 0
