"""Video Swin Transformer (port of ``clover_tpu/models/swin3d.py``).

What is ported is the path the retrieval eval, the retrieval finetune and
the pretrain step run: host space-to-depth input with the ImageNet
normalization folded into the patch embed (or the raw clip, put through
space-to-depth on the device: ``embed_impl`` 's2d' / 'conv'), the SimMIM
mask token and the embed / encode split of the pretrain step,
window-resident stages (activations stay partitioned into
windows for a whole stage; a shifted block permutes tokens in and out) and
the spatial block path (LN1, pad, roll, partition, attention, reverse, roll
back, crop: stages whose dims do not divide the window, or
``window_resident=False``), the attention routes of ``attention_impl``
(the flat window attention, kernel K1 with its backward K5, or K11 for long
windows under ``long_attn``; K9 on the head layout; K10 on the padded
spatial grid; 'fused_block', the half-block K6 in every block of a
stage that divides the window; the plain 'xla_headloop' / 'xla' math), a
strided-convolution patch embed (``stride``), the dropouts ``drop_rate`` /
``attn_drop_rate`` (plain routes in training), the fused LN2+MLP+residual
half (kernel K2; in training its stash form), the
forward-only LayerNorm sites (kernel K4, eval only) and, at large windows
(``SwinConfig.fused_attn``), the fused LN1+attention+proj+residual half
(kernel K6) in place of LN1, qkv, K1 and proj; in training through
``FusedAttnBlockFn``, whose backward recomputes the half through K1 and K5.
In training (``train()`` mode) DropPath is drawn per sample from the
generator passed to ``forward``, and the relative-position bias comes from
the table at every block so that it gets a gradient. Layout is
channels-last (B, T, H, W, C) as in the JAX package; parameter names follow
its tree (``stage_{i}_block_{j}``, ``patch_embed``, ``stage_{i}_downsample``,
``norm``).
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clover_tpu_torch.models.layers import (
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    dropout,
    remat,
    trunc_normal_,
)
from clover_tpu_torch.ops.attn_block import (
    FusedAttnBlockFn,
    fused_window_attn_block,
    window_attn_block_plain,
)
from clover_tpu_torch.ops.mlp_block import (
    FusedLnMlpResidualFn,
    fused_ln_mlp_residual,
    ln_mlp_residual_plain,
)
from clover_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from clover_tpu_torch.ops.window_attention import (
    HeadsWindowAttentionFn,
    SpatialWindowAttentionFn,
    WindowAttentionFn,
    bias_terms,
    flat_from_heads,
    fragment_bias,
    fragment_index,
    heads_from_flat,
    key_tiles,
    mask_terms,
)

Tuple3 = Tuple[int, int, int]
ATTENTION_IMPLS = ("auto", "pallas_flat", "pallas", "pallas_fused", "fused_block",
                   "xla_headloop", "xla")
LONG_ATTN_N = 384   # long_attn's windows: the 32-frame 8x7x7 (N=392), as fused_attn 'auto'


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """The fields of ``clover_tpu.models.swin3d.SwinConfig`` the port reads.
    ``embed_impl``: 'host_s2d' (the port's
    default) takes clips space-to-depth'd on the host; 's2d' and 'conv' (the
    JAX default) take the raw (B, T, H, W, 3) clip and compute the same
    patch-embed GEMM after a space-to-depth on the device (the JAX 'conv'
    is a convolution with the same weights; its CPU tests hold the two
    together). A ``stride`` other than ``patch_size`` makes the raw-clip
    embed a strided convolution (``F.conv3d``) with its own (pd, ph, pw,
    C, E) kernel, the JAX ``nn.Conv``; host_s2d and ``fold_normalize``
    refuse it.

    ``drop_rate`` (after the embed, on each block's attention proj and in
    its MLP) and ``attn_drop_rate`` (on the attention probabilities) are
    dropouts drawn from the forward's generator. Every config leaves them
    at 0. Above 0, a block in training runs its plain route, as the JAX
    package runs XLA there: ``attn_drop_rate`` the 'xla' attention, with
    ``drop_rate`` K1 (never K6) and the plain MLP half. In eval they are no
    ops and the block keeps its kernels."""

    patch_size: Tuple3 = (2, 4, 4)
    stride: Tuple3 = (2, 4, 4)
    in_chans: int = 3
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: Tuple3 = (8, 7, 7)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    patch_norm: bool = True
    fold_normalize: bool = False
    gelu: str = "tanh"          # 'tanh' | 'erf', as SwinConfig.gelu
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    # the fused attention half-block (K6) in eval: 'auto' for windows of
    # N >= 384 tokens (the 32-frame 8x7x7 window), 'on' or 'off' at every
    # N; the JAX package's CLOVER_FUSED_ATTN ('auto' / '1' / '0')
    fused_attn: str = "auto"
    mask_token: bool = False    # the SimMIM mask token of the pretrain model
    embed_impl: str = "host_s2d"
    # gradient checkpointing: True remats every block, a tuple of stage ids
    # the blocks of those stages (the TPU's 32-frame recipe: (0, 1))
    use_checkpoint: Any = False
    # the MLP half in training: stash z and the LN statistics for the
    # backward (the JAX CLOVER_MLP_STASH, default on), or save x only and
    # recompute LN + fc1 + GELU in the backward by mlp_bwd: 'xla' plain
    # PyTorch, 'onepass' the kernel K7 (the JAX CLOVER_MLP_BWD1), 'pair'
    # K8 (the JAX CLOVER_MLP_BWD=1, K7's passes; erf GELU only)
    mlp_stash: bool = True
    mlp_bwd: str = "xla"
    # the window attention: 'auto' is the port's route, the TPU's
    # 'pallas_flat' (K1 on the flat qkv; K6 where fused_attn picks it);
    # 'pallas' K9 on the (Bn, nH, N, hd) head layout (K6 where fused_attn
    # picks it); 'pallas_fused' K10 on the padded qkv grid, every stage on
    # the spatial path; 'xla_headloop' / 'xla' plain PyTorch (XLA in the JAX
    # package): a loop over the heads of the flat qkv, one product on the
    # head layout; 'fused_block' K6 in every block of a stage whose dims
    # divide the window, on the window-resident layout whatever
    # window_resident says (the JAX package rolls and partitions each block
    # on its spatial path; the function is the same), K1 on the partitioned
    # windows where a stage pads or drop_rate is on in training (the JAX
    # package runs XLA there; attn_drop_rate: 'xla')
    attention_impl: str = "auto"
    # a stage whose dims divide the window keeps its activations partitioned
    # into windows (not under 'pallas_fused'); False: every stage spatial
    # (under 'fused_block' a stage that divides the window stays resident)
    window_resident: bool = True
    # windows of N >= 384 on the flat route: 'off' K1, 'v7' K11 on the flat
    # qkv, 'v6' K11 head-major after a relayout (the JAX CLOVER_WA_LONG)
    long_attn: str = "off"

    def __post_init__(self):
        if self.fused_attn not in ("auto", "on", "off"):
            raise ValueError(f"fused_attn must be 'auto', 'on' or 'off', got {self.fused_attn!r}")
        if self.embed_impl not in ("host_s2d", "s2d", "conv"):
            raise ValueError(f"embed_impl must be 'host_s2d', 's2d' or 'conv', "
                             f"got {self.embed_impl!r}")
        if self.mlp_bwd not in ("xla", "onepass", "pair"):
            raise ValueError(f"mlp_bwd must be 'xla', 'onepass' or 'pair', got {self.mlp_bwd!r}")
        if self.mlp_bwd == "pair" and self.gelu != "erf":
            # the JAX package falls back to XLA here without a word
            raise ValueError("mlp_bwd='pair' takes the erf GELU only (gelu='erf')")
        if not isinstance(self.use_checkpoint, (bool, tuple, list)):
            raise ValueError(f"use_checkpoint must be a bool or a tuple of stage ids, "
                             f"got {self.use_checkpoint!r}")
        if tuple(self.patch_size) != tuple(self.stride):
            if self.fold_normalize:
                raise ValueError("fold_normalize requires kernel == stride")
            if self.embed_impl == "host_s2d":
                raise ValueError("embed_impl='host_s2d' requires kernel == stride")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                             f"got {self.attention_impl!r}")
        if self.long_attn not in ("off", "v6", "v7"):
            raise ValueError(f"long_attn must be 'off', 'v6' or 'v7', got {self.long_attn!r}")
        if self.long_attn != "off" and self.attention_impl not in ("auto", "pallas_flat"):
            raise ValueError("long_attn is a route of the flat attention: attention_impl "
                             "'auto' or 'pallas_flat'")
        if self.long_attn != "off" and self.fused_attn != "off":
            # K6 would take every long window (the JAX run needs CLOVER_FUSED_ATTN=0)
            raise ValueError("long_attn needs fused_attn='off'")

    def remat_stage(self, i_stage: int) -> bool:
        """Does stage ``i_stage`` recompute its blocks in the backward?"""
        if isinstance(self.use_checkpoint, (tuple, list)):
            return i_stage in self.use_checkpoint
        return bool(self.use_checkpoint)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @classmethod
    def base(cls, **kw) -> "SwinConfig":
        return cls(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), **kw)


# ------------------------------------------------------------ static helpers
# (numpy, computed once per shape like the JAX package's trace-time constants)

def effective_window(x_size: Tuple3, window: Tuple3, shift: Optional[Tuple3] = None):
    """Clamp window dims to the input size; clamped dims get zero shift."""
    win = list(window)
    sh = list(shift) if shift is not None else None
    for i in range(3):
        if x_size[i] <= window[i]:
            win[i] = x_size[i]
            if sh is not None:
                sh[i] = 0
    if sh is None:
        return tuple(win)
    return tuple(win), tuple(sh)


@functools.lru_cache(maxsize=None)
def relative_position_index(full_window: Tuple3, eff_window: Tuple3) -> np.ndarray:
    """(N, N) index into the (2Wd-1)(2Wh-1)(2Ww-1)-row bias table, built for
    the effective window with the full window's offsets and strides."""
    coords = np.stack(
        np.meshgrid(*[np.arange(w) for w in eff_window], indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    for i in range(3):
        rel[:, :, i] += full_window[i] - 1
    rel[:, :, 0] *= (2 * full_window[1] - 1) * (2 * full_window[2] - 1)
    rel[:, :, 1] *= 2 * full_window[2] - 1
    return rel.sum(-1).astype(np.int32)


def bias_from_table(table: torch.Tensor, full_window: Tuple3, eff_window: Tuple3,
                    num_heads: int) -> torch.Tensor:
    """(table_len, nH) table -> (nH, N, N) fp32 attention bias, contiguous
    (K9 and K10 read it in place)."""
    N = int(np.prod(eff_window))
    idx = torch.from_numpy(
        relative_position_index(tuple(full_window), tuple(eff_window)).reshape(-1).astype(np.int64))
    bias = table.float()[idx.to(table.device)].reshape(N, N, num_heads)
    return bias.permute(2, 0, 1).contiguous()


@functools.lru_cache(maxsize=None)
def _k1_term_index(full_window: Tuple3, eff_window: Tuple3, device):
    """The gather that lays K1's terms out straight from the relative-position
    table: (int32 columns (kt 2 kt 8 4 2 2) of the table's (nH, table_len)
    form extended by a column of zeros and one of -inf (``fragment_index``),
    kt). A device constant per (window, device), made outside inference
    mode so a train step can save what it gathers for its backward."""
    with torch.inference_mode(False):
        N = int(np.prod(eff_window))
        L = int(np.prod([2 * w - 1 for w in full_window]))
        rel = torch.from_numpy(relative_position_index(full_window, eff_window).astype(np.int64))
        kt = key_tiles(N)
        return fragment_index(rel[None], L, kt).flatten().to(device, torch.int32), kt


def table_ext(table: torch.Tensor) -> torch.Tensor:
    """The buffer K1's table gather reads: (nH, table_len + 2) bf16, the
    table's columns (cast in by :func:`k1_terms_from_table`), then a column
    of zeros and one of -inf. Made outside inference mode, so a module can
    keep it for eval and training."""
    with torch.inference_mode(False):
        ext = torch.zeros(table.shape[1], table.shape[0] + 2, dtype=torch.bfloat16,
                          device=table.device)
        ext[:, -1] = float("-inf")
    return ext


def k1_terms_from_table(table: torch.Tensor, full_window: Tuple3, eff_window: Tuple3,
                        ext: torch.Tensor) -> torch.Tensor:
    """K1's bias terms from the (table_len, nH) table in two launches: the
    table cast into ``ext`` (:func:`table_ext`) and one column gather, (nH,
    kt, 2 kt, 8, 4, 2, 2) bf16, bitwise ``fragment_bias(bias_from_table(...))``.
    Detached: the bias from ``bias_from_table`` stays the gradient's path to
    the table."""
    ext[:, :table.shape[0]].copy_(table.detach().t())
    idx, kt = _k1_term_index(tuple(full_window), tuple(eff_window), table.device)
    return ext.index_select(1, idx).view(table.shape[1], kt, 2 * kt, 8, 4, 2, 2)


def swin_bias_cache(backbone: "SwinTransformer3D", cfg: SwinConfig,
                    token_dims: Tuple3) -> Dict[str, torch.Tensor]:
    """Every block's (nH, N, N) fp32 relative-position bias for the post-embed
    token dims (D', H', W'). Eval-only: computed once per checkpoint and
    passed to the forward as ``bias_cache``."""
    dims = tuple(token_dims)
    cache = {}
    with torch.no_grad():
        for i_stage in range(len(cfg.depths)):
            window = effective_window(dims, cfg.window_size)
            for i_blk in range(cfg.depths[i_stage]):
                name = f"stage_{i_stage}_block_{i_blk}"
                attn = getattr(backbone, name).attn
                cache[name] = bias_from_table(attn.relative_position_bias_table,
                                              cfg.window_size, window,
                                              cfg.num_heads[i_stage])
            if i_stage < len(cfg.depths) - 1:
                dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
    return cache


def bias_cache_builder(cfg: SwinConfig):
    """Callable form for the eval loops (the JAX ``bias_cache_builder``):
    ``build(model, token_dims)`` -> ``swin_bias_cache(model.backbone, cfg,
    token_dims)``. A loop calls it at its first batch, so each eval builds
    the cache, and the kernels' layouts kept with it, from the parameters
    the model holds at that time."""
    return lambda model, token_dims: swin_bias_cache(model.backbone, cfg, token_dims)


def embed_dims(cfg: SwinConfig, in_shape: Tuple3) -> Tuple3:
    """(T, H, W) raw clip -> (D', H', W') token dims after the patch embed:
    the clip padded to whole patches, then patches every ``stride``."""
    return tuple((-(-s // p) * p - p) // st + 1
                 for s, p, st in zip(in_shape, cfg.patch_size, cfg.stride))


@functools.lru_cache(maxsize=None)
def _shift_region_ids(padded_size: Tuple3, window: Tuple3,
                      shift: Tuple3) -> Optional[np.ndarray]:
    """(nW, N) per-window region ids for the shifted-window mask (reference
    compute_mask, swin_transformer_3d.py:548-562)."""
    if not any(s > 0 for s in shift):
        return None
    D, H, W = padded_size
    img_mask = np.zeros((D, H, W), dtype=np.int32)
    cnt = 0
    for d in (slice(-window[0]), slice(-window[0], -shift[0] or None),
              slice(-shift[0] or None, None)):
        for h in (slice(-window[1]), slice(-window[1], -shift[1] or None),
                  slice(-shift[1] or None, None)):
            for w in (slice(-window[2]), slice(-window[2], -shift[2] or None),
                      slice(-shift[2] or None, None)):
                img_mask[d, h, w] = cnt
                cnt += 1
    return img_mask.reshape(
        D // window[0], window[0], H // window[1], window[1], W // window[2], window[2]
    ).transpose(0, 2, 4, 1, 3, 5).reshape(-1, window[0] * window[1] * window[2])


@functools.lru_cache(maxsize=None)
def shift_attn_mask(padded_size: Tuple3, window: Tuple3,
                    shift: Tuple3) -> Optional[np.ndarray]:
    """(nW, N, N) additive mask (0 / -100) for shifted-window attention."""
    wins = _shift_region_ids(padded_size, window, shift)
    if wins is None:
        return None
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def fused_attn_enabled(mode: str, N: int) -> bool:
    """Does a block run its first half as the fused half-block (K6) at
    windows of N tokens, under ``SwinConfig.fused_attn`` ``mode``? (JAX
    ``_fused_attn_enabled``: its measured TPU A/B picked N >= 384.)"""
    return mode == "on" or (mode == "auto" and N >= 384)


def window_partition(x: torch.Tensor, window: Tuple3) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nW, N, C)."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // window[0], window[0], H // window[1], window[1],
                  W // window[2], window[2], C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, window[0] * window[1] * window[2], C)


def window_reverse(windows: torch.Tensor, window: Tuple3, B: int, D: int, H: int,
                   W: int) -> torch.Tensor:
    """(B * nW, N, C) -> (B, D, H, W, C)."""
    C = windows.shape[-1]
    x = windows.reshape(B, D // window[0], H // window[1], W // window[2],
                        window[0], window[1], window[2], C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, C)


@functools.lru_cache(maxsize=64)
def _window_shift_perm_np(dims: Tuple3, window: Tuple3, shift: Tuple3):
    """Token permutation unshifted-window-major -> shifted-window-major:
    (perm, inv_perm) with x_shifted[:, i] = x[:, perm[i]]."""
    D, H, W = dims
    wd, wh, ww = window

    def part(t):
        t = t.reshape(D // wd, wd, H // wh, wh, W // ww, ww)
        return t.transpose(0, 2, 4, 1, 3, 5).reshape(-1)

    tokens = np.arange(D * H * W).reshape(D, H, W)
    base = part(tokens)
    rolled = part(np.roll(tokens, (-shift[0], -shift[1], -shift[2]), axis=(0, 1, 2)))
    inv_base = np.empty_like(base)
    inv_base[base] = np.arange(base.size)
    perm = inv_base[rolled]
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.size)
    return perm.astype(np.int32), inv_perm.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_constant(kind: str, dims: Tuple3, window: Tuple3, shift: Tuple3,
                     device: torch.device) -> Optional[torch.Tensor]:
    """The shift permutations, region ids, additive masks and the masks in
    K9 / K10's accumulator order ('mask_terms') (dims: the padded dims on the
    spatial path) as device tensors, made once per (shape, device) instead
    of copied from the host at every block. Made outside inference mode even
    when first asked for under it (the eval step), so that a later train
    step can save them for its backward."""
    with torch.inference_mode(False):
        if kind == "mask_terms":
            mask = _device_constant("mask", dims, window, shift, device)
            return None if mask is None else mask_terms(mask, mask.shape[-1])
        if kind in ("region_ids", "mask"):
            fn = _shift_region_ids if kind == "region_ids" else shift_attn_mask
            found = fn(dims, window, shift)
            return None if found is None else torch.from_numpy(found).to(device)
        perm, inv = _window_shift_perm_np(dims, window, shift)
        chosen = inv if kind == "inv_perm" else perm
        return torch.from_numpy(chosen.astype(np.int64)).to(device)


def _apply_window_perm(x: torch.Tensor, dims: Tuple3, window: Tuple3, shift: Tuple3,
                       inverse: bool) -> torch.Tensor:
    """Regroup (B, L, C) window-major tokens for (or back from) a shifted
    block: one gather with the precomputed permutation."""
    idx = _device_constant("inv_perm" if inverse else "perm", tuple(dims), tuple(window),
                           tuple(shift), x.device)
    return x.index_select(1, idx)


# ------------------------------------------------------------------ modules

class WindowAttention3D(nn.Module):
    """W-MSA / SW-MSA over flattened 3-D windows with relative position bias.
    The rank of x picks the route, as in the JAX module: (Bn*N, C) the flat
    route ('pallas_flat': ``WindowAttentionFn``, K1 or K11, the mask as
    region ids); (Bn, N, C) the head-layout routes ('pallas' K9, or the
    plain 'xla_headloop' / 'xla', the additive (nW, N, N) mask); (B, Dp,
    Hp, Wp, C) the spatial grid ('pallas_fused' K10, the mask as a (gd, gh,
    gw, N, N) grid). K9 and K10 take their terms in accumulator order: the
    mask's from the caller (``mask_terms``, a device constant), the bias's
    laid out here, and kept in eval while the same bias tensor comes back
    (the eval bias cache hands each block the same one every forward;
    :meth:`_kept`). K1 and K5 take theirs the same way: a given (cached)
    bias's laid out once and kept in eval, else gathered from the table once
    a call (:func:`k1_terms_from_table`), shared by K1 and K5 (which gathers
    its transposed form from them). ``attn_drop``: the probabilities'
    dropout rate in training, on the 'xla' route only (the block picks it
    when the rate is above 0)."""

    def __init__(self, dim: int, full_window: Tuple3, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, kernels: bool = True, attn_drop: float = 0.0):
        super().__init__()
        self.dim, self.full_window, self.num_heads = dim, tuple(full_window), num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.kernels = kernels
        self.attn_drop = attn_drop
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        table_len = int(np.prod([2 * w - 1 for w in self.full_window]))
        self.relative_position_bias_table = nn.Parameter(torch.zeros(table_len, num_heads))
        self._bias_terms = None   # (weakref to the bias, its terms) of the last eval call
        self._k1_bias = None      # the same for K1's terms
        self._table_ext = None    # K1's table gather's buffer (table_ext)

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.relative_position_bias_table, generator)

    def _terms(self, bias: torch.Tensor, mask_terms: Optional[torch.Tensor], N: int):
        """(bias terms, mask terms) for K9 / K10 on the card, else None."""
        if not (self.kernels and bias.is_cuda):
            return None
        return self._kept("_bias_terms", bias, lambda b: bias_terms(b, N)), mask_terms

    def _kept(self, slot: str, bias: torch.Tensor, lay_out):
        """``lay_out(bias)``, kept in ``slot`` in eval while the same bias
        tensor comes back and lives: the module holds the bias weakly and
        drops the result with it, and keeps nothing from a training call."""
        memo = None if self.training else getattr(self, slot)
        if memo is None or memo[0]() is not bias:
            with torch.no_grad():
                memo = (weakref.ref(bias, lambda ref: self._forget(slot, ref)), lay_out(bias))
        setattr(self, slot, None if self.training else memo)
        return memo[1]

    def _forget(self, slot: str, ref) -> None:
        """Drop what ``slot`` keeps with the bias it was laid out from."""
        memo = getattr(self, slot)
        if memo is not None and memo[0] is ref:
            setattr(self, slot, None)

    def k1_terms(self, bias: torch.Tensor, given: bool, eff_window: Tuple3):
        """K1's terms for ``WindowAttentionFn`` (K5 gathers its transposed
        form from them), or None with ``kernels=False``. A ``given`` bias
        (the eval cache) is laid out once and its terms kept in eval
        (:meth:`_kept`); else they are gathered from the table through the
        module's kept buffer."""
        if not self.kernels:
            return None
        if not given:
            table = self.relative_position_bias_table
            if self._table_ext is None or self._table_ext.device != table.device:
                self._table_ext = table_ext(table)
            return k1_terms_from_table(table, self.full_window, eff_window, self._table_ext)
        N = bias.shape[-1]
        return self._kept("_k1_bias", bias, lambda b: fragment_bias(b, N, key_tiles(N)))

    def forward(self, x: torch.Tensor, eff_window: Tuple3, mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None, impl: str = "pallas_flat",
                long_attn: str = "off", mask_terms: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        N = int(np.prod(eff_window))
        given = bias is not None
        if bias is None:
            bias = bias_from_table(self.relative_position_bias_table, self.full_window,
                                   tuple(eff_window), self.num_heads)
        qkv = self.qkv(x)
        if x.ndim == 2:
            long_attn = long_attn if N >= LONG_ATTN_N else "off"
            # K1 reads the terms in the forward, K5 in the backward (K11 lays its own out)
            terms = (self.k1_terms(bias, given, eff_window)
                     if long_attn == "off" or self.training else None)
            return self.proj(WindowAttentionFn.apply(qkv, bias, mask, self.scale, self.num_heads,
                                                     N, self.kernels, long_attn, terms))
        nH, hd = self.num_heads, self.dim // self.num_heads
        if x.ndim == 5:
            out = SpatialWindowAttentionFn.apply(qkv.view(*x.shape[:4], 3, nH, hd), bias, mask,
                                                 tuple(eff_window), self.scale, self.kernels,
                                                 self._terms(bias, mask_terms, N))
            return self.proj(out.reshape(x.shape))
        if impl == "pallas":
            # the head relayout and back are PyTorch copies, as on the TPU
            q, k, v = heads_from_flat(qkv.view(-1, 3 * self.dim), nH, N)
            out = HeadsWindowAttentionFn.apply(q, k, v, bias, mask, self.scale, self.kernels,
                                               self._terms(bias, mask_terms, N))
            out = flat_from_heads(out).view(x.shape)
        else:
            drop = self.attn_drop if self.training else 0.0
            out = _xla_attention(qkv, bias, mask, self.scale, nH, impl == "xla_headloop", drop,
                                 generator)
        return self.proj(out)


def _xla_attention(qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                   scale: float, nH: int, headloop: bool, attn_drop: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The JAX 'xla_headloop' / 'xla' math on (Bn, N, 3C) qkv: logits in the
    compute dtype (bias and mask rounded to it), softmax in fp32, the
    probabilities rounded back (and dropped at ``attn_drop`` from
    ``generator``); per head on slices of the flat qkv, or as one product on
    the head layout. -> (Bn, N, C)."""
    Bn, N, threeC = qkv.shape
    C, dt = threeC // 3, qkv.dtype
    hd = C // nH

    def attend(q, k, v, b):   # (..., N, hd) with the heads' bias b (..., N, N)
        logits = torch.matmul(q * scale, k.transpose(-1, -2)) + b.to(dt)
        if mask is not None:
            nW = mask.shape[0]
            m = mask.to(dt) if headloop else mask.to(dt)[:, None]
            logits = (logits.view(Bn // nW, nW, *logits.shape[1:]) + m).view(logits.shape)
        probs = dropout(torch.softmax(logits.float(), dim=-1).to(dt), attn_drop, generator,
                        attn_drop > 0)
        return torch.matmul(probs, v)

    if headloop:
        return torch.cat([attend(*(qkv[..., i * C + h * hd:i * C + (h + 1) * hd]
                                   for i in range(3)), bias[h]) for h in range(nH)], dim=-1)
    q, k, v = qkv.view(Bn, N, 3, nH, hd).permute(2, 0, 3, 1, 4)
    return attend(q, k, v, bias).transpose(1, 2).reshape(Bn, N, C)


class SwinBlock3D(nn.Module):
    """One Swin block. Window-resident: x (B, nW*N, C) in unshifted
    window-major order -> same (``_window_resident_call`` of the JAX
    package). Spatial: x (B, D, H, W, C) -> same: LN1, pad, roll, partition
    (or the padded grid itself under 'pallas_fused'), attention, reverse,
    roll back, crop (the JAX ``__call__``). Then LN1 -> window attention ->
    DropPath -> residual, and the fused LN2 + MLP + DropPath + residual half
    (``_mlp_half``, on either layout). In training the two halves draw their
    per-sample DropPath masks separately from ``generator``; the MLP half's
    rides K2 as a per-row scale. Where ``fused_attn`` picks it for the
    block's window size, a resident block's first half under 'pallas_flat'
    or 'pallas' is the fused half-block (K6, ``_fused_resident_half`` of the
    JAX package) on the block's own parameters: in eval one call of it, in
    training ``FusedAttnBlockFn`` with DropPath as a per-window row scale.
    Under 'fused_block' every resident block takes that half-block at any
    window size (the JAX ``_fused_attn_half``); a spatial block (a stage that
    pads) takes K1 on the partitioned windows, and so does a block with a
    dropout on in training ('xla' with ``attn_drop``).

    ``drop`` and ``attn_drop`` (the config's ``drop_rate`` and
    ``attn_drop_rate``): above 0 in training the block runs its plain route
    (:meth:`_plain_drops`), drawing the dropouts from ``generator``."""

    def __init__(self, dim: int, num_heads: int, window_size: Tuple3, shift_size: Tuple3,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, gelu: str = "tanh", kernels: bool = True,
                 drop_path: float = 0.0, fused_attn: str = "auto", mlp_stash: bool = True,
                 mlp_bwd: str = "xla", attention_impl: str = "auto", long_attn: str = "off",
                 drop: float = 0.0, attn_drop: float = 0.0):
        super().__init__()
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.gelu = gelu
        self.drop = drop
        self.mlp_stash, self.mlp_bwd = mlp_stash, mlp_bwd
        self.kernels = kernels
        self.fused_attn = fused_attn
        self.attention_impl, self.long_attn = attention_impl, long_attn
        self.norm1 = LayerNorm(dim, kernel=kernels)
        self.attn = WindowAttention3D(dim, window_size, num_heads, qkv_bias, qk_scale, kernels,
                                      attn_drop)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def _plain_drops(self) -> bool:
        """Is a dropout of the block on (training, a rate above 0)? Then its
        attention proj and MLP take the plain route with the dropouts, as
        the JAX block leaves its kernels there."""
        return self.training and (self.drop > 0.0 or self.attn.attn_drop > 0.0)

    def _resolve_impl(self) -> str:
        """'auto' is the flat route, the TPU's 'pallas_flat' (the JAX block
        takes 'xla_headloop' off the TPU only to spare interpret mode), and
        so is 'fused_block' where the block leaves K6; the probabilities'
        dropout in training takes the plain 'xla' route."""
        if self.training and self.attn.attn_drop > 0.0:
            return "xla"
        if self.attention_impl in ("auto", "fused_block"):
            return "pallas_flat"
        return self.attention_impl

    def _mask(self, impl: str, dims: Tuple3, window: Tuple3, shift: Tuple3, device):
        """The shift mask in the form ``impl``'s route takes: region ids on
        the flat route, else the additive (nW, N, N) mask; and, for K9 and
        K10 ('pallas', 'pallas_fused'), that mask in their accumulator order
        (else None). -> (mask, mask terms)."""
        key = (tuple(dims), tuple(window), tuple(shift), device)
        if impl == "pallas_flat":
            return _device_constant("region_ids", *key), None
        terms = None
        if impl in ("pallas", "pallas_fused") and self.kernels and device.type == "cuda":
            terms = _device_constant("mask_terms", *key)
        return _device_constant("mask", *key), terms

    def forward(self, x: torch.Tensor, dims: Tuple3, bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, nW*N, C) window-resident tokens of a stage of token dims
        ``dims``, or (B, D, H, W, C) on the spatial path (``dims`` unused)."""
        if x.ndim == 5:
            return self._spatial_call(x, bias, generator)
        impl = self._resolve_impl()
        window, shift = effective_window(dims, self.window_size, self.shift_size)
        B, L, C = x.shape
        N = int(np.prod(window))
        do_shift = any(s > 0 for s in shift)
        fused = (impl in ("pallas_flat", "pallas") and not self._plain_drops()
                 and (fused_attn_enabled(self.fused_attn, N)
                      or self.attention_impl == "fused_block"))
        mask = terms = None
        if do_shift:
            x = _apply_window_perm(x, dims, window, shift, inverse=False)
            mask, terms = self._mask("pallas_flat" if fused else impl, dims, window, shift,
                                     x.device)
        if fused:
            x = self._fused_attn_half(x, window, mask, bias, generator)
        else:
            xn = self.norm1(x)
            xn = xn.reshape(-1, C) if impl == "pallas_flat" else xn.reshape(-1, N, C)
            attn = self.attn(xn, window, mask, bias, impl, self.long_attn, terms,
                             generator).view(B, L, C)
            x = x + self.drop_path(dropout(attn, self.drop, generator, self.training), generator)
        x = self._mlp_half(x, generator)
        if do_shift:
            x = _apply_window_perm(x, dims, window, shift, inverse=True)
        return x

    def _spatial_call(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        """The spatial block path on x (B, D, H, W, C): LN1, zero pad to whole
        windows after the norm, roll by -shift, attention on the windows of
        the padded grid (partitioned, or read in place by K10 under
        'pallas_fused'), roll back, crop, DropPath, residual; then the MLP
        half."""
        impl = self._resolve_impl()
        B, D, H, W, C = x.shape
        window, shift = effective_window((D, H, W), self.window_size, self.shift_size)
        pad = tuple((-s) % w for s, w in zip((D, H, W), window))
        padded = (D + pad[0], H + pad[1], W + pad[2])
        N = int(np.prod(window))
        xn = self.norm1(x)
        if any(pad):
            xn = F.pad(xn, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        do_shift = any(s > 0 for s in shift)
        mask = terms = None
        if do_shift:
            xn = torch.roll(xn, (-shift[0], -shift[1], -shift[2]), (1, 2, 3))
            mask, terms = self._mask(impl, padded, window, shift, x.device)
        if impl == "pallas_fused":
            grid = None if mask is None else mask.view(
                *(p // w for p, w in zip(padded, window)), N, N)
            out = self.attn(xn, window, grid, bias, impl, mask_terms=terms)
        else:
            xw = window_partition(xn, window)
            xw = xw.reshape(-1, C) if impl == "pallas_flat" else xw
            out = self.attn(xw, window, mask, bias, impl, self.long_attn, terms, generator)
            out = window_reverse(out.view(-1, N, C), window, B, *padded)
        if do_shift:
            out = torch.roll(out, shift, (1, 2, 3))
        if any(pad):
            out = out[:, :D, :H, :W]
        x = x + self.drop_path(dropout(out, self.drop, generator, self.training), generator)
        return self._mlp_half(x, generator)

    def _fused_attn_half(self, x: torch.Tensor, window: Tuple3,
                         region_ids: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                         generator: Optional[torch.Generator]) -> torch.Tensor:
        """x + s * proj(window_attention(LN1(x))) from norm1's and attn's
        parameters: in eval one call of K6 (its plain version with
        ``kernels=False``), s = 1; in training ``FusedAttnBlockFn`` with s
        DropPath's per-sample factor repeated over the sample's windows (the
        JAX block's (B,) -> (Bn,) row scale)."""
        attn = self.attn
        N = int(np.prod(window))
        B, L, C = x.shape
        given = bias is not None
        if bias is None:
            bias = bias_from_table(attn.relative_position_bias_table, attn.full_window,
                                   tuple(window), attn.num_heads)
        bqkv = attn.qkv.bias
        if bqkv is None:
            bqkv = torch.zeros(3 * C, device=x.device)
        args = (x.reshape(-1, C), self.norm1.weight, self.norm1.bias, attn.qkv.weight, bqkv,
                bias, region_ids, attn.proj.weight, attn.proj.bias)
        if not self.training:
            op = fused_window_attn_block if self.kernels else window_attn_block_plain
            return op(*args, attn.scale, attn.num_heads, N, self.norm1.eps).view(B, L, C)
        row_scale = None
        if self.drop_path.active():
            row_scale = self.drop_path.sample_scale(B, generator, x.device).repeat_interleave(
                L // N)
        out = FusedAttnBlockFn.apply(*args, row_scale, attn.scale, attn.num_heads, N,
                                     self.norm1.eps, self.kernels,
                                     attn.k1_terms(bias, given, tuple(window)))
        return out.view(B, L, C)

    def _mlp_half(self, x: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        """Rank-agnostic: x (B, L, C) or (B, D, H, W, C), the DropPath
        factor of sample b on its prod(x.shape[1:-1]) rows."""
        B, C = x.shape[0], x.shape[-1]
        if self.training and self.drop > 0.0:   # the JAX Mlp, its dropouts on
            return x + self.drop_path(self.mlp(self.norm2(x), self.gelu, self.drop, generator),
                                      generator)
        args = (x.reshape(-1, C), self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias)
        if not self.training:
            op = fused_ln_mlp_residual if self.kernels else ln_mlp_residual_plain
            return op(*args, 1e-5, self.gelu).view(x.shape)
        row_scale = None
        if self.drop_path.active():
            row_scale = self.drop_path.sample_scale(B, generator, x.device).repeat_interleave(
                int(np.prod(x.shape[1:-1])))
        out = FusedLnMlpResidualFn.apply(*args, row_scale, 1e-5, self.gelu, self.kernels,
                                         self.mlp_stash, self.mlp_bwd)
        return out.view(x.shape)


class PatchMerging(nn.Module):
    """2x2 spatial space-to-depth + LN + linear 4C -> 2C (reference :508-544)."""

    def __init__(self, dim: int, kernels: bool = True):
        super().__init__()
        self.norm = LayerNorm(4 * dim, kernel=kernels)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


def space_to_depth(x: torch.Tensor, patch: Tuple3) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T/pd, H/ph, W/pw, pd*ph*pw*C), features in (dt,
    dy, dx, c) order, after zero padding to whole patches (the JAX patch
    embed's pad)."""
    B, D, H, W, C = x.shape
    pd, ph, pw = patch
    pad = ((-D) % pd, (-H) % ph, (-W) % pw)
    if any(pad):
        x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        D, H, W = D + pad[0], H + pad[1], W + pad[2]
    x = x.reshape(B, D // pd, pd, H // ph, ph, W // pw, pw, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, D // pd, H // ph, W // pw, pd * ph * pw * C)


class PatchEmbed3D(nn.Module):
    """Space-to-depth patch embed: (B, D', H', W', pd*ph*pw*C_in) host s2d
    clips, or with ``embed_impl`` 's2d' / 'conv' the raw (B, T, H, W, C_in)
    clip put through :func:`space_to_depth` here, -> (B, D', H', W', E) with
    one GEMM. ``proj`` keeps the JAX Dense layout (pd*ph*pw*C_in, E),
    features in (dt, dy, dx, c) order. With ``fold_normalize`` the input is
    pixel-scale and the ImageNet (x-mean)/std is folded into the weights in
    fp32 before the cast. A ``stride`` other than the patch (raw clips only)
    makes it the JAX ``nn.Conv``: ``proj`` keeps that kernel's (pd, ph, pw,
    C_in, E) layout and the embed is ``F.conv3d`` on the clip padded to whole
    patches (as the JAX embed pads it)."""

    def __init__(self, cfg: SwinConfig, kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.strided = tuple(cfg.patch_size) != tuple(cfg.stride)
        K = int(np.prod(cfg.patch_size)) * cfg.in_chans
        shape = (*cfg.patch_size, cfg.in_chans) if self.strided else (K,)
        self.proj = nn.ParameterDict({
            "weight": nn.Parameter(torch.zeros(*shape, cfg.embed_dim)),
            "bias": nn.Parameter(torch.zeros(cfg.embed_dim)),
        })
        self.norm = LayerNorm(cfg.embed_dim, kernel=kernels) if cfg.patch_norm else None

    def init_weights(self, generator: torch.Generator) -> None:
        if self.strided:   # flax nn.Conv's lecun_normal: fan-in variance, truncated at 2
            std = (1.0 / np.prod(self.proj["weight"].shape[:-1])) ** 0.5 / .87962566103423978
            trunc_normal_(self.proj["weight"], generator, std)
        else:
            trunc_normal_(self.proj["weight"], generator)
        self.proj["bias"].zero_()

    def _folded(self):
        k, b = self.proj["weight"], self.proj["bias"]
        if not self.cfg.fold_normalize:
            return k, b
        c_in = self.cfg.in_chans
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=k.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=k.device)
        k3 = k.float().reshape(-1, c_in, k.shape[-1]) / std[None, :, None]
        b = b.float() - (k3 * mean[None, :, None]).sum(dim=(0, 1))
        return k3.reshape(k.shape), b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.strided:
            return self._normed(self._conv(x))
        K = self.proj["weight"].shape[0]
        if self.cfg.embed_impl != "host_s2d":
            x = space_to_depth(x, self.cfg.patch_size)
        elif x.shape[-1] != K:
            raise ValueError(f"host_s2d expects s2d input with {K} features, got "
                             f"{x.shape[-1]}: use space_to_depth_host on the loader")
        k, b = self._folded()
        return self._normed(torch.matmul(x, k.to(x.dtype)) + b.to(x.dtype))

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C_in) -> (B, D', H', W', E): the clip zero padded to
        whole patches, then the strided convolution in x's dtype."""
        pd, ph, pw = self.cfg.patch_size
        D, H, W = x.shape[1:4]
        pad = ((-D) % pd, (-H) % ph, (-W) % pw)
        if any(pad):
            x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        w = self.proj["weight"].to(x.dtype).permute(4, 3, 0, 1, 2)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, self.proj["bias"].to(x.dtype),
                     stride=tuple(self.cfg.stride))
        return y.permute(0, 2, 3, 4, 1)

    def _normed(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x) if self.norm is not None else x


class SwinTransformer3D(nn.Module):
    """Backbone: patch embed -> (SimMIM mask mixing) -> stages, each
    window-resident or spatial (``SwinConfig.window_resident``,
    ``attention_impl``) -> final LN.

    forward(x, bias_cache=None, generator=None, token_mask=None,
    mode='full'): x (B, D', H', W', pd*ph*pw*3) host s2d clips, or with
    ``embed_impl`` 's2d' / 'conv' (B, T, H, W, 3) clips, in the compute dtype
    (pixel-scale with fold_normalize, else normalized) -> (B, D', H'/8, W'/8,
    num_features) in the same dtype. Block i's DropPath rate is
    ``linspace(0, drop_path_rate, blocks)[i]``; ``generator`` feeds it in
    training. The blocks of the stages ``cfg.use_checkpoint`` names run
    through :func:`remat` where autograd records (the JAX ``nn.remat``).

    ``token_mask`` (B, mh, mw) 0/1 (needs ``cfg.mask_token``) mixes the
    embedded tokens with the mask token, x * (1 - w) + mask_token * w, the
    mask repeated over time and over (H'/mh, W'/mw) blocks; the forward then
    returns (features, w). ``mode`` splits the graph after the patch embed,
    as the JAX package's: 'embed' returns the (B, D', H', W', E) tokens,
    'encode' takes such tokens and runs the rest."""

    def __init__(self, cfg: SwinConfig, kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed3D(cfg, kernels)
        shift = tuple(s // 2 for s in cfg.window_size)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)).tolist()
        for i_stage, depth in enumerate(cfg.depths):
            dim = int(cfg.embed_dim * 2 ** i_stage)
            for i_blk in range(depth):
                self.add_module(f"stage_{i_stage}_block_{i_blk}", SwinBlock3D(
                    dim, cfg.num_heads[i_stage], cfg.window_size,
                    (0, 0, 0) if i_blk % 2 == 0 else shift, cfg.mlp_ratio, cfg.qkv_bias,
                    cfg.qk_scale, cfg.gelu, kernels,
                    dpr[sum(cfg.depths[:i_stage]) + i_blk], cfg.fused_attn, cfg.mlp_stash,
                    cfg.mlp_bwd, cfg.attention_impl, cfg.long_attn, cfg.drop_rate,
                    cfg.attn_drop_rate))
            if i_stage < len(cfg.depths) - 1:
                self.add_module(f"stage_{i_stage}_downsample", PatchMerging(dim, kernels))
        self.norm = LayerNorm(cfg.num_features, kernel=kernels)
        if cfg.mask_token:
            self.mask_token = nn.Parameter(torch.zeros(1, 1, 1, 1, cfg.embed_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        if self.cfg.mask_token:
            trunc_normal_(self.mask_token, generator)

    def forward(self, x: torch.Tensor, bias_cache: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                token_mask: Optional[torch.Tensor] = None, mode: str = "full"):
        cfg = self.cfg
        if mode not in ("full", "embed", "encode"):
            raise ValueError(f"mode must be 'full', 'embed' or 'encode', got {mode!r}")
        if mode != "encode":
            x = self.patch_embed(x)
            if mode == "embed":
                return x
        w = None
        if token_mask is not None:
            if not cfg.mask_token:
                raise ValueError("token_mask given but config.mask_token=False")
            B, D, H, W, _ = x.shape
            mh, mw = token_mask.shape[-2:]
            w = token_mask.repeat_interleave(H // mh, dim=-2).repeat_interleave(W // mw, dim=-1)
            w = w[:, None, :, :, None].expand(B, D, H, W, 1).to(x.dtype)
            x = x * (1.0 - w) + self.mask_token.to(x.dtype) * w
        x = dropout(x, cfg.drop_rate, generator, self.training)
        for i_stage, depth in enumerate(cfg.depths):
            B, D, H, W, C = x.shape
            dims = (D, H, W)
            window = effective_window(dims, cfg.window_size)
            # a resident stage partitions once and reverses once; the others'
            # blocks take (B, D, H, W, C) and pad, roll and partition each
            resident = ((cfg.window_resident or cfg.attention_impl == "fused_block")
                        and cfg.attention_impl != "pallas_fused"
                        and not any(d % w for d, w in zip(dims, window)))
            if resident:
                x = window_partition(x, window).reshape(B, -1, C)
            checkpointed = cfg.remat_stage(i_stage) and torch.is_grad_enabled()
            for i_blk in range(depth):
                name = f"stage_{i_stage}_block_{i_blk}"
                blk_bias = bias_cache.get(name) if bias_cache is not None else None
                block = getattr(self, name)
                if checkpointed:
                    x = remat(functools.partial(block, dims=dims, bias=blk_bias), x,
                              generator=generator)
                else:
                    x = block(x, dims, blk_bias, generator)
            if resident:
                x = window_reverse(x.reshape(-1, int(np.prod(window)), C), window, B, D, H, W)
            if i_stage < len(cfg.depths) - 1:
                x = getattr(self, f"stage_{i_stage}_downsample")(x)
        x = self.norm(x)
        return x if w is None else (x, w)
