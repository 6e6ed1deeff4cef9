"""The eval kernels as registered torch ops (namespace ``clover``).

Each forward kernel wrapper an eval route reaches is a
``torch.library.custom_op`` here, so that the eval forward and a graph
traced by ``torch.export`` reach the kernel through one op node:

==========================================  ======  ===================================
op                                          kernel  wrapper (CUDA) / plain version (CPU)
==========================================  ======  ===================================
``clover::k1_window_attention``             K1      ``flat2_window_attention`` /
                                                    ``window_attention_plain``
``clover::k2_ln_mlp_residual``              K2      ``fused_ln_mlp_residual`` /
                                                    ``ln_mlp_residual_plain``
``clover::k3_mlp_postln``                   K3      ``fused_mlp_postln`` / ``mlp_postln_plain``
``clover::k4_layer_norm``                   K4      ``fused_layer_norm`` / ``layer_norm_plain``
``clover::k6_window_attn_block``            K6      ``fused_window_attn_block`` /
                                                    ``window_attn_block_plain`` (eval form)
``clover::k9_window_attention_heads``       K9      ``fused_window_attention`` /
                                                    ``window_attention_heads_plain``
``clover::k10_window_attention_grid``       K10     ``spatial_window_attention`` /
                                                    ``spatial_window_attention_plain``
``clover::k11_flash_attention_heads``       K11     ``flash_window_attention`` /
                                                    ``window_attention_long_plain``
``clover::k11_flash_attention_flat``        K11     ``flat_flash_window_attention`` /
                                                    ``window_attention_flat_flash_plain``
==========================================  ======  ===================================

The CUDA implementation is the wrapper: it works out its plan from the
shapes (``k1_grid``, ``k2_plan``, ``k4_plan``, ``k6_plan``), launches the
kernel or raises, and counts the launch in the wrapper's ``launches``, so
``ops.launch_counts()`` reads the same for an exported graph as for the
eager model. The CPU implementation is the plain version. The fake
implementation gives the output's shape and dtype and touches no data, so
a trace never reaches a launch. The cached bias layouts (``terms``) and the
region ids are optional tensor arguments.

The training autograd Functions (``WindowAttentionFn``, ``FusedAttnBlockFn``,
``FusedLnMlpResidualFn``, ...) keep calling the wrappers directly: the ops
carry no autograd formula, and no train path takes the dispatcher's hop.
``calls`` counts each op's calls on either device (:func:`call_counts`).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import Tensor

from clover_tpu_torch.ops import attn_block, layer_norm, mlp_block
from clover_tpu_torch.ops import window_attention as wa

calls = {}   # op name -> calls of its CPU or CUDA implementation since the last reset


def reset_call_counts() -> None:
    for name in calls:
        calls[name] = 0


def call_counts() -> dict:
    return dict(calls)


def _register(name: str, cuda, cpu, fake):
    """``clover::{name}`` with the signature of ``cuda``: ``cuda`` on CUDA
    tensors, ``cpu`` on CPU tensors, ``fake`` in a trace; each real call
    counted in ``calls``."""
    calls[name] = 0

    def counted(fn):
        def impl(*args):
            calls[name] += 1
            return fn(*args)
        return impl

    schema = torch.library.infer_schema(cuda, mutates_args=())
    op = torch.library.custom_op(f"clover::{name}", counted(cuda), mutates_args=(),
                                 device_types="cuda", schema=schema)
    op.register_kernel("cpu")(counted(cpu))
    op.register_fake(fake)
    return op


# ----------------------------------------------------------------- K1


def _k1_cuda(qkv2: Tensor, bias: Tensor, region_ids: Optional[Tensor], scale: float,
             num_heads: int, N: int, terms: Optional[Tensor]) -> Tensor:
    return wa.flat2_window_attention(qkv2, bias, region_ids, scale, num_heads, N, terms)


def _k1_cpu(qkv2, bias, region_ids, scale, num_heads, N, terms):
    return wa.window_attention_plain(qkv2, bias, region_ids, scale, num_heads, N)


def _k1_fake(qkv2, bias, region_ids, scale, num_heads, N, terms):
    return qkv2.new_empty((qkv2.shape[0], qkv2.shape[1] // 3))


k1_window_attention = _register("k1_window_attention", _k1_cuda, _k1_cpu, _k1_fake)


# ----------------------------------------------------------------- K2


def _k2_cuda(x: Tensor, ln_w: Tensor, ln_b: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
             b2: Tensor, eps: float, gelu: str) -> Tensor:
    return mlp_block.fused_ln_mlp_residual(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu)


def _k2_cpu(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu):
    return mlp_block.ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, gelu)


def _like_x(x, *args):
    return x.new_empty(x.shape)


k2_ln_mlp_residual = _register("k2_ln_mlp_residual", _k2_cuda, _k2_cpu, _like_x)


# ----------------------------------------------------------------- K3


def _k3_cuda(x: Tensor, ln_w: Tensor, ln_b: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
             b2: Tensor, eps: float) -> Tensor:
    return mlp_block.fused_mlp_postln(x, ln_w, ln_b, w1, b1, w2, b2, eps)


def _k3_cpu(x, ln_w, ln_b, w1, b1, w2, b2, eps):
    return mlp_block.mlp_postln_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)


k3_mlp_postln = _register("k3_mlp_postln", _k3_cuda, _k3_cpu, _like_x)


# ----------------------------------------------------------------- K4


def _k4_cuda(x: Tensor, weight: Tensor, bias: Tensor, eps: float) -> Tensor:
    return layer_norm.fused_layer_norm(x, weight, bias, eps)


def _k4_cpu(x, weight, bias, eps):
    return layer_norm.layer_norm_plain(x, weight, bias, eps)


k4_layer_norm = _register("k4_layer_norm", _k4_cuda, _k4_cpu, _like_x)


# ----------------------------------------------------------------- K6


def _k6_cuda(x: Tensor, ln_w: Tensor, ln_b: Tensor, wqkv: Tensor, bqkv: Tensor, bias: Tensor,
             region_ids: Optional[Tensor], wproj: Tensor, bproj: Tensor, scale: float,
             num_heads: int, N: int, eps: float) -> Tensor:
    return attn_block.fused_window_attn_block(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj,
                                              bproj, scale, num_heads, N, eps)


def _k6_cpu(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids, wproj, bproj, scale, num_heads, N, eps):
    return attn_block.window_attn_block_plain(x, ln_w, ln_b, wqkv, bqkv, bias, region_ids,
                                              wproj, bproj, scale, num_heads, N, eps)


k6_window_attn_block = _register("k6_window_attn_block", _k6_cuda, _k6_cpu, _like_x)


# ----------------------------------------------------------------- K9


def _k9_cuda(q: Tensor, k: Tensor, v: Tensor, bias: Tensor, mask: Optional[Tensor],
             scale: float, bias_terms: Optional[Tensor],
             mask_terms: Optional[Tensor]) -> Tensor:
    terms = None if bias_terms is None and mask_terms is None else (bias_terms, mask_terms)
    return wa.fused_window_attention(q, k, v, bias, mask, scale, terms)


def _k9_cpu(q, k, v, bias, mask, scale, bias_terms, mask_terms):
    return wa.window_attention_heads_plain(q, k, v, bias, mask, scale)


def _like_q(q, *args):
    return q.new_empty(q.shape)


k9_window_attention_heads = _register("k9_window_attention_heads", _k9_cuda, _k9_cpu, _like_q)


# ---------------------------------------------------------------- K10


def _k10_cuda(qkv5: Tensor, bias: Tensor, mask_grid: Optional[Tensor], window: List[int],
              scale: float, bias_terms: Optional[Tensor],
              mask_terms: Optional[Tensor]) -> Tensor:
    terms = None if bias_terms is None and mask_terms is None else (bias_terms, mask_terms)
    return wa.spatial_window_attention(qkv5, bias, mask_grid, tuple(window), scale, terms)


def _k10_cpu(qkv5, bias, mask_grid, window, scale, bias_terms, mask_terms):
    return wa.spatial_window_attention_plain(qkv5, bias, mask_grid, tuple(window), scale)


def _k10_fake(qkv5, bias, mask_grid, window, scale, bias_terms, mask_terms):
    B, Dp, Hp, Wp, _, nH, hd = qkv5.shape
    return qkv5.new_empty((B, Dp, Hp, Wp, nH, hd))


k10_window_attention_grid = _register("k10_window_attention_grid", _k10_cuda, _k10_cpu,
                                      _k10_fake)


# ---------------------------------------------------------------- K11


def _k11h_cuda(q: Tensor, k: Tensor, v: Tensor, bias: Tensor, region_ids: Optional[Tensor],
               scale: float) -> Tensor:
    return wa.flash_window_attention(q, k, v, bias, region_ids, scale)


def _k11h_cpu(q, k, v, bias, region_ids, scale):
    return wa.window_attention_long_plain(q, k, v, bias, region_ids, scale)


k11_flash_attention_heads = _register("k11_flash_attention_heads", _k11h_cuda, _k11h_cpu,
                                      _like_q)


def _k11f_cuda(qkv2: Tensor, bias: Tensor, region_ids: Optional[Tensor], scale: float,
               num_heads: int, N: int) -> Tensor:
    return wa.flat_flash_window_attention(qkv2, bias, region_ids, scale, num_heads, N)


def _k11f_cpu(qkv2, bias, region_ids, scale, num_heads, N):
    return wa.window_attention_flat_flash_plain(qkv2, bias, region_ids, scale, num_heads, N)


def _k11f_fake(qkv2, bias, region_ids, scale, num_heads, N):
    return qkv2.new_empty((qkv2.shape[0], qkv2.shape[1] // 3))


k11_flash_attention_flat = _register("k11_flash_attention_flat", _k11f_cuda, _k11f_cpu,
                                     _k11f_fake)

OPS = (k1_window_attention, k2_ln_mlp_residual, k3_mlp_postln, k4_layer_norm,
       k6_window_attn_block, k9_window_attention_heads, k10_window_attention_grid,
       k11_flash_attention_heads, k11_flash_attention_flat)
