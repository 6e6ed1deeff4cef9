"""Ops of the port: each kernel wrapper, its plain PyTorch version, and the
CUDA build (``_build``). A wrapper launches its kernel for a CUDA tensor and
runs the plain version only for a CPU tensor; its ``launches`` attribute
counts kernel launches. Importing the package registers the eval kernels as
torch ops (``library``: ``torch.ops.clover.*``), which the eval forward and
an exported graph call."""

from clover_tpu_torch.ops import library  # noqa: F401  (registers torch.ops.clover.*)
from clover_tpu_torch.ops.attn_block import (  # noqa: F401
    FusedAttnBlockFn,
    fused_window_attn_block,
    window_attn_block_plain,
)
from clover_tpu_torch.ops.layer_norm import fused_layer_norm, layer_norm_plain  # noqa: F401
from clover_tpu_torch.ops.mlp_block import (  # noqa: F401
    FusedLnMlpResidualFn,
    FusedMlpPostlnDropoutFn,
    fused_ln_mlp_residual,
    fused_ln_mlp_residual_stash,
    fused_ln_mlp_residual_train,
    fused_mlp_postln,
    fused_mlp_postln_dropout,
    ln_mlp_residual_bwd_onepass,
    ln_mlp_residual_bwd_pair,
    ln_mlp_residual_bwd_passes,
    ln_mlp_residual_bwd_recompute,
    ln_mlp_residual_bwd_stash,
    ln_mlp_residual_plain,
    mlp_postln_mask_bwd,
    mlp_postln_mask_plain,
    mlp_postln_plain,
)
from clover_tpu_torch.ops.window_attention import (  # noqa: F401
    HeadsWindowAttentionFn,
    SpatialWindowAttentionFn,
    WindowAttentionFn,
    flash_window_attention,
    flat2_window_attention,
    flat2_window_attention_bwd,
    flat_flash_window_attention,
    fused_window_attention,
    long_window_attention_from_flat,
    spatial_window_attention,
    spatial_window_attention_plain,
    window_attention_bwd_keys_plain,
    window_attention_bwd_plain,
    window_attention_bwd_rows_plain,
    window_attention_flat_flash_plain,
    window_attention_heads_bwd_plain,
    window_attention_heads_plain,
    window_attention_long_plain,
    window_attention_plain,
)

KERNELS = (flat2_window_attention, fused_ln_mlp_residual, fused_mlp_postln, fused_layer_norm,
           flat2_window_attention_bwd, fused_ln_mlp_residual_stash, fused_window_attn_block,
           fused_mlp_postln_dropout, fused_ln_mlp_residual_train, ln_mlp_residual_bwd_onepass,
           ln_mlp_residual_bwd_pair, fused_window_attention, spatial_window_attention,
           flash_window_attention, flat_flash_window_attention)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
