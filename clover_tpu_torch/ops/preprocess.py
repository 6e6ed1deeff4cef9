"""Host-side preprocessing for the host space-to-depth input contract.

Port of ``clover_tpu/ops/preprocess.py``'s ``space_to_depth_host`` and the
ImageNet constants. It is numpy only, so the data loader needs no torch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# RGB order
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def space_to_depth_host(frames: np.ndarray,
                        patch: Tuple[int, int, int] = (2, 4, 4)) -> np.ndarray:
    """(..., T, H, W, C) -> (..., T/pd, H/ph, W/pw, pd*ph*pw*C).

    Features are in (dt, dy, dx, c) order: the layout of the patch embed's
    (pd*ph*pw*C, E) projection, so the embed is one row-major GEMM.
    """
    pd, ph, pw = patch
    lead = frames.shape[:-4]
    T, H, W, C = frames.shape[-4:]
    x = frames.reshape(lead + (T // pd, pd, H // ph, ph, W // pw, pw, C))
    n = len(lead)
    perm = tuple(range(n)) + tuple(i + n for i in (0, 2, 4, 1, 3, 5, 6))
    x = np.ascontiguousarray(x.transpose(perm))
    return x.reshape(lead + (T // pd, H // ph, W // pw, pd * ph * pw * C))
