"""Blockwise / random video-token mask generators (host-side numpy).

Reference: BEiT-style MaskingGenerator
(mmaction/datasets/pipelines/augmentations.py:2279-2364) and SimMIM-style
RandomMaskGenerator (:2364-2388), producing the (mh, mw) 0/1 grid consumed
by the masked-video branch (swin mask-token mixing).

Port of ``clover_tpu/data/video_masking.py``: a copy, held against it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


class MaskingGenerator:
    """BEiT blockwise masking over an (H, W) patch grid."""

    def __init__(
        self,
        input_size: Tuple[int, int] = (7, 7),
        num_masking_patches: int = 10,
        min_num_patches: int = 4,
        max_num_patches: Optional[int] = None,
        min_aspect: float = 0.3,
        max_aspect: Optional[float] = None,
    ):
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (
            num_masking_patches if max_num_patches is None else max_num_patches)
        max_aspect = max_aspect or 1.0 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _mask_block(self, mask: np.ndarray, max_mask_patches: int,
                    rng: np.random.Generator) -> int:
        delta = 0
        for _ in range(10):
            # remaining budget can drop below min_num_patches near the end
            lo = min(self.min_num_patches, max_mask_patches)
            target_area = rng.uniform(lo, max_mask_patches)
            aspect_ratio = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            if w < self.width and h < self.height:
                top = rng.integers(0, self.height - h)
                left = rng.integers(0, self.width - w)
                num_masked = int(mask[top:top + h, left:left + w].sum())
                if 0 < h * w - num_masked <= max_mask_patches:
                    mask[top:top + h, left:left + w] = 1
                    delta = h * w - num_masked
            if delta > 0:
                break
        return delta

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        mask = np.zeros((self.height, self.width), dtype=np.int32)
        mask_count = 0
        while mask_count < self.num_masking_patches:
            max_mask_patches = min(self.num_masking_patches - mask_count,
                                   self.max_num_patches)
            delta = self._mask_block(mask, max_mask_patches, rng)
            if delta == 0:
                break
            mask_count += delta
        return mask


class RandomMaskGenerator:
    """Uniform random masking of a fixed patch count (SimMIM)."""

    def __init__(self, input_size: Tuple[int, int] = (7, 7),
                 num_masking_patches: int = 10):
        self.height, self.width = input_size
        self.num_masking_patches = num_masking_patches

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        n = self.height * self.width
        mask = np.zeros(n, dtype=np.int32)
        idx = rng.choice(n, size=self.num_masking_patches, replace=False)
        mask[idx] = 1
        return mask.reshape(self.height, self.width)
