"""Input preprocessing (port of ``clover_tpu/ops/preprocess.py``).

Two input contracts feed the Swin tower:

- host space-to-depth: ``space_to_depth_host`` (numpy) hands the patch
  embed uint8 clips already in its (dt, dy, dx, c) feature order;
- RGB frames: the host decodes and resizes each frame once to a canonical
  square (``canonical_host_resize``), and the device does the rest in one
  function (``preprocess_clips``): uint8 -> fp32, a crop-resize per sample
  from its (y0, x0, h, w) box, a horizontal flip, the ImageNet normalize and
  the cast. ``eval_preprocess`` (centre crop) and ``three_crop_preprocess``
  are its eval forms.

The crop-resize is the JAX package's ``jax.image.scale_and_translate(...,
method='linear', antialias=False)``, rebuilt from its two separable weight
matrices (``_weight_mat``, as ``jax._src.image.scale.compute_weight_mat``
makes them) and applied as two batched fp32 products per sample, with TF32
off so that an integer crop stays exact. These are not TPU kernels (the
JAX file reaches no ``pl.pallas_call``): plain PyTorch on the clips' device
is the port on the card too.

The crop and jitter parameter draws are numpy copies of the JAX package's,
bitwise (same rng calls in the same order). ``canonical_host_resize`` uses
torch's bilinear resize with half-pixel centres and no antialias, the
mapping of OpenCV's ``INTER_LINEAR`` that the JAX package calls; OpenCV
rounds its weights in fixed point, so the two differ by at most one uint8
level. Normalization uses the ImageNet statistics in RGB order.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def canonical_host_resize(frames: np.ndarray, canonical: int) -> np.ndarray:
    """Aspect-preserving short-side resize + centre crop to (canonical,
    canonical); uint8 (T, H, W, 3) in and out, on the host's CPU. The sizes
    are the JAX package's: scale = canonical / min(h, w), each side
    max(canonical, round(side * scale)), then the centred square."""
    if frames.shape[-1] != 3:
        raise ValueError(
            f"frames {frames.shape} are already space-to-depth'd (s2d clip "
            "pack) -- this path cannot resize them; use a thwc pack or the "
            "dataset's s2d fast path")
    if frames.shape[1] == canonical and frames.shape[2] == canonical:
        return frames  # already canonical (packed clip cache) -- no-op
    h, w = frames.shape[1:3]
    scale = canonical / min(h, w)
    nh, nw = max(canonical, int(round(h * scale))), max(canonical, int(round(w * scale)))
    x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).float()
    resized = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                            antialias=False)
    y0, x0 = (nh - canonical) // 2, (nw - canonical) // 2
    crop = resized[:, :, y0:y0 + canonical, x0:x0 + canonical]
    return crop.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy()


def random_resized_crop_params(
    rng: np.random.Generator,
    size: int,
    area_range: Tuple[float, float] = (0.08, 1.0),
    aspect_range: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """Sample an (y0, x0, h, w) crop box in pixels inside a size x size frame
    (mmaction RandomResizedCrop semantics): 10 draws, then the whole frame."""
    for _ in range(10):
        area = size * size * rng.uniform(*area_range)
        aspect = np.exp(rng.uniform(np.log(aspect_range[0]), np.log(aspect_range[1])))
        w = int(round(np.sqrt(area * aspect)))
        h = int(round(np.sqrt(area / aspect)))
        if 0 < w <= size and 0 < h <= size:
            y0 = rng.integers(0, size - h + 1)
            x0 = rng.integers(0, size - w + 1)
            return np.asarray([y0, x0, h, w], dtype=np.float32)
    # fallback: central max square
    return np.asarray([0, 0, size, size], dtype=np.float32)


def center_crop_params(size: int, crop: int) -> np.ndarray:
    off = (size - crop) / 2.0
    return np.asarray([off, off, crop, crop], dtype=np.float32)


def color_jitter_params(rng: np.random.Generator, brightness: float = 0.4,
                        contrast: float = 0.4, saturation: float = 0.4) -> np.ndarray:
    """Per-sample (brightness, contrast, saturation) multipliers."""
    return np.asarray([
        rng.uniform(max(0, 1 - brightness), 1 + brightness),
        rng.uniform(max(0, 1 - contrast), 1 + contrast),
        rng.uniform(max(0, 1 - saturation), 1 + saturation),
    ], np.float32)


@contextlib.contextmanager
def _exact_fp32_products():
    """fp32 products without TF32 for the duration (restored after)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """Per-sample (B, in_size, out_size) fp32 weights of the linear kernel,
    no antialias: sample_f = (i + 0.5) / scale - translation / scale - 0.5
    (as products with 1 / scale), triangle weights max(0, 1 - |sample_f - j|),
    each column divided by its sum where that sum exceeds 1000 eps32 (else
    0), columns zeroed where sample_f lies outside [-0.5, in_size - 0.5]."""
    dev = scale.device
    inv = (1.0 / scale)[:, None]
    i = torch.arange(out_size, dtype=torch.float32, device=dev)[None]
    sample_f = (i + 0.5) * inv - translation[:, None] * inv - 0.5        # (B, out)
    j = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
    w = torch.clamp(1.0 - (sample_f[:, None, :] - j).abs(), min=0.0)    # (B, in, out)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def preprocess_clips(frames_u8: torch.Tensor, boxes, flips, out_size: int = 224,
                     dtype: torch.dtype = torch.bfloat16, normalize: bool = True) -> torch.Tensor:
    """(B, T, S, S, 3) uint8 clips, boxes (B, 4) fp32 (y0, x0, h, w) pixels,
    flips (B,) bool -> (B, T, out_size, out_size, 3) in ``dtype``, on the
    clips' device: each sample's box resized to out_size (the linear kernel
    of ``scale_and_translate``), flipped left-right where ``flips`` is set,
    normalized with the ImageNet statistics (``normalize=False``: pixel
    scale, for a model that folds them into its patch embed), cast.

    Per sample: scale (out / h, out / w), translation (-y0 out / h, -x0 out /
    w), and the frames contracted with the rows' and then the columns'
    weight matrices in fp32."""
    dev = frames_u8.device
    B, T, H, W, C = frames_u8.shape
    boxes = torch.as_tensor(boxes, dtype=torch.float32).to(dev)
    flips = torch.as_tensor(flips, dtype=torch.bool).to(dev)
    y0, x0, h, w = boxes.unbind(1)
    wy = _weight_mat(H, out_size, out_size / h, -y0 * out_size / h)    # (B, H, out)
    wx = _weight_mat(W, out_size, out_size / w, -x0 * out_size / w)    # (B, W, out)
    clips = frames_u8.to(torch.float32)
    with _exact_fp32_products():
        # rows: (B, 1, out, H) @ (B, T, H, W*C) -> (B, T, out, W*C)
        rows = torch.matmul(wy.transpose(1, 2)[:, None], clips.reshape(B, T, H, W * C))
        # columns: (B, T*out*C, W) @ (B, W, out) -> (B, T*out*C, out)
        rows = rows.view(B, T, out_size, W, C).permute(0, 1, 2, 4, 3).reshape(B, -1, W)
        out = torch.bmm(rows, wx)
    out = out.view(B, T, out_size, C, out_size).permute(0, 1, 2, 4, 3)
    out = torch.where(flips[:, None, None, None, None], out.flip(3), out)
    if normalize:
        out = _normalized(out)
    return out.to(dtype).contiguous()


def _normalized(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the last (RGB) axis, fp32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _normalize_only(frames_u8: torch.Tensor, dtype: torch.dtype,
                    normalize: bool = True) -> torch.Tensor:
    if not normalize:
        # uint8 pixel values (0..255) are exactly representable in bf16
        return frames_u8.to(dtype)
    return _normalized(frames_u8.to(torch.float32)).to(dtype)


def eval_preprocess(frames_u8: torch.Tensor, out_size: int = 224,
                    dtype: torch.dtype = torch.bfloat16,
                    normalize: bool = True) -> torch.Tensor:
    """Centre-crop eval path: (B, T, S, S, 3) canonical squares in,
    (B, T, out, out, 3) out. Where S equals out_size the crop is the
    identity and only the normalize and the cast run."""
    B, S = frames_u8.shape[0], frames_u8.shape[2]
    if S == out_size:
        return _normalize_only(frames_u8, dtype, normalize)
    boxes = torch.from_numpy(center_crop_params(S, min(S, out_size))).expand(B, 4)
    return preprocess_clips(frames_u8, boxes, torch.zeros(B, dtype=torch.bool), out_size,
                            dtype, normalize)


def three_crop_preprocess(frames_u8: torch.Tensor, out_size: int = 224,
                          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ThreeCrop multi-view eval: the left / top, centre and right / bottom
    crops of each canonical square -> (B*3, T, out, out, 3), each clip's
    three views together (the model mean-pools them as clips)."""
    B, S = frames_u8.shape[0], frames_u8.shape[2]
    crop = min(S, out_size)
    off = float(S - crop)
    positions = np.asarray([[0.0, 0.0, crop, crop], [off / 2.0, off / 2.0, crop, crop],
                            [off, off, crop, crop]], np.float32)
    boxes = torch.from_numpy(np.tile(positions, (B, 1)))
    return preprocess_clips(frames_u8.repeat_interleave(3, dim=0), boxes,
                            torch.zeros(B * 3, dtype=torch.bool), out_size, dtype)


def apply_color_jitter(frames: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast and saturation on float RGB frames (B, T, H, W,
    3) in pixel scale (before the normalize); factors (B, 3). The contrast
    mean is each frame's (over its pixels and channels), the saturation's
    grey each pixel's (over its channels); clipped to [0, 255]."""
    b, c, s = (factors[:, i].to(frames.dtype)[:, None, None, None, None] for i in range(3))
    x = frames * b
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    x = (x - mean) * c + mean
    gray = x.mean(dim=-1, keepdim=True)
    x = (x - gray) * s + gray
    return x.clamp(0.0, 255.0)
