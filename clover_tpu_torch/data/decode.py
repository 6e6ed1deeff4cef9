"""Pluggable video/image decode backends (host side).

The reference's hot decode path is Decord (C++/FFmpeg,
datasets/pipelines/loading.py:1499-1621) with PyAV/OpenCV/PIMS/FFmpeg
alternates. Here one small interface serves every consumer:

    backend.decode(path, frame_indices) -> uint8 RGB (N, H, W, 3)

Backends in this image: OpenCV (FFmpeg under the hood), imageio, image
files (PIL/cv2), and a deterministic synthetic generator for CI and
benchmarks. Decord/PyAV slots can be added behind the same interface
where available.

Port of ``clover_tpu/data/decode.py``: the 'synthetic', 'image', 'rawframes',
'opencv' and 'packed' backends, copied. The 'ffmpeg' backend (the native
decoder, ``csrc/video_decoder.cc``) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


class DecodeError(RuntimeError):
    pass


class OpenCVVideoBackend:
    """cv2.VideoCapture-based decode; handles arbitrary frame index sets."""

    def num_frames(self, path: str) -> int:
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        finally:
            cap.release()
        return n

    def decode(self, path: str, frame_indices: Sequence[int]) -> np.ndarray:
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise DecodeError(f"cannot open video {path}")
        try:
            # sequential read with seeks only on gaps — cheaper than
            # per-frame seeks for the near-sorted TSN index pattern
            order = np.argsort(frame_indices)
            sorted_inds = np.asarray(frame_indices)[order]
            frames: dict = {}
            pos = -1
            for idx in sorted_inds:
                idx = int(idx)
                if idx in frames:
                    continue
                if idx != pos + 1:
                    cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                ok, frame = cap.read()
                if not ok:
                    raise DecodeError(f"failed to read frame {idx} of {path}")
                frames[idx] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                pos = idx
            return np.stack([frames[int(i)] for i in frame_indices])
        finally:
            cap.release()


class ImageFileBackend:
    """Single-image 'video' (CC3M image pretraining, T=1)."""

    def num_frames(self, path: str) -> int:
        return 1

    def decode(self, path: str, frame_indices: Sequence[int]) -> np.ndarray:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise DecodeError(f"cannot read image {path}")
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return np.stack([rgb] * len(frame_indices))


class RawFrameBackend:
    """Directory-of-frames decode (reference RawFrameDecode).

    ``target_short_side`` enables reduced-resolution JPEG decode: libjpeg
    decodes at 1/2, 1/4, or 1/8 scale in the DCT domain (cv2
    IMREAD_REDUCED_COLOR_*), which is both faster than full decode and
    skips most of the later canonical resize. The reduce level is probed
    once per frame directory and chosen so the decoded short side stays
    >= target_short_side (so the model-facing crop never upsamples).
    Measured on this host: see BASELINE.md host-pipeline table.
    """

    def __init__(self, filename_tmpl: str = "img_{:05d}.jpg",
                 start_index: int = 1,
                 target_short_side: Optional[int] = None):
        self.filename_tmpl = filename_tmpl
        self.start_index = start_index
        self.target_short_side = target_short_side
        self._reduce_cache: dict = {}

    def num_frames(self, path: str) -> int:
        return len([f for f in os.listdir(path) if not f.startswith(".")])

    _REDUCE_FLAGS = {1: None, 2: "IMREAD_REDUCED_COLOR_2",
                     4: "IMREAD_REDUCED_COLOR_4", 8: "IMREAD_REDUCED_COLOR_8"}

    def _probe_reduce(self, dir_path: str, first_frame: str) -> int:
        """Largest reduce level whose decoded short side >= target."""
        import cv2

        level = self._reduce_cache.get(dir_path)
        if level is not None:
            return level
        level = 1
        if self.target_short_side:
            img8 = cv2.imread(first_frame, cv2.IMREAD_REDUCED_COLOR_8)
            if img8 is not None:
                short = min(img8.shape[:2]) * 8  # ~full-res short side
                for r in (8, 4, 2):
                    if short // r >= self.target_short_side:
                        level = r
                        break
        self._reduce_cache[dir_path] = level
        return level

    def decode(self, path: str, frame_indices: Sequence[int]) -> np.ndarray:
        import cv2

        first = os.path.join(
            path, self.filename_tmpl.format(int(frame_indices[0]) + self.start_index))
        level = self._probe_reduce(path, first)
        flag = (cv2.IMREAD_COLOR if level == 1
                else getattr(cv2, self._REDUCE_FLAGS[level]))
        frames = []
        for idx in frame_indices:
            fp = os.path.join(path, self.filename_tmpl.format(int(idx) + self.start_index))
            img = cv2.imread(fp, flag)
            if img is None:
                raise DecodeError(f"cannot read frame {fp}")
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        return np.stack(frames)


class SyntheticVideoBackend:
    """Deterministic procedural frames keyed by a stable path digest — no IO.

    Used by CI, unit tests, and input-pipeline benchmarks; every "video"
    has a stable length and content derived from its name.  Content is
    keyed by ``zlib.crc32`` — NOT Python's ``hash()``, whose per-process
    salt would make "the same video" differ between runs (a flaky-test /
    reproducibility trap; see tests/test_data.py determinism pin).
    """

    def __init__(self, height: int = 240, width: int = 320, length: int = 64):
        self.height, self.width, self.length = height, width, length

    def num_frames(self, path: str) -> int:
        return self.length

    def decode(self, path: str, frame_indices: Sequence[int]) -> np.ndarray:
        import zlib

        seed = zlib.crc32(path.encode("utf-8")) % (2 ** 31)
        rng = np.random.default_rng(seed)
        # Structured, per-video low-frequency content (color + sinusoid
        # pattern), not iid noise: downsampling averages iid noise into
        # near-identical frames, which collapses contrastive training on
        # synthetic data (learning tests would be testing nothing).
        yy, xx = np.meshgrid(
            np.linspace(0.0, 1.0, self.height),
            np.linspace(0.0, 1.0, self.width), indexing="ij")
        color = rng.uniform(40.0, 215.0, size=3)
        fx, fy = rng.integers(1, 5, size=2)
        px, py = rng.uniform(0.0, 1.0, size=2)
        pattern = (np.sin(2 * np.pi * (fx * xx + px))
                   * np.sin(2 * np.pi * (fy * yy + py)))
        amp = rng.uniform(40.0, 90.0, size=3)
        base = np.clip(
            color[None, None]
            + pattern[..., None] * amp[None, None]
            + rng.normal(0.0, 12.0, size=(self.height, self.width, 3)),
            0, 255).astype(np.uint8)
        frames = []
        for idx in frame_indices:
            # time-varying roll keeps frames distinct but cheap
            frames.append(np.roll(base, shift=int(idx) * 3, axis=1))
        return np.stack(frames)


def get_backend(name: str, **kwargs):
    from clover_tpu_torch.data.clip_cache import PackedClipBackend

    backends = {
        "opencv": OpenCVVideoBackend,
        "image": ImageFileBackend,
        "rawframes": RawFrameBackend,
        "synthetic": SyntheticVideoBackend,
        # decode-free memory-mapped clip pack (data/clip_cache.py) — the
        # hot path for production hosts; per-clip cost is a memcpy
        "packed": PackedClipBackend,
    }
    if name not in backends:
        raise ValueError(f"unknown decode backend {name!r}; have {sorted(backends)}")
    return backends[name](**kwargs)
