"""Decode-free packed clip cache: pre-resized uint8 clips, memory-mapped.

The TPU-first answer to the host-feed bottleneck. The reference saturated
32 GPUs by throwing Decord worker processes at per-clip video decode
(datasets/pipelines/loading.py:1499-1621) on many-core hosts; per-clip
decode costs ~0.3 core-seconds at 32 frames (BASELINE.md host-pipeline
log), so a 1-core host feeds a v5e chip at ~4% of its eval rate. This
module removes decode from the training/eval loop entirely: clips are
decoded and short-side-resized ONCE by ``tools/build_clip_cache.py`` into
a fixed-record binary pack; the loader's per-clip cost becomes a memcpy
out of the OS page cache (~GB/s/core → thousands of clips/s/core).

Format (version 2; version-1 files still read), two files:
- ``<stem>.bin``  — N fixed-size records, uint8, C-order; mmap'd
  read-only by every reader/worker. Record shape depends on layout:
  * ``layout='thwc'`` (default): (frames, height, width, 3) decoded
    pixels — frame sampling indexes within the record (TSN jitter works
    when the pack stores more frames than the model consumes).
  * ``layout='s2d'``: (frames/pt, height/ph, width/pw, 3*pt*ph*pw) —
    the clip ALREADY in the host_s2d patch-embed layout
    (ops/preprocess.space_to_depth_host feature order), so the loader's
    whole per-clip cost is one memcpy: no resize, no transpose, no
    collate transform. Eval packs only (s2d merges pt frames per slab,
    so per-frame sampling is impossible — decode() accepts exactly the
    identity frame selection).
- ``<stem>.json`` — {"version", "frames", "height", "width", "keys",
  "layout", "patch"}; keys[i] is the dataset-relative path of record i;
  frames/height/width always describe the ORIGINAL (pre-s2d) clip.

Bytes/clip: frames*height*width*3 either way — e.g. 8x224x224x3 =
1.15 MiB (eval pack), 8x256x256x3 = 1.5 MiB (train pack with room for
RandomResizedCrop on device). A 10k-video MSRVTT eval pack at 8x224² is
~11.5 GiB.

``PackedClipBackend`` implements the standard decode-backend interface
(num_frames/decode), so ``backend='packed'`` is a drop-in for any dataset:
frame sampling (data/sampling.py) then indexes *within the packed frames*,
preserving TSN-style temporal jitter when the pack stores more frames than
the model consumes (pack 2-4x frames for train packs).

Reads are ZERO-COPY by default: ``decode``/``get`` return read-only mmap
views — the first real copy happens where the bytes are consumed (the
collate stack), not before. Pass copy=True for an owned array.

Port of ``clover_tpu/data/clip_cache.py``: the writer, the reader and the
``'packed'`` decode backend, copied. The pack builder (``build_clip_cache``,
which decodes and resizes with OpenCV) is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

VERSION = 2


def _record_shape(frames: int, height: int, width: int, layout: str,
                  patch) -> tuple:
    if layout == "thwc":
        return (frames, height, width, 3)
    if layout == "s2d":
        pt, ph, pw = patch
        if frames % pt or height % ph or width % pw:
            raise ValueError(f"clip ({frames},{height},{width}) not "
                             f"divisible by s2d patch {tuple(patch)}")
        return (frames // pt, height // ph, width // pw, 3 * pt * ph * pw)
    raise ValueError(f"unknown clip-cache layout {layout!r}")


class ClipCacheWriter:
    """Append clips (all the same (T, H, W, 3) uint8 shape) to a pack.
    With layout='s2d' each clip is space-to-depth'd at append time."""

    def __init__(self, stem: str, frames: int, height: int, width: int,
                 layout: str = "thwc", patch=None):
        self.stem = stem
        self.layout = layout
        self.patch = tuple(patch) if patch is not None else None
        self.clip_shape = (frames, height, width, 3)
        self.shape = _record_shape(frames, height, width, layout, self.patch)
        os.makedirs(os.path.dirname(os.path.abspath(stem)) or ".", exist_ok=True)
        self._bin = open(stem + ".bin", "wb")
        self._keys = []

    def append(self, key: str, clip: np.ndarray) -> None:
        clip = np.ascontiguousarray(clip, dtype=np.uint8)
        if clip.shape != self.clip_shape:
            raise ValueError(
                f"clip shape {clip.shape} != pack clip shape {self.clip_shape}")
        if self.layout == "s2d":
            from clover_tpu_torch.ops.preprocess import space_to_depth_host

            clip = space_to_depth_host(clip, self.patch)
        self._bin.write(clip.tobytes())
        self._keys.append(key)

    def close(self) -> None:
        self._bin.close()
        meta = {
            "version": VERSION,
            "frames": self.clip_shape[0],
            "height": self.clip_shape[1],
            "width": self.clip_shape[2],
            "keys": self._keys,
            "layout": self.layout,
            "patch": list(self.patch) if self.patch else None,
        }
        with open(self.stem + ".json", "w") as f:
            json.dump(meta, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ClipCache:
    """Memory-mapped reader. Safe to share across threads; process workers
    re-open lazily after pickling (the mmap itself is not pickled)."""

    def __init__(self, stem: str):
        self.stem = stem
        with open(stem + ".json") as f:
            meta = json.load(f)
        if meta.get("version") not in (1, VERSION):
            raise ValueError(f"unsupported clip-cache version {meta.get('version')}")
        self.frames = int(meta["frames"])
        self.height = int(meta["height"])
        self.width = int(meta["width"])
        self.layout = meta.get("layout", "thwc")
        patch = meta.get("patch")
        self.patch = tuple(patch) if patch else None
        self.record_shape = _record_shape(self.frames, self.height,
                                          self.width, self.layout, self.patch)
        self.keys = list(meta["keys"])
        self.row: Dict[str, int] = {k: i for i, k in enumerate(self.keys)}
        self._mm: Optional[np.memmap] = None

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def data(self) -> np.memmap:
        if self._mm is None:
            self._mm = np.memmap(
                self.stem + ".bin", dtype=np.uint8, mode="r",
                shape=(len(self.keys),) + self.record_shape)
        return self._mm

    def get(self, key_or_row, frame_indices: Optional[Sequence[int]] = None,
            copy: bool = False) -> np.ndarray:
        """Fetch one record. Returns a read-only mmap VIEW by default
        (zero-copy — the consumer's stack/astype pays the one real copy);
        copy=True returns an owned array. For s2d-layout packs,
        frame_indices must be None or the identity selection (the s2d
        transform merges patch[0] frames per slab)."""
        row = self.row[key_or_row] if isinstance(key_or_row, str) else int(key_or_row)
        rec = self.data[row]
        if frame_indices is not None:
            inds = np.asarray(frame_indices)
            if self.layout == "s2d":
                if len(inds) != self.frames or (inds != np.arange(self.frames)).any():
                    raise ValueError(
                        "s2d-layout packs hold pre-transformed eval clips; "
                        "frame sampling inside the record is impossible "
                        f"(asked {list(map(int, inds))} of a {self.frames}-"
                        "frame pack). Build a thwc pack for sampled reads.")
            elif len(inds) != rec.shape[0] or (inds != np.arange(rec.shape[0])).any():
                return np.array(rec[inds])    # gather -> owned copy anyway
        return np.array(rec) if copy else rec

    # --- pickling: drop the mmap, keep the (cheap) metadata -------------
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_mm"] = None
        return state


class PackedClipBackend:
    """decode-backend interface over a ClipCache (drop-in for data/decode
    backends): ``num_frames`` is the packed depth, ``decode`` is a memcpy.

    Keys are matched by exact path first, then by path relative to the
    longest trailing components (so data_prefix-joined absolute paths
    still hit relative keys).
    """

    def __init__(self, path: str):
        stem = path[:-5] if path.endswith(".json") else (
            path[:-4] if path.endswith(".bin") else path)
        self.cache = ClipCache(stem)
        self.layout = self.cache.layout
        self.patch = self.cache.patch

    def _row(self, path: str) -> int:
        row = self.cache.row.get(path)
        if row is not None:
            return row
        # absolute/prefixed path -> try trailing components
        parts = path.replace(os.sep, "/").split("/")
        for start in range(1, len(parts)):
            row = self.cache.row.get("/".join(parts[start:]))
            if row is not None:
                return row
        raise KeyError(f"{path!r} not in clip cache {self.cache.stem!r}")

    def num_frames(self, path: str) -> int:
        return self.cache.frames

    def decode(self, path: str, frame_indices: Sequence[int]) -> np.ndarray:
        return self.cache.get(self._row(path), frame_indices)
