"""Frame-index sampling (TSN segment sampling).

Behavior of the reference SampleFrames
(mmaction/datasets/pipelines/loading.py:550-747): the clip is split into
``num_clips`` segments of ``clip_len`` frames (with ``frame_interval``);
training picks a random offset inside each segment, testing the segment
center. Clover's configs use ``clip_len=1, num_clips=num_frames`` —
uniform-segment single-frame sampling (configs/_base_/datasets_local/
msrvtt_retrieval.py:16).

Port of ``clover_tpu/data/sampling.py``: a copy, held against it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def sample_frame_indices(
    total_frames: int,
    clip_len: int = 1,
    frame_interval: int = 1,
    num_clips: int = 8,
    test_mode: bool = False,
    rng: Optional[np.random.Generator] = None,
    twice_sample: bool = False,
    start_index: int = 0,
) -> np.ndarray:
    """Returns int frame indices of shape (num_clips * clip_len,)."""
    ori_clip_len = clip_len * frame_interval
    avg_interval = (total_frames - ori_clip_len + 1) / float(num_clips)

    if test_mode:
        if total_frames > ori_clip_len - 1:
            base = np.arange(num_clips) * avg_interval
            clip_offsets = (base + avg_interval / 2.0).astype(np.int64)
            if twice_sample:
                clip_offsets = np.concatenate([clip_offsets, base.astype(np.int64)])
        else:
            clip_offsets = np.zeros(num_clips, dtype=np.int64)
    else:
        if rng is None:
            rng = np.random.default_rng()
        if avg_interval > 0:
            base = np.arange(num_clips) * avg_interval
            clip_offsets = (base + rng.uniform(0, avg_interval, num_clips)).astype(
                np.int64)
        elif total_frames > max(num_clips, ori_clip_len):
            clip_offsets = np.sort(
                rng.integers(0, total_frames - ori_clip_len + 1, num_clips))
        elif avg_interval == 0:
            ratio = (total_frames - ori_clip_len + 1.0) / num_clips
            clip_offsets = (np.arange(num_clips) * ratio).astype(np.int64)
        else:
            clip_offsets = np.zeros(num_clips, dtype=np.int64)

    frame_inds = clip_offsets[:, None] + np.arange(clip_len)[None, :] * frame_interval
    frame_inds = frame_inds.reshape(-1)
    # loop out-of-bounds indices back into range (reference 'loop' mode)
    frame_inds = np.mod(frame_inds, max(total_frames, 1))
    return frame_inds + start_index
