"""Retrieval recall as pure numpy functions (the port's own copy of
``clover_tpu/evaluation/metrics.py::retrieval_recall`` and
``::retrieval_recall_varied``; the port imports nothing of ``clover_tpu``).

Definitions follow the reference's mmaction/core/evaluation/accuracy.py:
L2-normalize both towers, scores = text @ video.T, rank of the ground-truth
video; R@1/5/10 as percentages, MR = median rank + 1, and for one caption
per video Recall@all = R@1 + R@5 + R@10 - MR, the best-checkpoint key.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def l2_normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Row-normalize, mapping zero rows to themselves."""
    norm = np.atleast_1d(np.linalg.norm(x, ord=2, axis=axis))
    norm[norm == 0] = 1
    return x / np.expand_dims(norm, axis=axis)


def _recall_at(scores: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    ranking = np.argsort(-scores, axis=1)
    ind = np.where(ranking == gt[:, None])[1]
    return {
        "Recall@1": float(np.sum(ind == 0)) / len(ind) * 100,
        "Recall@5": float(np.sum(ind < 5)) / len(ind) * 100,
        "Recall@10": float(np.sum(ind < 10)) / len(ind) * 100,
        "MR": float(np.median(ind) + 1),
    }


def _scores(video_embd, text_embd) -> np.ndarray:
    text_norm = l2_normalize(np.asarray(text_embd, dtype=np.float64))
    video_norm = l2_normalize(np.asarray(video_embd, dtype=np.float64))
    return text_norm @ video_norm.T


def retrieval_recall(video_embd: Optional[np.ndarray] = None,
                     text_embd: Optional[np.ndarray] = None,
                     input_scores: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Text -> video R@1/5/10, MR and Recall@all; ``scores[i, j]`` is text i
    against video j and the ground truth is the diagonal."""
    scores = (np.asarray(input_scores) if input_scores is not None
              else _scores(video_embd, text_embd))
    metrics = _recall_at(scores, np.arange(len(scores)))
    metrics["Recall@all"] = (metrics["Recall@1"] + metrics["Recall@5"]
                             + metrics["Recall@10"] - metrics["MR"])
    return metrics


def retrieval_recall_varied(video_embd: np.ndarray, text_embd: np.ndarray,
                            text_video_ids: Sequence[Sequence]) -> Dict[str, float]:
    """R@1/5/10 and MR when video i has the captions ``text_video_ids[i]``,
    grouped in that order in ``text_embd``: every caption is a query whose
    ground truth is its video's index."""
    gt = np.concatenate([np.full(len(captions), vid)
                         for vid, captions in enumerate(text_video_ids)])
    return _recall_at(_scores(video_embd, text_embd), gt)
