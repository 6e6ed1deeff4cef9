"""Retrieval, QA and classification metrics as pure numpy functions (the
port's own copy of ``clover_tpu/evaluation/metrics.py``; the port imports
nothing of ``clover_tpu``).

Definitions follow the reference's mmaction/core/evaluation/accuracy.py:
L2-normalize both towers, scores = text @ video.T, rank of the ground-truth
video; R@1/5/10 as percentages, MR = median rank + 1, and for one caption
per video Recall@all = R@1 + R@5 + R@10 - MR, the best-checkpoint key. The
ITM recall ranks fused match scores the same way (video_dataset.py:206-238);
MC retrieval (accuracy.py:396-427), zero-shot action recognition (:526-542),
QA accuracy (video_dataset.py:332-343) and the classification family follow.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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


def _with_recall_all(metrics: Dict[str, float]) -> Dict[str, float]:
    metrics["Recall@all"] = (metrics["Recall@1"] + metrics["Recall@5"]
                             + metrics["Recall@10"] - metrics["MR"])
    return metrics


def retrieval_recall(video_embd: Optional[np.ndarray] = None,
                     text_embd: Optional[np.ndarray] = None,
                     input_scores: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Text -> video R@1/5/10, MR and Recall@all; ``scores[i, j]`` is text i
    against video j and the ground truth is the diagonal."""
    scores = (np.asarray(input_scores) if input_scores is not None
              else _scores(video_embd, text_embd))
    return _with_recall_all(_recall_at(scores, np.arange(len(scores))))


def retrieval_recall_varied(video_embd: np.ndarray, text_embd: np.ndarray,
                            text_video_ids: Sequence[Sequence]) -> Dict[str, float]:
    """R@1/5/10 and MR when video i has the captions ``text_video_ids[i]``,
    grouped in that order in ``text_embd``: every caption is a query whose
    ground truth is its video's index."""
    gt = np.concatenate([np.full(len(captions), vid)
                         for vid, captions in enumerate(text_video_ids)])
    return _recall_at(_scores(video_embd, text_embd), gt)


def itm_t2v_recall(scores: np.ndarray, gt_video: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Text -> video recall from fused ITM match scores: ``scores[t, v]`` is
    text t against video v, the ground truth ``gt_video[t]`` (the diagonal
    when omitted); R@1/5/10, MR and Recall@all."""
    scores = np.asarray(scores)
    gt = np.arange(len(scores)) if gt_video is None else np.asarray(gt_video).reshape(-1)
    return _with_recall_all(_recall_at(scores, gt))


def multiple_choice_retrieval_acc(video_embd: np.ndarray, text_embd: np.ndarray,
                                  labels: np.ndarray) -> Dict[str, float]:
    """Multiple-choice accuracy by retrieval scores: ``text_embd`` holds
    ``num_choices`` candidates a video, video-major, and choice c of video v
    scores ``video_embd[v] . text_embd[v * C + c]`` (unnormalized)."""
    video_embd = np.asarray(video_embd, dtype=np.float64)
    text_embd = np.asarray(text_embd, dtype=np.float64)
    n_videos = video_embd.shape[0]
    scores = video_embd @ text_embd.T
    scores = scores.reshape(n_videos, n_videos, scores.shape[1] // n_videos)
    own = np.diagonal(scores, axis1=0, axis2=1).T          # (V, C)
    return {"acc": float(np.mean(np.argmax(own, axis=-1) == np.asarray(labels)))}


def zeroshot_action_recognition_acc(video_embd: np.ndarray, text_embd: np.ndarray,
                                    labels: np.ndarray) -> Dict[str, float]:
    """Zero-shot action recognition: the nearest class-name embedding;
    ``labels`` are 1-indexed class ids (the reference's UCF101 convention)."""
    # (videos, classes): the normalized video rows against the class rows
    top1 = np.argsort(-_scores(video_embd=text_embd, text_embd=video_embd), axis=1)[:, 0]
    labels = np.asarray(labels)[: len(top1)]
    return {"top-1 acc": float(np.sum(top1 + 1 == labels)) / len(top1) * 100}


def qa_accuracy(scores: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """Open-ended / multiple-choice QA accuracy: argmax over answer scores."""
    pred = np.argmax(np.asarray(scores), axis=-1)
    return {"acc": float(np.mean(pred == np.asarray(labels).reshape(-1)))}


def top_k_accuracy(scores: Sequence[np.ndarray], labels: Sequence[int],
                   topk: Sequence[int] = (1,)) -> List[float]:
    """Top-k accuracy over per-sample class-score vectors."""
    labels = np.asarray(labels)[:, np.newaxis]
    scores = np.asarray(scores)
    res = []
    for k in topk:
        max_k_preds = np.argsort(scores, axis=1)[:, -k:][:, ::-1]
        match = np.logical_or.reduce(max_k_preds == labels, axis=1)
        res.append(float(match.sum()) / match.shape[0])
    return res


def mean_average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """Multi-label mAP: the mean over classes (those with a positive) of the
    average precision of scores (N, C) against binary labels (N, C)."""
    scores, labels = np.asarray(scores), np.asarray(labels)
    aps = []
    for c in range(scores.shape[1]):
        gt = labels[:, c]
        if gt.sum() == 0:
            continue
        gt_sorted = gt[np.argsort(-scores[:, c])]
        precision = np.cumsum(gt_sorted) / (np.arange(len(gt_sorted)) + 1)
        aps.append(float(np.sum(precision * gt_sorted) / gt.sum()))
    return float(np.mean(aps)) if aps else float("nan")


def precision_recall_at_threshold(scores: np.ndarray, labels: np.ndarray,
                                  threshold: float = 0.5) -> Dict[str, float]:
    """Micro precision / recall of multi-label predictions at a score cut."""
    pred = np.asarray(scores) >= threshold
    labels = np.asarray(labels).astype(bool)
    tp = np.logical_and(pred, labels).sum()
    return {"precision": float(tp / max(pred.sum(), 1)),
            "recall": float(tp / max(labels.sum(), 1))}


def mean_class_accuracy(scores: Sequence[np.ndarray], labels: Sequence[int]) -> float:
    """Mean of per-class recalls."""
    pred = np.argmax(np.asarray(scores), axis=1)
    labels = np.asarray(labels)
    return float(np.mean([np.mean(pred[labels == c] == c) for c in np.unique(labels)]))
