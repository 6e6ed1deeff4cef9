"""Retrieval evaluation loop (port of ``clover_tpu/engine/eval_loop.py::
run_retrieval_eval``), single process, host space-to-depth batches.

R@K comes from the port's own numpy copy of the metrics
(``clover_tpu_torch/evaluation/metrics.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from clover_tpu_torch.evaluation.metrics import retrieval_recall, retrieval_recall_varied


def _dedup_sort(indices: np.ndarray, *arrays):
    """Drop sampler-padding duplicates, return arrays sorted by index."""
    _, first = np.unique(indices, return_index=True)
    order = first[np.argsort(indices[first])]
    return [a[order] for a in arrays]


def run_retrieval_eval(eval_step: Callable, model: torch.nn.Module, dataset, loader_iter,
                       bias_cache=None) -> Dict[str, float]:
    """Dual-tower retrieval eval -> R@K metrics.

    ``eval_step(imgs, token_ids, input_mask, bias_cache) -> (v_emb, t_emb)``
    (``make_embed_eval_step``). Batches are dicts of numpy arrays with
    ``imgs`` (B, n_clips, D', H', W', pd*ph*pw*3) already space-to-depth'd
    on the host, ``token_ids``, ``input_mask``, ``index`` and
    ``video_index``. ``bias_cache`` is a ``swin_bias_cache`` dict or a
    callable ``(model, token_dims) -> dict`` built at the first batch.
    ``dataset.text_video_ids`` lists each video's captions.
    """
    device = next(model.parameters()).device
    v_list: List[np.ndarray] = []
    t_list: List[np.ndarray] = []
    idx_list: List[np.ndarray] = []
    vid_list: List[np.ndarray] = []
    for batch in loader_iter:
        raw = batch["imgs"]
        if raw.shape[-1] == 3:
            raise ValueError("run_retrieval_eval takes host space-to-depth batches "
                             "(space_to_depth_host); got RGB frames")
        if callable(bias_cache):
            bias_cache = bias_cache(model, tuple(raw.shape[2:5]))
        v, t = eval_step(torch.as_tensor(raw).to(device),
                         torch.as_tensor(batch["token_ids"]).to(device),
                         torch.as_tensor(batch["input_mask"]).to(device), bias_cache)
        v_list.append(v.float().cpu().numpy())
        t_list.append(t.float().cpu().numpy())
        idx_list.append(np.asarray(batch["index"]))
        vid_list.append(np.asarray(batch["video_index"]))

    v, t, vids = _dedup_sort(np.concatenate(idx_list), np.concatenate(v_list),
                             np.concatenate(t_list), np.concatenate(vid_list))
    captions_per_video = [len(ids) for ids in dataset.text_video_ids]
    if all(c == 1 for c in captions_per_video):
        return retrieval_recall(video_embd=v, text_embd=t)
    # varied: one video embedding per video (first entry), every caption a query
    _, first = np.unique(vids, return_index=True)
    return retrieval_recall_varied(v[np.sort(first)], t, dataset.text_video_ids)
