"""Retrieval evaluation loop (port of ``clover_tpu/engine/eval_loop.py::
run_retrieval_eval``), single process, host space-to-depth or RGB batches.

R@K comes from the port's own numpy copy of the metrics
(``clover_tpu_torch/evaluation/metrics.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from clover_tpu_torch.evaluation.metrics import retrieval_recall, retrieval_recall_varied
from clover_tpu_torch.models.swin3d import embed_dims
from clover_tpu_torch.ops.preprocess import eval_preprocess


def _dedup_sort(indices: np.ndarray, *arrays):
    """Drop sampler-padding duplicates, return arrays sorted by index."""
    _, first = np.unique(indices, return_index=True)
    order = first[np.argsort(indices[first])]
    return [a[order] for a in arrays]


def _prep_batch(batch, model: torch.nn.Module, bias_cache, out_size: int, dtype, device):
    """The batch's clips on ``device`` and the bias cache (a lazy builder
    called now with the token dims the patch embed will give). RGB frames
    (last dim 3: (B, n_clips, T, S, S, 3) uint8) go through
    ``eval_preprocess`` (the centre crop to ``out_size``, normalized, in
    ``dtype``) flattened over the clips; host space-to-depth clips pass as
    they are (the normalization folds into the patch embed). -> (imgs,
    bias_cache)."""
    raw = torch.as_tensor(batch["imgs"])
    rgb = raw.shape[-1] == 3
    if callable(bias_cache):
        dims = (embed_dims(model.backbone.cfg, (raw.shape[2], out_size, out_size)) if rgb
                else tuple(raw.shape[2:5]))
        bias_cache = bias_cache(model, dims)
    raw = raw.to(device)
    if not rgb:
        return raw, bias_cache
    imgs = eval_preprocess(raw.reshape((-1,) + raw.shape[2:]), out_size=out_size, dtype=dtype)
    return imgs.reshape((-1, raw.shape[1]) + imgs.shape[1:]), bias_cache


def run_retrieval_eval(eval_step: Callable, model: torch.nn.Module, dataset, loader_iter,
                       bias_cache=None, out_size: int = 224,
                       dtype: torch.dtype = torch.float32) -> Dict[str, float]:
    """Dual-tower retrieval eval -> R@K metrics.

    ``eval_step(imgs, token_ids, input_mask, bias_cache) -> (v_emb, t_emb)``
    (``make_embed_eval_step``). Batches are dicts of numpy arrays with
    ``imgs`` -- (B, n_clips, D', H', W', pd*ph*pw*3) space-to-depth'd on
    the host, or (B, n_clips, T, S, S, 3) uint8 RGB canonical squares, centre
    cropped to ``out_size`` and normalized in ``dtype`` on the device (the
    model's ``embed_impl`` 's2d' or 'conv') --, ``token_ids``,
    ``input_mask``, ``index`` and ``video_index``. ``bias_cache`` is a
    ``swin_bias_cache`` dict or a callable ``(model, token_dims) -> dict``
    built at the first batch with the patch embed's token dims.
    ``dataset.text_video_ids`` lists each video's captions.
    """
    device = next(model.parameters()).device
    v_list: List[np.ndarray] = []
    t_list: List[np.ndarray] = []
    idx_list: List[np.ndarray] = []
    vid_list: List[np.ndarray] = []
    for batch in loader_iter:
        imgs, bias_cache = _prep_batch(batch, model, bias_cache, out_size, dtype, device)
        v, t = eval_step(imgs, torch.as_tensor(batch["token_ids"]).to(device),
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
