"""Evaluation loops (port of ``clover_tpu/engine/eval_loop.py``) on host
space-to-depth or RGB batches, in one process or data parallel: with a
process ``group`` each rank runs its rank-strided shard of the loader and
``_host_gather`` gives every rank the whole result set (the identity in one
process), so every rank computes the same metrics:

- ``run_retrieval_eval``: dual-tower R@K;
- ``run_itm_retrieval_eval``: the full-fusion ITM text -> video recall on
  cached Swin tokens, optionally reranking each text's ``top_k`` tower
  candidates;
- ``run_mc_retrieval_eval``: multiple choice by tower similarity;
- ``run_zeroshot_action_eval``: the nearest class-name embedding;
- ``run_qa_eval``: argmax accuracy over the QA scores.

Each loop gathers its per-batch results, drops the sampler's padding
duplicates by dataset index and sorts by it; the metrics are the port's own
numpy copies (``clover_tpu_torch/evaluation/metrics.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from clover_tpu_torch.evaluation.metrics import (
    itm_t2v_recall,
    l2_normalize,
    multiple_choice_retrieval_acc,
    qa_accuracy,
    retrieval_recall,
    retrieval_recall_varied,
    zeroshot_action_recognition_acc,
)
from clover_tpu_torch.models.swin3d import embed_dims
from clover_tpu_torch.ops.preprocess import eval_preprocess
from clover_tpu_torch.parallel.collectives import all_gather_rows, comm_device, world


def _host_gather(*arrays, group=None):
    """Every rank's rows of each numpy array concatenated in rank order,
    ragged-safe: the ranks exchange their row counts, pad to the largest,
    gather and strip each rank's padding (the JAX ``_host_gather``'s
    pad-and-count protocol, ``collectives.all_gather_rows``), so per-rank
    result counts may differ. The identity in one process. -> the arrays (one
    array for one)."""
    if world(group) == 1:
        return arrays if len(arrays) > 1 else arrays[0]
    dev = comm_device(group)
    host = [np.ascontiguousarray(a) for a in arrays]
    # bool as uint8: the collectives move numbers
    tensors = [torch.from_numpy(a.view(np.uint8) if a.dtype == bool else a).to(dev) for a in host]
    out = [g.cpu().numpy() for g in all_gather_rows(tensors, group)]
    out = [g.view(bool) if a.dtype == bool else g for g, a in zip(out, host)]
    return out if len(out) > 1 else out[0]


def _dedup_order(indices: np.ndarray) -> np.ndarray:
    """The rows that drop sampler-padding duplicates, in index order."""
    _, first = np.unique(indices, return_index=True)
    return first[np.argsort(indices[first])]


def _dedup_sort(indices: np.ndarray, *arrays):
    """Drop sampler-padding duplicates, return arrays sorted by index."""
    order = _dedup_order(indices)
    return [a[order] for a in arrays]


def _first_of_each(vids: np.ndarray) -> np.ndarray:
    """The first row of each video, in row order."""
    return np.sort(np.unique(vids, return_index=True)[1])


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


def _run_steps(eval_step: Callable, model: torch.nn.Module, loader_iter, bias_cache,
               out_size: int, dtype, keys=()):
    """Each batch through ``eval_step(imgs, token_ids, input_mask,
    bias_cache)`` on the model's device. -> (per batch: the step's output,
    the batch's ``index`` and its ``keys`` as numpy)."""
    device = next(model.parameters()).device
    for batch in loader_iter:
        imgs, bias_cache = _prep_batch(batch, model, bias_cache, out_size, dtype, device)
        out = eval_step(imgs, torch.as_tensor(batch["token_ids"]).to(device),
                        torch.as_tensor(batch["input_mask"]).to(device), bias_cache)
        yield out, np.asarray(batch["index"]), [np.asarray(batch[k]) for k in keys]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _embeddings(eval_step: Callable, model: torch.nn.Module, loader_iter, bias_cache,
                out_size: int, dtype, group=None):
    """The dual-tower embeddings of every entry and its ``video_index``,
    gathered over ``group``, deduplicated and in index order. -> (v, t, vids)
    numpy."""
    vs, ts, idx, vids = [], [], [], []
    for (v, t), index, (vid,) in _run_steps(eval_step, model, loader_iter, bias_cache,
                                            out_size, dtype, ("video_index",)):
        vs.append(_host(v))
        ts.append(_host(t))
        idx.append(index)
        vids.append(vid)
    v, t, idx, vids = _host_gather(*map(np.concatenate, (vs, ts, idx, vids)), group=group)
    return _dedup_sort(idx, v, t, vids)


def run_retrieval_eval(eval_step: Callable, model: torch.nn.Module, dataset, loader_iter,
                       bias_cache=None, out_size: int = 224,
                       dtype: torch.dtype = torch.float32, group=None) -> Dict[str, float]:
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
    ``dataset.text_video_ids`` lists each video's captions. ``group``: the
    data-parallel group whose ranks each iterate their shard of the loader
    (None: one process).
    """
    v, t, vids = _embeddings(eval_step, model, loader_iter, bias_cache, out_size, dtype, group)
    captions_per_video = [len(ids) for ids in dataset.text_video_ids]
    if all(c == 1 for c in captions_per_video):
        return retrieval_recall(video_embd=v, text_embd=t)
    # varied: one video embedding per video (first entry), every caption a query
    return retrieval_recall_varied(v[_first_of_each(vids)], t, dataset.text_video_ids)


def run_itm_retrieval_eval(embed_step: Callable, score_step: Callable, model: torch.nn.Module,
                           dataset, loader_iter, bias_cache=None, out_size: int = 224,
                           dtype: torch.dtype = torch.float32, top_k: Optional[int] = None,
                           pair_batch: int = 32, group=None) -> Dict[str, float]:
    """Full-fusion ITM text -> video retrieval (the reference's non-separate
    test: multimodal_transformer_pretrain.py:220-225 and
    recall_for_itm_t2v_retrieval, video_dataset.py:206-238): every (text,
    video) pair is scored by the fusion tower's ITM head and each text ranks
    the videos by it. The Swin tokens are computed once a video
    (``embed_step(imgs, token_ids, input_mask, bias_cache) -> (tokens (B, T,
    S, C), v_emb, t_emb)``, ``make_itm_embed_step``) and kept on the
    device; only the text and fusion towers run per pair
    (``score_step(tokens, token_ids, input_mask) -> (P,)``,
    ``make_itm_score_step``), ``pair_batch`` pairs a call.

    ``top_k`` scores only each text's top-K videos by tower similarity (the
    retrieve-and-rerank protocol), the others ranking below every scored
    pair; None scores every pair (the reference). Batches as
    ``run_retrieval_eval``'s, one caption an entry."""
    device = next(model.parameters()).device
    toks, vs, ts, ids, masks, idx, vids = [], [], [], [], [], [], []
    for (tokens, v, t), index, (tok, mask, vid) in _run_steps(
            embed_step, model, loader_iter, bias_cache, out_size, dtype,
            ("token_ids", "input_mask", "video_index")):
        toks.append(tokens)
        vs.append(_host(v))
        ts.append(_host(t))
        ids.append(tok.reshape(len(index), -1))
        masks.append(mask.reshape(len(index), -1))
        idx.append(index)
        vids.append(vid)
    tokens = torch.cat(toks)
    if world(group) > 1:
        (tokens,) = all_gather_rows([tokens.to(comm_device(group))], group)
        tokens = tokens.to(device)
    v, t, ids, masks, idx, vids = _host_gather(
        *map(np.concatenate, (vs, ts, ids, masks, idx, vids)), group=group)
    order = _dedup_order(idx)
    v, t, ids, masks, vids = (a[order] for a in (v, t, ids, masks, vids))

    # one token set and tower embedding a video
    first = _first_of_each(vids)
    video_tokens = tokens[torch.as_tensor(order[first], device=device)]
    video_emb = v[first]
    n_text, n_video = len(t), len(first)

    # the candidates by tower similarity
    sims = l2_normalize(t.astype(np.float64)) @ l2_normalize(video_emb.astype(np.float64)).T
    if top_k is None or top_k >= n_video:
        cand = np.broadcast_to(np.arange(n_video), (n_text, n_video))
    else:
        cand = np.argsort(-sims, axis=1)[:, :top_k]

    # the (text, candidate video) pairs through the fusion tower in batches
    pairs_t = np.repeat(np.arange(n_text), cand.shape[1])
    pairs_v = cand.reshape(-1)
    ids_dev, masks_dev = (torch.as_tensor(a).to(device) for a in (ids, masks))
    outs = []
    for start in range(0, len(pairs_t), pair_batch):
        ti = torch.as_tensor(pairs_t[start:start + pair_batch], device=device)
        vi = torch.as_tensor(pairs_v[start:start + pair_batch], device=device)
        outs.append(score_step(video_tokens[vi], ids_dev[ti], masks_dev[ti]))
    scores = np.full((n_text, n_video), -np.inf, np.float32)
    scores[pairs_t, pairs_v] = _host(torch.cat(outs))
    return itm_t2v_recall(scores, vids)


def run_mc_retrieval_eval(eval_step: Callable, model: torch.nn.Module, dataset, loader_iter,
                          bias_cache=None, out_size: int = 224,
                          dtype: torch.dtype = torch.float32, group=None) -> Dict[str, float]:
    """Multiple choice as retrieval: each video's candidates (its entries'
    captions, ``video_index`` grouping them) scored by tower similarity
    against ``dataset.labels`` (``eval_step`` and ``group`` as
    ``run_retrieval_eval``'s)."""
    v, t, vids = _embeddings(eval_step, model, loader_iter, bias_cache, out_size, dtype, group)
    return multiple_choice_retrieval_acc(v[_first_of_each(vids)], t, dataset.labels)


def run_zeroshot_action_eval(eval_step: Callable, model: torch.nn.Module, dataset, loader_iter,
                             class_text_embd: np.ndarray, bias_cache=None, out_size: int = 224,
                             dtype: torch.dtype = torch.float32, group=None) -> Dict[str, float]:
    """Zero-shot action recognition (reference UCF101VideoDataset ->
    recall_for_zeroshot_action_recognition, video_dataset.py:443-513): each
    video's embedding against the class-name embeddings ``class_text_embd``;
    ``label`` in the batches, 1-indexed; ``group`` as ``run_retrieval_eval``'s."""
    vs, labels, idx = [], [], []
    for (v, _), index, (label,) in _run_steps(eval_step, model, loader_iter, bias_cache,
                                              out_size, dtype, ("label",)):
        vs.append(_host(v))
        labels.append(label)
        idx.append(index)
    v, labels, idx = _host_gather(*map(np.concatenate, (vs, labels, idx)), group=group)
    v, labels = _dedup_sort(idx, v, labels)
    return zeroshot_action_recognition_acc(v, class_text_embd, labels)


def run_qa_eval(eval_step: Callable, model: torch.nn.Module, dataset, loader_iter,
                bias_cache=None, out_size: int = 224,
                dtype: torch.dtype = torch.float32, group=None) -> Dict[str, float]:
    """QA / FIB eval: argmax accuracy of ``eval_step``'s (B, num_choices)
    scores (``make_qa_eval_step``) against each batch's ``label``; ``group``
    as ``run_retrieval_eval``'s."""
    scores, labels, idx = [], [], []
    for s, index, (label,) in _run_steps(eval_step, model, loader_iter, bias_cache, out_size,
                                         dtype, ("label",)):
        scores.append(_host(s))
        labels.append(label)
        idx.append(index)
    s, y, idx = _host_gather(*map(np.concatenate, (scores, labels, idx)), group=group)
    s, y = _dedup_sort(idx, s, y)
    return qa_accuracy(s, y)
