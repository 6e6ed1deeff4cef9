"""The train loader's batch -> the model's batch (port of ``tools/train.py``'s
``to_model_batch``): uint8 RGB frames cropped, resized, flipped, normalized
and cast on the device by ``preprocess_clips``."""

from __future__ import annotations

from typing import Dict

import torch

from clover_tpu_torch.ops.preprocess import preprocess_clips


def to_model_batch(host_batch: Dict, out_size: int = 224, dtype: torch.dtype = torch.bfloat16,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """``host_batch``: numpy arrays or tensors from the loader -- ``imgs`` (B,
    n, T, S, S, 3) uint8 canonical squares, ``crop_boxes`` (B*n, 4) fp32
    (y0, x0, h, w) pixels (``random_resized_crop_params``), ``flip`` (B*n,)
    bool, ``token_ids``, ``input_mask`` and any of ``mlm_label``,
    ``v_token_mask``, ``label``. -> the same keys on ``device``, ``imgs`` as
    (B, n, T, out_size, out_size, 3) normalized in ``dtype``, and no crop
    boxes or flips."""
    frames = torch.as_tensor(host_batch["imgs"]).to(device)
    n = frames.shape[1]
    imgs = preprocess_clips(frames.reshape((-1,) + frames.shape[2:]), host_batch["crop_boxes"],
                            host_batch["flip"], out_size, dtype)
    batch = {"imgs": imgs.reshape((-1, n) + imgs.shape[1:])}
    for k in ("token_ids", "input_mask", "mlm_label", "v_token_mask", "label"):
        if k in host_batch:
            batch[k] = torch.as_tensor(host_batch[k]).to(device)
    return batch
