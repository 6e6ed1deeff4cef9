"""Structured metrics logging: stdout + jsonl (+ param table) (port of
``clover_tpu/utils/logging.py``).

Equivalent surface of the reference's TextLoggerHook/TensorboardLoggerHook
+ PrettyTable param dump (SURVEY.md §5.5). The jsonl lines and TensorBoard
events are the JAX package's; ``param_table`` lists a model's parameters
under their JAX leaf paths and shapes, so the table reads as the JAX one.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def get_logger(name: str = "clover_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


class MetricsLogger:
    """Each record to stdout and, with ``work_dir``, to its jsonl file (and
    TensorBoard events). A data-parallel run gives ``work_dir`` to rank 0
    only: the other ranks log to their own stdout."""

    def __init__(self, work_dir: Optional[str] = None,
                 filename: str = "metrics.jsonl", tensorboard: bool = False):
        self.logger = get_logger()
        self._fh = None
        self._tb = None
        if work_dir:
            os.makedirs(work_dir, exist_ok=True)
            self._fh = open(os.path.join(work_dir, filename), "a")
            if tensorboard:
                # reference TensorboardLoggerHook (default_runtime.py:2-7)
                from clover_tpu_torch.utils.tensorboard import TensorBoardWriter

                self._tb = TensorBoardWriter(os.path.join(work_dir, "tb"))

    def log(self, payload: Dict[str, Any], step: Optional[int] = None,
            prefix: str = "") -> None:
        payload = {k: _host(v) for k, v in payload.items()}
        clean = {
            k: (float(v) if np.ndim(v) == 0 else np.asarray(v).tolist())
            for k, v in payload.items()
        }
        if step is not None:
            clean["step"] = int(step)
        clean["time"] = time.time()
        if self._fh:
            self._fh.write(json.dumps(clean) + "\n")
            self._fh.flush()
        if self._tb is not None and step is not None:
            self._tb.add_scalars(
                {k: v for k, v in clean.items()
                 if k not in ("step", "time") and isinstance(v, float)},
                step, prefix=prefix.strip() and prefix.strip() + "/" or "")
        shown = ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in clean.items() if k != "time")
        self.logger.info("%s%s", prefix, shown)

    def close(self):
        if self._fh:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()


def param_table(model: torch.nn.Module) -> str:
    """Per-parameter shape/dtype/size table (reference PrettyTable dump,
    core/runner/epoch_based_runner.py:133-167), one row per JAX leaf: the
    leaf's '/'-joined path and its JAX shape (a Linear's (in, out) kernel),
    in the JAX tree's order (sorted keys)."""
    from clover_tpu_torch.models.bridge import jax_leaf_paths

    params = dict(model.named_parameters())
    rows = []
    total = 0
    for name, path in sorted(jax_leaf_paths(model).items(), key=lambda kv: kv[1]):
        p = params[name]
        shape = tuple(p.shape)
        if path[-1] == "kernel" and list(path[-3:-1]) != ["patch_embed", "proj"]:
            shape = shape[::-1]
        size = int(np.prod(shape)) if shape else 1
        total += size
        rows.append(("/".join(path), str(shape), str(p.dtype).replace("torch.", ""), size))
    width = max((len(r[0]) for r in rows), default=10)
    lines = [f"{'name'.ljust(width)}  shape                dtype     size"]
    for name, shape, dtype, size in rows:
        lines.append(f"{name.ljust(width)}  {shape.ljust(19)}  {dtype.ljust(8)}  {size}")
    lines.append(f"TOTAL params: {total:,}")
    return "\n".join(lines)
