"""Checkpoint save/restore + best-checkpoint bookkeeping (port of
``clover_tpu/engine/checkpoint.py``).

The reference's save/resume stack (TimerEpochBasedRunner.save_checkpoint,
MYCheckpointHook, eval-hook best tracking -- SURVEY.md §5.4): a step-keyed
directory of the whole train state plus a small json of metadata,
best-metric pruning, and weights-only load for finetune-from-pretrain.

The JAX package writes its train-state pytree with orbax; here each step's
directory holds one ``torch.save`` file of host tensors: the step, the fp32
parameters, the model's buffers (BatchNorm's running statistics, the JAX
``batch_stats``), the AdamW state and, where the run keeps one, the EMA
copy. A save is written under a temporary name and renamed into place, as
orbax does, so a reader never sees half a checkpoint; it is read back with
``torch.load(weights_only=True)``. Directory layout as in the JAX package:
``step_%010d/``, ``meta_%010d.json``, ``best.json``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

_STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"^step_(\d{10})$")


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _state_payload(state) -> Dict[str, Any]:
    """A host snapshot of the train state (copies, so training may go on)."""
    model = state.model
    params = {n: _host_copy(p) for n, p in model.named_parameters()}
    buffers = {n: _host_copy(b) for n, b in model.state_dict().items() if n not in params}
    opt = state.optimizer.state_dict()
    opt["state"] = {i: {k: _host_copy(v) if isinstance(v, torch.Tensor) else v
                        for k, v in s.items()} for i, s in opt["state"].items()}
    payload = {"step": int(state.step), "params": params, "buffers": buffers,
               "opt_state": opt}
    if state.ema_params is not None:
        payload["ema_params"] = {n: _host_copy(e) for n, e in state.ema_params.items()}
    return payload


@torch.no_grad()
def load_params(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy ``params`` ({parameter name: tensor}) into the model's
    parameters. Raises unless the names and shapes are the model's."""
    own = dict(model.named_parameters())
    if own.keys() != params.keys():
        raise KeyError(f"checkpoint parameters differ from the model's: "
                       f"{sorted(own.keys() ^ params.keys())[:5]}")
    for name, p in own.items():
        if tuple(params[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(params[name].shape)}, "
                             f"model shape {tuple(p.shape)}")
        p.copy_(params[name])


def _by_child(named: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in named.items():
        child, _, rest = name.partition(".")
        groups.setdefault(child, {})[rest] = t
    return groups


@torch.no_grad()
def merge_pretrained_params(model: torch.nn.Module, pretrained: Dict[str, torch.Tensor]
                            ) -> Tuple[torch.nn.Module, List[str], List[str]]:
    """Weights-only warm-start merge (reference load_from,
    tools/train.py:252-253): each top-level child of the model (the JAX
    tree's top-level key: ``backbone``, ``text_backbone``, ``ssl_head``,
    ...) whose parameter names all match ``pretrained``'s under that child
    is copied from it; every other child keeps its fresh init (e.g. a
    pretrain checkpoint warm-starting a finetune model that adds QA heads).
    A child whose names match but whose shapes differ raises. -> (model,
    loaded children, fresh children)."""
    mine, theirs = _by_child(dict(model.named_parameters())), _by_child(pretrained)
    loaded, fresh = [], []
    for child, params in mine.items():
        src = theirs.get(child)
        if src is None or src.keys() != params.keys():
            fresh.append(child)
            continue
        for name, p in params.items():
            if tuple(src[name].shape) != tuple(p.shape):
                raise ValueError(f"{child}.{name}: pretrained shape {tuple(src[name].shape)}, "
                                 f"model shape {tuple(p.shape)}")
            p.copy_(src[name])
        loaded.append(child)
    return model, loaded, fresh


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._inflight: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # one record a finished save: step, host-snapshot and write seconds, bytes
        self.saves: List[Dict[str, float]] = []
        # best-metric state cached in memory (one process: read from disk)
        self._best = self._read_best()

    def _read_best(self) -> Optional[Dict[str, Any]]:
        if os.path.exists(self._best_file()):
            with open(self._best_file()) as f:
                return json.load(f)
        return None

    def _wait(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an async checkpoint write failed") from err

    # ------------------------------------------------------------- paths
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------- save
    def save(self, state, meta: Optional[Dict[str, Any]] = None) -> str:
        """Persist the train state. The host snapshot is taken now; with
        async_save=True the disk write runs on a background thread so the
        train loop keeps stepping."""
        self._wait()
        step = int(state.step)
        path = self._path(step)
        t0 = time.perf_counter()
        payload = _state_payload(state)
        snapshot_s = time.perf_counter() - t0

        def write():
            t1 = time.perf_counter()
            tmp = os.path.join(self.directory, f".tmp_step_{step:010d}.{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, _STATE_FILE))
            nbytes = os.path.getsize(os.path.join(tmp, _STATE_FILE))
            old = None
            if os.path.exists(path):
                # overwrite (orbax force=True): move the old one aside first
                old = tmp + ".old"
                os.replace(path, old)
            os.replace(tmp, path)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
            with open(os.path.join(self.directory, f"meta_{step:010d}.json"), "w") as f:
                json.dump({"step": step, **(meta or {})}, f)
            self._prune()
            self.saves.append({"step": step, "snapshot_s": snapshot_s,
                               "write_s": time.perf_counter() - t1, "bytes": nbytes})

        if self.async_save:
            def guarded():
                try:
                    write()
                except Exception as e:   # raised again by the next _wait
                    self._error = e

            self._inflight = threading.Thread(target=guarded, daemon=False)
            self._inflight.start()
        else:
            write()
        return path

    def _prune(self):
        steps = self.all_steps()
        best = self._best_step()
        removable = [s for s in steps if s != best]
        while len(removable) > self.max_to_keep:
            victim = removable.pop(0)
            shutil.rmtree(self._path(victim), ignore_errors=True)
            meta = os.path.join(self.directory, f"meta_{victim:010d}.json")
            if os.path.exists(meta):
                os.remove(meta)

    def read_meta(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Metadata json saved alongside a step (epoch, best flags, ...).

        The reference round-trips the epoch through checkpoint meta
        (epoch_based_runner.py:169-201); resume derives start_epoch from
        this rather than assuming constant steps/epoch."""
        self._wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, f"meta_{step:010d}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    # ------------------------------------------------------------- best
    def _best_file(self) -> str:
        return os.path.join(self.directory, "best.json")

    def _best_step(self) -> Optional[int]:
        if os.path.exists(self._best_file()):
            with open(self._best_file()) as f:
                return json.load(f).get("step")
        return None

    def update_best(self, step: int, key: str, value: float,
                    greater_is_better: bool = True) -> bool:
        """Track the best eval metric; returns True if this step is new best
        (reference eval-hook best-ckpt logic, my_eval_hook.py:666-736)."""
        best = self._best
        is_best = (
            best is None
            or (value > best["value"]) == greater_is_better
            and value != best["value"]
        )
        if is_best:
            self._best = {"step": step, "key": key, "value": value}
            with open(self._best_file(), "w") as f:
                json.dump(self._best, f)
        return is_best

    # ------------------------------------------------------------- load
    def _load(self, step: int) -> Dict[str, Any]:
        return torch.load(os.path.join(self._path(step), _STATE_FILE), map_location="cpu",
                          weights_only=True)

    @torch.no_grad()
    def restore(self, state, step: Optional[int] = None):
        """Restore a full train state (resume) in place: the parameters, the
        buffers, the AdamW state, the EMA copy and the step. -> the state,
        or None where there is no checkpoint."""
        self._wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = self._load(step)
        model = state.model
        load_params(model, payload["params"])
        own_buffers = {n: b for n, b in model.state_dict().items()
                       if n not in payload["params"]}
        if own_buffers.keys() != payload["buffers"].keys():
            raise KeyError(f"checkpoint buffers differ from the model's: "
                           f"{sorted(own_buffers.keys() ^ payload['buffers'].keys())[:5]}")
        for name, b in own_buffers.items():
            b.copy_(payload["buffers"][name])
        state.optimizer.load_state_dict(payload["opt_state"])
        if "ema_params" in payload:
            if state.ema_params is None:
                raise ValueError("the checkpoint holds an EMA copy; the train state keeps none")
            for name, e in state.ema_params.items():
                e.copy_(payload["ema_params"][name])
        state.step = int(payload["step"])
        return state

    def restore_params(self, step: Optional[int] = None) -> Optional[Dict[str, torch.Tensor]]:
        """Weights-only load (reference load_from, tools/train.py:252-253):
        {parameter name: fp32 host tensor} (``load_params`` copies it into a
        model), or None where there is no checkpoint."""
        self._wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return self._load(step)["params"]
