"""Training orchestration: epochs, interleaved loaders, eval, checkpoints
(port of ``clover_tpu/engine/trainer.py``).

An explicit loop replacing the reference's runner+hook bus (SURVEY.md
§7.1). Feature parity with the hooks that matter:
- per-iter metrics logging (MetricsLogger)
- eval every N epochs + best-checkpoint tracking
  (MyDistEvalHook, my_eval_hook.py:404-880)
- periodic checkpoint + resume (MYCheckpointHook / runner.resume)
- EMA via TrainState.ema_params (EMA hooks, core/hooks/ema.py), swapped
  into the model for the eval with ``ema_eval``
- multi-dataset interleaving: one optimizer step per loader per
  iteration, shorter loader re-iterated, epoch = longest loader
  (MyEpochBasedMultiDatasetRunner, clover_runner.py:56-161)

The port's train state is updated in place (``engine/train_state.py``), and
``ema_eval`` copies the EMA weights into the model for the eval, so the
preemption handler saves only between them: a SIGTERM / SIGINT that lands
inside a step, or inside an eval, is acted on when it has finished and the
trained weights are back in the model.
"""

from __future__ import annotations

import contextlib
import signal
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from clover_tpu_torch.engine.checkpoint import CheckpointManager
from clover_tpu_torch.utils.logging import MetricsLogger


def interleave_loaders(loaders: Sequence, epoch: int):
    """Yield (loader_idx, batch) one per loader per step; shorter loaders
    restart, epoch length = longest loader (reference
    MyEpochBasedMultiDatasetRunner, clover_runner.py:76-93).

    Each restart r of loader li draws epoch key ``(epoch, li, r)`` hashed
    by crc32 into a disjoint int, so each restart gets a fresh
    deterministic order (the JAX package's seeds)."""
    iters = [iter(ld.epoch(epoch)) for ld in loaders]
    lengths = [len(ld) for ld in loaders]
    restarts = [0] * len(loaders)
    for _ in range(max(lengths)):
        for li, ld in enumerate(loaders):
            try:
                batch = next(iters[li])
            except StopIteration:
                restarts[li] += 1
                sub = zlib.crc32(
                    f"{epoch}:{li}:{restarts[li]}".encode()) % (2 ** 31)
                iters[li] = iter(ld.epoch(sub))  # re-iterate, fresh order
                batch = next(iters[li])
            yield li, batch


class Trainer:
    def __init__(
        self,
        state,
        train_steps: Sequence[Callable],       # one per train loader
        train_loaders: Sequence,
        batch_to_device: Callable,             # (loader idx, host batch) -> model batch
        generator: torch.Generator,            # the run's dropout generator
        total_epochs: int,
        work_dir: Optional[str] = None,
        log_interval: int = 20,
        eval_fn: Optional[Callable] = None,    # (model) -> metrics dict
        eval_interval: int = 1,
        save_best_key: Optional[str] = None,
        ckpt_interval: int = 1,
        ckpt_manager: Optional[CheckpointManager] = None,
        ema_eval: bool = False,
        tensorboard: bool = False,
    ):
        assert len(train_steps) == len(train_loaders)
        self.state = state
        self.train_steps = list(train_steps)
        self.train_loaders = list(train_loaders)
        self.batch_to_device = batch_to_device
        self.generator = generator
        self.total_epochs = total_epochs
        self.metrics = MetricsLogger(work_dir, tensorboard=tensorboard)
        self.log_interval = log_interval
        self.eval_fn = eval_fn
        self.eval_interval = eval_interval
        self.save_best_key = save_best_key
        self.ckpt_interval = ckpt_interval
        self.ckpt = ckpt_manager
        self.ema_eval = ema_eval
        self.start_epoch = 0
        self._epoch = 0          # current epoch, recorded in preemption ckpt meta
        self._busy = False       # a step or an eval holds the model: signals wait
        self._pending_signal: Optional[int] = None

    def resume(self) -> bool:
        if self.ckpt is None:
            return False
        restored = self.ckpt.restore(self.state)
        if restored is None:
            return False
        self.state = restored
        meta = self.ckpt.read_meta()
        if meta is None or "epoch" not in meta:
            raise ValueError(f"checkpoint step {int(self.state.step)} in "
                             f"{self.ckpt.directory} has no epoch in its meta")
        # Epoch round-tripped through checkpoint meta (reference
        # epoch_based_runner.py:169-201): end-of-epoch saves resume at
        # epoch+1; mid-epoch preemption saves redo the epoch. Robust to
        # loader lengths changing across the resume.
        self.start_epoch = int(meta["epoch"]) + (0 if meta.get("preempted") else 1)
        self.metrics.log({"resumed_step": int(self.state.step),
                          "resumed_epoch": self.start_epoch})
        return True

    @contextlib.contextmanager
    def _eval_model(self):
        """The model in eval mode holding the weights to evaluate: the EMA
        copy with ``ema_eval`` (swapped in, and the trained weights swapped
        back after), else the trained ones; training mode is restored
        after."""
        model = self.state.model
        was_training = model.training
        swap = self.ema_eval and self.state.ema_params is not None
        saved = {}
        with torch.no_grad():
            if swap:
                for name, p in model.named_parameters():
                    saved[name] = p.detach().clone()
                    p.copy_(self.state.ema_params[name])
        model.eval()
        try:
            yield model
        finally:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name in saved:
                        p.copy_(saved[name])
            model.train(was_training)

    @contextlib.contextmanager
    def _signals_deferred(self):
        """A SIGTERM / SIGINT that lands inside the block is acted on when
        the block has ended."""
        self._busy = True
        try:
            yield
        finally:
            self._busy = False
        if self._pending_signal is not None:
            self._preempt(self._pending_signal)

    def _preempt(self, signum: int):
        self.metrics.log({"preempted_signal": signum,
                          "step": int(self.state.step)})
        self.ckpt.save(self.state, meta={"preempted": True,
                                         "epoch": self._epoch})
        raise SystemExit(128 + signum)

    def _install_preemption_handler(self) -> Dict[int, object]:
        """Save a checkpoint on SIGTERM/SIGINT before exiting (preemption
        safety -- the reference has no recovery story beyond resume,
        SURVEY.md §5.3). Outside a step or an eval it saves at once; inside
        one, when it has finished. -> the handlers it replaced."""
        if self.ckpt is None:
            return {}

        def handler(signum, _frame):
            if self._busy:
                self._pending_signal = signum
            else:
                self._preempt(signum)

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not in main thread
        return previous

    def _step(self, li: int, batch):
        with self._signals_deferred():
            self.state, metrics = self.train_steps[li](self.state, batch, self.generator)
        return metrics

    def fit(self):
        previous = self._install_preemption_handler()
        try:
            return self._fit()
        finally:
            for sig, old in previous.items():
                signal.signal(sig, old)

    def _fit(self):
        window: List[Dict[str, float]] = []
        t_last = time.time()
        for epoch in range(self.start_epoch, self.total_epochs):
            self._epoch = epoch
            for li, host_batch in interleave_loaders(self.train_loaders, epoch):
                batch = self.batch_to_device(li, host_batch)
                metrics = self._step(li, batch)
                window.append({k: float(v) for k, v in metrics.items()})
                step = int(self.state.step)
                if step % self.log_interval == 0:
                    avg = {
                        k: float(np.mean([m[k] for m in window if k in m]))
                        for k in window[-1]
                    }
                    dt = time.time() - t_last
                    avg["steps_per_sec"] = len(window) / max(dt, 1e-9)
                    avg["epoch"] = epoch
                    self.metrics.log(avg, step=step, prefix="train ")
                    window.clear()
                    t_last = time.time()

            if self.eval_fn is not None and (epoch + 1) % self.eval_interval == 0:
                # the EMA copy is swapped out before a deferred signal saves
                with self._signals_deferred(), self._eval_model() as model:
                    eval_metrics = self.eval_fn(model)
                self.metrics.log(eval_metrics, step=int(self.state.step),
                                 prefix=f"eval[ep{epoch}] ")
                if self.ckpt is not None and self.save_best_key is not None:
                    if self.ckpt.update_best(
                        int(self.state.step), self.save_best_key,
                        float(eval_metrics[self.save_best_key])):
                        self.ckpt.save(self.state, meta={
                            "epoch": epoch, "best": True, **eval_metrics})

            if self.ckpt is not None and (epoch + 1) % self.ckpt_interval == 0:
                self.ckpt.save(self.state, meta={"epoch": epoch})
        return self.state
