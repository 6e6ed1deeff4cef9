"""Batching, sharded sampling, worker prefetch, device transfer (port of
``clover_tpu/data/loader.py``).

The reference's torch DataLoader + DistributedSampler stack
(mmaction/datasets/builder.py:27-126, samplers/distributed_sampler.py:8-44)
as a lean host pipeline, copied from the JAX package:

- ShardedSampler: deterministic (seed+epoch) shuffle, pad-to-divisible,
  rank-strided subsampling -- the reference sampler's contract.
- DataLoader: worker-pool sample fetch + bounded prefetch queue. Backends:
  ``worker_type='thread'`` (default: decode and resize release the GIL),
  ``'process'`` (a spawn-context pool: the dataset is pickled once per
  worker, indices go out and sample arrays come back) and ``'fork'``.
- prefetch_to_device: keeps ``size`` batches in flight to the card, each
  array copied into pinned host memory, then to the device by a
  ``non_blocking`` copy on a side CUDA stream; the consumer's stream waits
  on the copy's event before it uses the batch.
"""

from __future__ import annotations

import multiprocessing
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

# per-worker dataset registry for process workers: populated by the pool
# initializer (pickled once per worker at pool start under the spawn
# context, inherited under fork); per-task traffic is indices out and
# sample arrays back only
_WORKER_DATASETS: Dict[int, Any] = {}


def _worker_init(ds_key, dataset):
    _WORKER_DATASETS[ds_key] = dataset


def _process_fetch(args):
    ds_key, idx = args
    return _WORKER_DATASETS[ds_key][int(idx)]


class ShardedSampler:
    """Deterministic epoch-shuffled, rank-strided index sampler."""

    def __init__(self, n: int, rank: int = 0, world_size: int = 1,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                 batch_size: int = 1):
        self.n = n
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.batch_size = batch_size

    def indices(self, epoch: int) -> np.ndarray:
        order = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        chunk = self.world_size * self.batch_size
        if self.drop_last:
            usable = (len(order) // chunk) * chunk
            order = order[:usable]
        else:
            pad = (-len(order)) % chunk
            if pad:
                order = np.concatenate([order, order[:pad]])
        return order[self.rank::self.world_size]


class ClassBalancedSampler(ShardedSampler):
    """Samples indices by per-class probability (reference
    ClassSpecificDistributedSampler, samplers/distributed_sampler.py:47-134).

    ``class_probs``: {class_id: sampling weight}; classes absent default 1.
    Each epoch draws len(labels) indices with replacement proportionally.
    """

    def __init__(self, labels: Sequence[int], class_probs: Dict[int, float],
                 **kwargs):
        super().__init__(len(labels), **kwargs)
        labels = np.asarray(labels)
        weights = np.asarray([class_probs.get(int(c), 1.0) for c in labels],
                             dtype=np.float64)
        self._probs = weights / weights.sum()

    def indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.choice(self.n, size=self.n, replace=True, p=self._probs)
        chunk = self.world_size * self.batch_size
        if self.drop_last:
            order = order[: (len(order) // chunk) * chunk]
        else:
            pad = (-len(order)) % chunk
            if pad:
                order = np.concatenate([order, order[:pad]])
        return order[self.rank::self.world_size]


def default_collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        out[key] = np.stack([np.asarray(s[key]) for s in samples])
    return out


class _BufferPool:
    """Ring of reusable batch buffers keyed by (batch key, shape, dtype).

    The batch key is the port's: the JAX pool keys its rings by (shape,
    dtype) alone, so a batch's same-shaped arrays (token_ids, input_mask,
    segment_ids) share one ring and wrap it within depth / 3 batches,
    overwriting batches still queued.

    A fresh numpy allocation pays anonymous-page first-touch faults —
    measured 0.05 GB/s on this image's VM vs ~3 GB/s for a reused buffer
    (BASELINE.md host-pipeline log) — so stacking every batch into new
    memory can cost more than the copy itself. The pool hands out the
    same ``depth`` buffers round-robin per (batch key, shape, dtype); a buffer is
    overwritten again only ``depth`` batches later, which is safe for
    the loader's bounded pipeline (prefetch queue + the one batch the
    consumer holds + the one being transferred must be < depth)."""

    def __init__(self, depth: int = 4):
        import threading

        self.depth = depth
        self._rings: Dict[tuple, list] = {}
        self._next: Dict[tuple, int] = {}
        self._lock = threading.Lock()    # collates run in worker threads

    def take(self, shape: tuple, dtype, name: str = "") -> np.ndarray:
        key = (name, tuple(shape), np.dtype(dtype).str)
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = [np.empty(shape, dtype)
                                           for _ in range(self.depth)]
                self._next[key] = 0
            i = self._next[key]
            self._next[key] = (i + 1) % self.depth
        return ring[i]

    def stack(self, arrs: Sequence[np.ndarray], name: str = "") -> np.ndarray:
        first = np.asarray(arrs[0])
        out = self.take((len(arrs),) + first.shape, first.dtype, name)
        for i, a in enumerate(arrs):
            out[i] = a          # works for 0-d (scalar) samples too
        return out


def make_pooled_collate(depth: int = 4):
    """default_collate variant stacking into a reused buffer ring — see
    _BufferPool. Use DataLoader(reuse_buffers=depth) to enable; batches
    are only valid until ``depth`` more batches have been produced."""
    pool = _BufferPool(depth)

    def collate(samples):
        out: Dict[str, np.ndarray] = {}
        for key in samples[0]:
            out[key] = pool.stack([np.asarray(s[key]) for s in samples], key)
        return out

    return collate


def make_s2d_collate(patch=(2, 4, 4), inner=default_collate):
    """Collate wrapper emitting space-to-depth'd frames for the
    embed_impl='host_s2d' patch embed (DataLoader(host_s2d=...)).

    The loader-side transpose replaces the device's u8 relayout + conv
    lowering (~8 ms/iter at 32-frame eval). Requires frames already at the
    final crop size (the frame-cache / canonical eval contract — the
    device-side crop path cannot run after s2d). Consumers detect the
    layout by ``imgs.shape[-1] != 3``."""
    from clover_tpu_torch.ops.preprocess import space_to_depth_host

    def collate(samples):
        out = inner(samples)
        if "imgs" in out and out["imgs"].shape[-1] == 3:
            # a trailing dim != 3 means the samples are ALREADY in s2d
            # layout (pre-s2d clip pack, clip_cache layout='s2d') — the
            # transform was paid at pack-build time
            out["imgs"] = space_to_depth_host(out["imgs"], patch)
        return out

    return collate


class DataLoader:
    """Iterates collated batches with worker-thread prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        rank: int = 0,
        world_size: int = 1,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        collate_fn=default_collate,
        worker_type: str = "thread",     # 'thread' | 'process'
        host_s2d=None,                   # patch tuple -> s2d 'imgs' collate
        reuse_buffers: int = 0,          # >0: _BufferPool depth (see class)
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        if reuse_buffers:
            if reuse_buffers <= prefetch + 2:
                raise ValueError(
                    f"reuse_buffers={reuse_buffers} must exceed prefetch+2="
                    f"{prefetch + 2} (queue + consumer + in-transfer batches"
                    " would alias)")
            if collate_fn is default_collate:
                collate_fn = make_pooled_collate(reuse_buffers)
        if host_s2d:
            collate_fn = make_s2d_collate(tuple(host_s2d), collate_fn)
        self.collate_fn = collate_fn
        self.worker_type = worker_type
        self._pool = None
        self.sampler = ShardedSampler(
            len(dataset), rank=rank, world_size=world_size, shuffle=shuffle,
            seed=seed, drop_last=drop_last, batch_size=batch_size)
        self.drop_last = drop_last

    def __len__(self) -> int:
        per_rank = len(self.sampler.indices(0))
        if self.drop_last:
            return per_rank // self.batch_size
        return (per_rank + self.batch_size - 1) // self.batch_size

    def _batches(self, epoch: int) -> List[np.ndarray]:
        indices = self.sampler.indices(epoch)
        return [
            indices[i * self.batch_size:(i + 1) * self.batch_size]
            for i in range(len(self))
        ]

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        if self.worker_type == "process":
            yield from self._epoch_process(epoch)
            return
        batches = self._batches(epoch)
        n_batches = len(batches)

        def fetch_batch(batch_idx: np.ndarray) -> Dict[str, np.ndarray]:
            return self.collate_fn([self.dataset[int(i)] for i in batch_idx])

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            inflight: List = []
            it = iter(batches)
            # prime the pipeline
            for _ in range(min(self.prefetch + 1, n_batches)):
                inflight.append(pool.submit(fetch_batch, next(it)))
            for fut in iter(lambda: inflight.pop(0) if inflight else None, None):
                try:
                    nxt = next(it)
                    inflight.append(pool.submit(fetch_batch, nxt))
                except StopIteration:
                    pass
                yield fut.result()

    def _get_pool(self):
        if self._pool is None:
            key = id(self.dataset)
            # 'process' uses the SPAWN context: os.fork() below a live
            # torch / CUDA runtime duplicates a process whose background
            # threads hold locks, and a forked child cannot use CUDA. Spawn
            # pays a one-time per-worker import + dataset pickle instead.
            # 'fork' remains available explicitly for pure-host pipelines.
            ctx_name = "fork" if self.worker_type == "fork" else "spawn"
            ctx = multiprocessing.get_context(ctx_name)
            if ctx_name == "fork":
                _WORKER_DATASETS[key] = self.dataset   # pre-fork: inherited
                self._pool = ctx.Pool(self.num_workers)
            else:
                self._pool = ctx.Pool(
                    self.num_workers, initializer=_worker_init,
                    initargs=(key, self.dataset))
            self._ds_key = key
        return self._pool

    def _epoch_process(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        pool = self._get_pool()
        batches = self._batches(epoch)
        inflight: List = []
        it = iter(batches)
        for _ in range(min(self.prefetch + 1, len(batches))):
            idxs = next(it)
            inflight.append(pool.map_async(
                _process_fetch, [(self._ds_key, int(i)) for i in idxs]))
        while inflight:
            res = inflight.pop(0)
            try:
                idxs = next(it)
                inflight.append(pool.map_async(
                    _process_fetch, [(self._ds_key, int(i)) for i in idxs]))
            except StopIteration:
                pass
            yield self.collate_fn(res.get())

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        return self.epoch(0)


class _PinnedRing:
    """``depth`` slots of pinned host buffers, one per batch key, taken in
    turn. A slot is written again only after the device copy that last
    read it has finished (its event), so a batch in flight is never
    overwritten."""

    def __init__(self, depth: int):
        self.depth = depth
        self._slots: List[Dict[str, torch.Tensor]] = [{} for _ in range(depth)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * depth
        self._next = 0

    def take(self) -> int:
        i = self._next
        self._next = (i + 1) % self.depth
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        return i

    def buffer(self, slot: int, key: str, like: torch.Tensor) -> torch.Tensor:
        buf = self._slots[slot].get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = self._slots[slot][key] = torch.empty(like.shape, dtype=like.dtype,
                                                       pin_memory=True)
        return buf

    def done(self, slot: int, event: torch.cuda.Event) -> None:
        self._events[slot] = event


def prefetch_to_device(
    batch_iter: Iterator[Dict[str, np.ndarray]],
    device="cuda",
    size: int = 2,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Keep ``size`` batches in flight to ``device`` ahead of the consumer;
    yields each batch as a dict of tensors on ``device``.

    On the card each array is copied into a pinned host buffer when the
    batch is taken from ``batch_iter`` (so a loader that recycles its host
    arrays, ``DataLoader(reuse_buffers=...)``, may overwrite them at once),
    then to the device by a ``non_blocking`` copy on a side stream. The
    consumer's current stream waits on the copy's event before the batch is
    yielded, and each device tensor is recorded on that stream for the
    caching allocator. A pinned buffer is reused only after its copy's
    event (:class:`_PinnedRing`). On the CPU it is a plain generator of
    tensors, each a copy (so recycled host arrays stay safe there too)."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batch_iter:
            yield {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
        return
    stream = torch.cuda.Stream(device)
    ring = _PinnedRing(size + 2)
    inflight: List = []

    def put(batch):
        slot = ring.take()
        out = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                host = torch.as_tensor(np.asarray(v))
                pinned = ring.buffer(slot, k, host)
                pinned.copy_(host)
                out[k] = pinned.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
        ring.done(slot, event)
        return out, event

    def ready(staged):
        out, event = staged
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for t in out.values():
            t.record_stream(consumer)
        return out

    for batch in batch_iter:
        inflight.append(put(batch))
        if len(inflight) > size:
            yield ready(inflight.pop(0))
    while inflight:
        yield ready(inflight.pop(0))
