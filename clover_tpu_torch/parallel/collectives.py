"""Collectives with the JAX package's gradient semantics, on
``torch.distributed`` (port of ``clover_tpu/parallel/collectives.py``).

The reference's distributed-negatives primitive is a differentiable
all-gather: the forward gathers every rank's embeddings, the backward hands
each rank the gradient of its own rows summed over the ranks
(mmaction/models/utils/gather_loss.py:5-23). That is the VJP of JAX's tiled
``all_gather``: a reduce-scatter.

``group`` is a ``torch.distributed`` process group (``parallel.mesh.
data_group()`` gives the run's); None is this process alone. With no group,
or a group of one, every function here is the identity and makes no copy.
Only the list forms of the collectives are used (``all_gather``,
``reduce_scatter``, ``all_reduce``, ``broadcast``): both the PyTorch of the
card's machine and a newer one have them, on NCCL and on gloo, and give the
same numbers.

The two sums differ in their backward, by who consumes the result:
``psum_scalar`` is a loss's global value, one scalar for the whole run, so
each rank hands back its cotangent as it is (JAX's psum under shard_map);
``all_reduce_with_grad`` is a statistic every rank consumes in its own share
of the loss (BatchNorm's batch moments), so the cotangents are summed too.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

# the gradient all-reduce's flat buckets (fp32 Swin-B + BERT-base: 4 a step)
BUCKET_BYTES = 256 << 20


def world(group) -> int:
    """The number of ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def comm_device(group) -> torch.device:
    """Where ``group``'s collectives take their tensors: the current card
    for NCCL, the CPU for gloo."""
    if group is not None and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        n = world(ctx.group)
        out = torch.empty((g.shape[0] // n,) + tuple(g.shape[1:]), dtype=g.dtype,
                          device=g.device)
        dist.reduce_scatter(out, list(g.contiguous().chunk(n)), group=ctx.group)
        return out, None


def all_gather_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order; the
    gradient of this rank's rows is summed over the ranks (reduce-scatter),
    the VJP of JAX's tiled ``all_gather``. Equal row counts on every rank."""
    if world(group) == 1:
        return x
    return _AllGather.apply(x, group)


def all_gather_varied(x_padded: torch.Tensor, n_valid: int, group=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable gather of ragged shards (JAX ``all_gather_varied``):
    each rank's ``x_padded`` holds the same number of rows, of which the
    first ``n_valid`` are real. -> (every rank's padded rows in rank order,
    a bool mask of the real ones)."""
    max_n = x_padded.shape[0]
    if world(group) == 1:
        return x_padded, torch.arange(max_n, device=x_padded.device) < n_valid
    counts = _gather(torch.tensor([int(n_valid)], device=comm_device(group)), group)
    mask = torch.arange(max_n, device=counts.device)[None, :] < counts[:, None]
    return _AllGather.apply(x_padded, group), mask.reshape(-1).to(x_padded.device)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum_scalar(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, for a loss's global value: every
    rank's backward sees its own share's cotangent (a global loss is counted
    once, not once a rank). Reference _parse_losses' dist.all_reduce."""
    if world(group) == 1:
        return x
    return _PSum.apply(x, group)


def pmean_scalar(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks (``psum_scalar`` / the rank count)."""
    if world(group) == 1:
        return x
    return _PSum.apply(x, group) / world(group)


def all_reduce_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks where every rank consumes it in its
    own share of the loss: the backward sums the cotangents over the ranks."""
    if world(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[torch.Tensor]]:
    """Consecutive runs of ``tensors`` of one dtype and device, each under
    ``BUCKET_BYTES`` (a larger tensor alone)."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def _flat_apply(tensors: Sequence[torch.Tensor], op) -> None:
    """``op(flat)`` on each bucket of ``tensors`` flattened into one buffer,
    the result copied back in place."""
    for bucket in _buckets(tensors):
        flat = _flatten_dense_tensors(bucket)
        op(flat)
        torch._foreach_copy_(bucket, _unflatten_dense_tensors(flat, bucket))


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group=None) -> None:
    """Sum the parameters' ``.grad`` over the ranks in place: one
    ``all_reduce`` a flat bucket. Each rank's backward gives its share of the
    global loss's gradient, so the sum is the global gradient. Parameters
    without a gradient are left out (the same ones on every rank)."""
    if world(group) == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    _flat_apply(grads, lambda flat: dist.all_reduce(flat, group=group))


def broadcast_tensors(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Overwrite ``tensors`` in place with rank 0's, bucket by bucket."""
    if world(group) == 1:
        return
    _flat_apply(list(tensors), lambda flat: dist.broadcast(flat, src=0, group=group))


def all_gather_rows(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Every rank's rows of each tensor concatenated in rank order, where
    ranks may hold different row counts (the pad-and-count protocol of the
    JAX ``_host_gather``: the counts are exchanged, each tensor padded to the
    largest, gathered and stripped of each rank's padding). The tensors of a
    rank share their row count and lie on ``comm_device(group)``. No
    gradient."""
    if world(group) == 1:
        return list(tensors)
    n_local = tensors[0].shape[0]
    if any(t.shape[0] != n_local for t in tensors):
        raise ValueError(f"the gathered tensors differ in rows: {[t.shape[0] for t in tensors]}")
    counts = _gather(torch.tensor([n_local], device=comm_device(group)), group).tolist()
    max_n = max(counts)
    out = []
    for t in tensors:
        padded = t.new_zeros((max_n,) + tuple(t.shape[1:]))
        padded[:n_local] = t
        stacked = _gather(padded, group).reshape((len(counts), max_n) + tuple(t.shape[1:]))
        out.append(torch.cat([stacked[r, :c] for r, c in enumerate(counts)]))
    return out
