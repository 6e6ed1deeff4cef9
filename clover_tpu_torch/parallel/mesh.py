"""The data-parallel process group (the counterpart of
``clover_tpu/parallel/mesh.py``).

The JAX package trains data parallel by sharding the global batch over a
``data`` mesh axis, so its losses are the single-device losses of the global
batch. Here one process drives one card (NCCL), or one CPU rank (gloo, the
tests and ``--cpu``), launched by ``torchrun``; each holds its slice of the
global batch, the losses gather what they need over the group
(``losses/``), and the train step sums the gradients once a step
(``engine/steps.py``). ``fsdp``, ``model`` and ``sequence`` axes are not
ported (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import os
from typing import Dict

import torch
import torch.distributed as dist

from clover_tpu_torch.parallel import collectives

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
LAUNCH = ("torchrun --standalone --nproc_per_node=N -m clover_tpu_torch.tools.train CFG "
          "--distributed")


def torchrun_env() -> Dict[str, str]:
    """torchrun's variables; raises where one is missing."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise SystemExit(f"--distributed needs torchrun's environment ({', '.join(missing)} "
                         f"unset): launch with {LAUNCH}")
    return {k: os.environ[k] for k in TORCHRUN_ENV}


def init_distributed(cpu: bool) -> torch.device:
    """Join the process group torchrun's variables describe (env://): gloo
    on the CPU with ``cpu``, else NCCL on card ``LOCAL_RANK``, made current,
    its communicator set up now so that a failed init raises here. -> this
    rank's device."""
    env = torchrun_env()
    rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
    if cpu:
        dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world_size)
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: --distributed runs NCCL on the cards; pass --cpu to "
                         "run gloo on the CPU")
    device = torch.device("cuda", int(env["LOCAL_RANK"]))
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method="env://", rank=rank, world_size=world_size,
                            device_id=device)
    return device


def data_group():
    """The run's data-parallel group: every rank, or None without a process
    group (one process)."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank() -> int:
    return collectives.rank(data_group())


def world() -> int:
    return collectives.world(data_group())


def is_primary() -> bool:
    """Rank 0, which alone writes metrics and checkpoints."""
    return rank() == 0


def barrier() -> None:
    if world() > 1:
        dist.barrier()


@torch.no_grad()
def broadcast_module(model: torch.nn.Module, group=None) -> None:
    """Rank 0's parameters and buffers on every rank of ``group`` (JAX
    ``replicate_pytree``): after the seeded init, a ``load_from`` or a
    restore, so that every rank starts the same. None: one process, nothing
    to do."""
    collectives.broadcast_tensors([*model.parameters(), *model.buffers()], group)


def data_axis_size(cfg, world_size: int) -> int:
    """The data axis of a ``world_size``-process run of ``cfg`` (the JAX
    entry's checks, tools/train.py:106-126): every rank on the data axis, whose
    size must divide the global batch; ``parallel.fsdp``, ``model`` or
    ``sequence`` above 1 raise."""
    par = {k: int(v) for k, v in dict(cfg.get("parallel", {}) or {}).items()
           if isinstance(v, (int, float))}
    wide = {k: v for k, v in par.items() if v > 1}
    if wide:
        raise SystemExit(f"parallel {wide}: FSDP, tensor, sequence, pipeline and expert "
                         "parallelism are not ported yet: ROADMAP.md Queue 1 item 5")
    batch_size = cfg.data.get("train_loader", {}).get("batch_size", 8)
    if batch_size % world_size:
        # never silently shrink the group: a 4-rank run with batch 6 would
        # otherwise train a different global batch
        raise SystemExit(
            f"batch_size {batch_size} must be divisible by the data axis size {world_size} "
            f"({world_size} processes); adjust data.train_loader.batch_size or the launch")
    return world_size
