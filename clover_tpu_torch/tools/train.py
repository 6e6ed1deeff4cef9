"""Training entry point (port of ``tools/train.py``).

    python -m clover_tpu_torch.tools.train configs/exp/debug_retrieval_synthetic.py \
        --work-dir /tmp/run1 [--resume] [--cpu] [--cfg-options key=val ...]
    torchrun --standalone --nproc_per_node=N -m clover_tpu_torch.tools.train CFG \
        --distributed [--cpu] [...]

Builds the data, the model (seeded random weights, or a ``load_from``
warm start), AdamW with the config's schedule and freeze mask, the train
step of the task, the eval of the config's ``data.val`` and the checkpoint
manager, then runs the epochs (``engine/trainer.py``): eval every
``evaluation.interval`` epochs, the best checkpoint by
``evaluation.save_best``, a checkpoint every ``checkpoint.interval``
epochs, and ``--resume`` from the latest one. ``data.train`` may be one
dataset config or a list, trained with one step per loader per iteration.

It runs on the card unless ``--cpu`` is given, and raises without one.
``--distributed`` trains data parallel, one process a card (NCCL; gloo on
the CPU with ``--cpu``) under torchrun's variables, and raises without them:
the config's ``batch_size`` is the global batch, each rank loads its
rank-strided slice of it and of the val set, the parameters are broadcast
from rank 0 after the init, a ``load_from`` and a ``--resume``, the losses
and the gradient are the global batch's (``engine/steps.py``), and rank 0
alone writes the config, ``metrics.jsonl``, TensorBoard events and the
checkpoints. A ``parallel`` section with an fsdp, model or sequence size
above 1 raises (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Train a clover_tpu_torch model")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (debug/CI)")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel, one process a device, under torchrun")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of training into DIR")
    p.add_argument("--tb", action="store_true",
                   help="write TensorBoard event files to work_dir/tb "
                        "(also enabled by cfg log_tensorboard=True)")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


def pick_device(cpu: bool):
    """The CPU with ``cpu``, else the card; raises without one."""
    import torch

    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this entry runs on the card; pass --cpu to run "
                         "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def check_single_device(cfg, distributed: bool = False) -> None:
    """Raise where the config or the command asks for more devices than the
    entry drives: anything but data parallel, which runs only under
    ``distributed``, over torchrun's ranks (``parallel.mesh.data_axis_size``)."""
    from clover_tpu_torch.parallel.mesh import data_axis_size, torchrun_env

    data_axis_size(cfg, int(torchrun_env()["WORLD_SIZE"]) if distributed else 1)


def make_train_state(cfg, model, steps_per_epoch: int):
    """The config's AdamW (schedule over ``total_epochs``, warmup, freeze
    mask) and EMA over ``model``'s parameters, as a fresh TrainState."""
    from clover_tpu_torch.engine import TrainState, make_optimizer
    from clover_tpu_torch.utils.logging import get_logger

    opt_cfg = cfg.get("optimizer", {})
    sched_cfg = cfg.get("schedule", {})
    total_steps = steps_per_epoch * cfg.total_epochs
    warmup_epochs = sched_cfg.get("warmup_epochs", 0)
    # freeze_stage / freeze_except (reference recognizers/base.py:138-163;
    # substring match on the JAX leaf paths, except-list wins)
    freeze_stage = cfg.model.get("freeze_stage")
    freeze_mask = None
    if freeze_stage:
        from clover_tpu_torch.engine.optim import freeze_mask_from_cfg

        freeze_mask = freeze_mask_from_cfg(model, freeze_stage,
                                           cfg.model.get("freeze_except", ()))
        get_logger().info("freeze_stage %s (except %s): %d/%d param tensors frozen",
                          freeze_stage, cfg.model.get("freeze_except", ()),
                          sum(not m for m in freeze_mask.values()), len(freeze_mask))
    optimizer, schedule = make_optimizer(
        model,
        base_lr=opt_cfg.get("lr", 1e-4),
        total_steps=total_steps,
        warmup_steps=int(warmup_epochs * steps_per_epoch),
        weight_decay=opt_cfg.get("weight_decay", 0.01),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.98))),
        eps=opt_cfg.get("eps", 1e-8),
        min_lr_ratio=sched_cfg.get("min_lr_ratio", 0.0),
        warmup_start_ratio=sched_cfg.get("warmup_start_ratio", 0.001),
        freeze_mask=freeze_mask,
    )
    return TrainState.create(model, optimizer, schedule,
                             ema=cfg.get("ema", {}).get("enabled", False))


def build_eval_fn(cfg, model, dataset, loader, img_size: int, group=None):
    """``eval_fn(model) -> metrics`` for the config's eval, shared by the
    train and the test entry: for pretrain and retrieval models the
    dual-tower retrieval, or the ``eval_mode`` asked for ('mc_retrieval',
    'itm_retrieval', 'zeroshot_action'); the QA accuracy otherwise. Each
    call builds the Swin bias cache, and the zero-shot class embeddings,
    from the weights the model holds then (the parameters change between
    evals). With ``group`` each rank iterates its shard of ``loader`` and
    every rank gets the metrics of the whole set."""
    import torch

    from clover_tpu_torch.engine import (make_embed_eval_step, make_itm_embed_step,
                                         make_itm_score_step, make_qa_eval_step,
                                         run_itm_retrieval_eval, run_mc_retrieval_eval,
                                         run_qa_eval, run_retrieval_eval,
                                         run_zeroshot_action_eval)
    from clover_tpu_torch.models import bias_cache_builder

    is_retrieval = (cfg.model["type"] == "CloverPretrain"
                    or cfg.model.get("task", "retrieval") == "retrieval")
    eval_mode = cfg.model.get("eval_mode") if is_retrieval else None
    swin_cache = bias_cache_builder(model.config.swin)

    def common(m):
        # val iterates epoch(0): test-mode loaders are deterministic, so
        # every eval sees the same clips
        return dict(loader_iter=loader.epoch(0), bias_cache=swin_cache,
                    out_size=img_size, dtype=m.dtype, group=group)

    if eval_mode == "itm_retrieval":
        # full-fusion ITM reranking (reference forward_test non-separate
        # branch + recall_for_itm_t2v_retrieval)
        embed, score = make_itm_embed_step(model), make_itm_score_step(model)
        return lambda m: run_itm_retrieval_eval(embed, score, m, dataset,
                                                top_k=cfg.model.get("itm_top_k"), **common(m))
    if not is_retrieval:
        step = make_qa_eval_step(model)
        return lambda m: run_qa_eval(step, m, dataset, **common(m))
    step = make_embed_eval_step(model)
    if eval_mode == "mc_retrieval":
        return lambda m: run_mc_retrieval_eval(step, m, dataset, **common(m))
    if eval_mode != "zeroshot_action":
        return lambda m: run_retrieval_eval(step, m, dataset, **common(m))

    # class-name retrieval (reference UCF101VideoDataset ->
    # recall_for_zeroshot_action_recognition)
    enc = dataset.encode_class_names(cfg.model.get("class_template", "a video of {}"))

    def zeroshot(m):
        device = next(m.parameters()).device
        with torch.inference_mode():
            cls_embd = m.forward_text(torch.as_tensor(enc["token_ids"]).to(device),
                                      torch.as_tensor(enc["input_mask"]).to(device))
        return run_zeroshot_action_eval(step, m, dataset,
                                        class_text_embd=cls_embd.float().cpu().numpy(),
                                        **common(m))

    return zeroshot


def main(argv: Optional[List[str]] = None):
    """-> the Trainer after ``fit`` (its ``state`` holds the model, the
    optimizer and the step). With ``--distributed`` the process group stays
    up for the caller (``__main__`` ends it)."""
    args = parse_args(argv)
    import torch

    from clover_tpu_torch.builder import (build_dataset, build_loader, build_model,
                                          build_pretrain_loss_config, build_tokenizer)
    from clover_tpu_torch.config import load_config, parse_cfg_options
    from clover_tpu_torch.engine import (CheckpointManager, Trainer, make_pretrain_train_step,
                                         make_qa_train_step, make_retrieval_train_step,
                                         merge_pretrained_params, to_model_batch)
    from clover_tpu_torch.models import init_params
    from clover_tpu_torch.parallel import collectives, mesh
    from clover_tpu_torch.utils.logging import get_logger, param_table
    from clover_tpu_torch.utils.profiling import trace

    logger = get_logger()
    cfg = load_config(args.config, overrides=parse_cfg_options(args.cfg_options))
    check_single_device(cfg, args.distributed)
    group = None   # the data-parallel group: each rank its slice of every global batch
    if args.distributed:
        device = mesh.init_distributed(args.cpu)   # the CPU, or card LOCAL_RANK
        group = mesh.data_group()
    else:
        device = pick_device(args.cpu)
    rank, world = collectives.rank(group), collectives.world(group)
    work_dir = args.work_dir or cfg.get("work_dir") or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    if rank == 0:
        cfg.dump(os.path.join(work_dir, "config.json"))
    logger.info("device: %s (rank %d of %d)", device, rank, world)

    # ------------------------------------------------------------- data
    tok_cfg = cfg.get("tokenizer")
    tokenizer = build_tokenizer(tok_cfg) if tok_cfg else None
    train_cfgs = cfg.data.train
    if isinstance(train_cfgs, dict):
        train_cfgs = [train_cfgs]
    datasets = [build_dataset(dc, tokenizer) for dc in train_cfgs]
    if tokenizer is None:
        tokenizer = datasets[0].tokenizer
    loader_cfg = cfg.data.get("train_loader", {"batch_size": 8, "num_workers": 4})
    loaders = [build_loader(ds, loader_cfg, seed=args.seed, rank=rank, world_size=world)
               for ds in datasets]

    # ------------------------------------------------------------- model
    model, _ = build_model(cfg.model, device=device)
    init_params(model, torch.Generator().manual_seed(args.seed))
    is_pretrain = cfg.model["type"] == "CloverPretrain"
    task = cfg.model.get("task", "retrieval")
    img_size = cfg.get("img_size", 224)
    logger.info("\n%s", param_table(model))

    def batch_to_device(loader_idx, host_batch):
        return to_model_batch(host_batch, img_size, model.dtype, device)

    # weights-only warm start (reference load_from, tools/train.py:252-253):
    # a checkpoint directory of this package; top-level children that match
    # by name and shape are taken, the rest keep their fresh init
    load_from = cfg.get("load_from")
    if load_from:
        pretrained = CheckpointManager(load_from).restore_params()
        if pretrained is None:
            raise SystemExit(f"load_from: no checkpoint in {load_from}")
        _, loaded, fresh = merge_pretrained_params(model, pretrained)
        logger.info("load_from %s: loaded %s; fresh %s", load_from, loaded, fresh)
    # every rank starts from rank 0's weights
    mesh.broadcast_module(model, group)

    # ----------------------------------------------------- optimizer
    steps_per_epoch = max(len(ld) for ld in loaders) * len(loaders)
    state = make_train_state(cfg, model, steps_per_epoch)
    ema_cfg = cfg.get("ema", {})
    opt_cfg = cfg.get("optimizer", {})

    # ----------------------------------------------------- train steps
    ema_m = ema_cfg.get("momentum", 0.9998) if ema_cfg.get("enabled") else None
    # clipping happens inside the train step (one global-norm pass shared
    # with the grad_norm metric; engine/steps._finalize)
    clip = opt_cfg.get("grad_clip", None)
    if is_pretrain:
        step = make_pretrain_train_step(model, build_pretrain_loss_config(cfg),
                                        ema_momentum=ema_m, grad_clip_norm=clip, group=group)
    elif task == "retrieval":
        loss_type = cfg.model.get("loss", {})
        step = make_retrieval_train_step(
            model, temperature=loss_type.get("temperature", 0.05),
            cos_sim=loss_type.get("cos_sim", True), ema_momentum=ema_m,
            grad_clip_norm=clip, group=group)
    else:
        step = make_qa_train_step(model, ema_momentum=ema_m, grad_clip_norm=clip, group=group)

    # ----------------------------------------------------- eval
    eval_fn = None
    eval_cfg = cfg.get("evaluation", {})
    if "val" in cfg.data:
        val_ds = build_dataset(cfg.data.val, tokenizer)
        val_loader = build_loader(val_ds, cfg.data.get("val_loader", loader_cfg), test=True,
                                  rank=rank, world_size=world)
        eval_fn = build_eval_fn(cfg, model, val_ds, val_loader, img_size, group)

    ckpt_mgr = CheckpointManager(
        os.path.join(work_dir, "checkpoints"),
        max_to_keep=cfg.get("checkpoint", {}).get("max_to_keep", 3), group=group)

    trainer = Trainer(
        state=state,
        train_steps=[step] * len(loaders),
        train_loaders=loaders,
        batch_to_device=batch_to_device,
        # the dropout generator on the run's device; each step folds in its
        # step count and the rank (engine/steps.fold_in)
        generator=torch.Generator(device=device).manual_seed(args.seed + 1),
        total_epochs=cfg.total_epochs,
        # metrics.jsonl and TensorBoard events from rank 0 only; every rank
        # logs to its own stdout
        work_dir=work_dir if rank == 0 else None,
        log_interval=cfg.get("log_interval", 20),
        eval_fn=eval_fn,
        eval_interval=eval_cfg.get("interval", 1),
        save_best_key=eval_cfg.get("save_best"),
        ckpt_interval=cfg.get("checkpoint", {}).get("interval", 1),
        ckpt_manager=ckpt_mgr,
        ema_eval=ema_cfg.get("eval_with_ema", False),
        tensorboard=args.tb or cfg.get("log_tensorboard", False),
        group=group,
    )
    if args.resume:
        trainer.resume()   # every rank reads the same checkpoint
        mesh.broadcast_module(model, group)
    with trace(args.profile):
        trainer.fit()
    if args.profile:
        logger.info("profiler trace written to %s", args.profile)
    logger.info("training done at step %d", int(trainer.state.step))
    trainer.metrics.close()
    return trainer


if __name__ == "__main__":
    import torch.distributed as dist

    try:
        main(sys.argv[1:])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
