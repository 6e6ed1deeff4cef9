"""Evaluation entry point (port of ``tools/test.py``; reference tools/test.py).

    python -m clover_tpu_torch.tools.test configs/exp/debug_retrieval_synthetic.py \
        --ckpt-dir /tmp/run1/checkpoints [--step N | --all-steps] [--cpu]

Evaluates one checkpoint (the latest, or ``--step``), or every one with
``--all-steps``, on the config's test split (``data.test``, else
``data.val``) and prints one JSON metrics line per checkpoint. Without
``--ckpt-dir`` the seeded random weights are evaluated; ``--load-from``
warm-starts them from a checkpoint directory (top-level children that
match by name and shape). Every ``eval_mode`` of the JAX entry: dual-tower
retrieval (the default for pretrain and retrieval models),
'mc_retrieval', 'itm_retrieval', 'zeroshot_action', and the QA accuracy
for QA / FIB models. It runs on the card unless ``--cpu`` is given, and
raises without one.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Evaluate a clover_tpu_torch model")
    p.add_argument("config")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (omit for random init)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--load-from", default=None,
                   help="weights-only checkpoint dir; top-level children that match by "
                        "name and shape are loaded, the rest keep fresh init "
                        "(reference load_from semantics)")
    p.add_argument("--all-steps", action="store_true",
                   help="sweep every checkpoint in --ckpt-dir (reference "
                        "inference_pytorch_multi_checkpoints)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """-> the metrics dict printed (a list of them with ``--all-steps``)."""
    args = parse_args(argv)
    import torch

    from clover_tpu_torch.builder import build_dataset, build_loader, build_model, build_tokenizer
    from clover_tpu_torch.config import load_config, parse_cfg_options
    from clover_tpu_torch.engine import CheckpointManager, load_params, merge_pretrained_params
    from clover_tpu_torch.models import init_params
    from clover_tpu_torch.tools.train import build_eval_fn, check_single_device, pick_device
    from clover_tpu_torch.utils.logging import get_logger

    logger = get_logger()
    cfg = load_config(args.config, overrides=parse_cfg_options(args.cfg_options))
    check_single_device(cfg)
    device = pick_device(args.cpu)
    tok_cfg = cfg.get("tokenizer")
    tokenizer = build_tokenizer(tok_cfg) if tok_cfg else None
    test_cfg = cfg.data.get("test", cfg.data.get("val"))
    test_ds = build_dataset(test_cfg, tokenizer)
    model, _ = build_model(cfg.model, device=device)
    init_params(model, torch.Generator().manual_seed(0))
    model.eval()
    img_size = cfg.get("img_size", 224)
    swin = model.config.swin

    loader_cfg = dict(cfg.data.get("test_loader",
                                   cfg.data.get("val_loader", {"batch_size": 8})))
    if swin.embed_impl == "host_s2d":
        # the loader delivers space-to-depth'd frames (make_s2d_collate);
        # requires the dataset's canonical size == img_size (identity crop)
        if not swin.fold_normalize:
            raise SystemExit(
                "embed_impl='host_s2d' delivers raw pixel frames; set "
                "model.swin.fold_normalize=True so the mean/std affine "
                "folds into the patch embed")
        loader_cfg.setdefault("host_s2d", swin.patch_size)
    loader = build_loader(test_ds, loader_cfg, test=True)

    # every run builds the bias cache from the weights loaded then
    run_eval = functools.partial(build_eval_fn(cfg, model, test_ds, loader, img_size), model)

    if args.load_from:
        # converted / pretrain checkpoint: merge matching top-level children
        pretrained = CheckpointManager(args.load_from).restore_params()
        if pretrained is None:
            raise SystemExit(f"--load-from: no checkpoint in {args.load_from}")
        _, loaded, fresh = merge_pretrained_params(model, pretrained)
        logger.info("load_from %s: loaded %s; fresh %s", args.load_from, loaded, fresh)

    if args.ckpt_dir and args.all_steps:
        # checkpoint-directory sweep (reference tools/test.py:169-224)
        mgr = CheckpointManager(args.ckpt_dir)
        steps = mgr.all_steps()
        if not steps:
            raise SystemExit(f"no checkpoints found in {args.ckpt_dir}")
        out = []
        for step in steps:
            load_params(model, mgr.restore_params(step=step))
            metrics = run_eval()
            print(json.dumps({"step": step, **metrics}), flush=True)
            out.append({"step": step, **metrics})
        return out

    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        params = mgr.restore_params(step=args.step)
        if params is None:
            raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
        load_params(model, params)
        logger.info("restored params from %s step %s", args.ckpt_dir,
                    args.step or mgr.latest_step())
    metrics = run_eval()
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
