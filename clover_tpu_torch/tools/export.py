"""Export a retrieval model's towers as a serving bundle (port of
``tools/export.py``).

Writes the ``torch.export`` artifacts of ``clover_tpu_torch/serving.py``
(video tower, text tower, similarity) and their manifest, which a runtime
loads with ``serving.load_bundle`` and no model code, config or checkpoint:

    python -m clover_tpu_torch.tools.export configs/exp/finetune_msrvtt_retrieval.py \\
        --ckpt-dir work/msrvtt/checkpoints --out bundle --batch-sizes 1,8,32

The model is built from the config and restored from ``--ckpt-dir``: each
model child whose parameters the checkpoint holds by name (a finetuned
checkpoint: every child; a converted one, ``tools/convert_checkpoint.py``:
the towers' backbones), every other child at its seeded init (the
projection head of a converted one, which the log says). Without
``--ckpt-dir`` every weight is seeded random. The clip length is the
config's test split's (``test_num_frames``, else ``num_frames``, else 8).
It runs on the card unless ``--cpu`` is given, and raises without one; the
bundle runs on the device it was exported on.

Smoke-load:  python -c "from clover_tpu_torch.serving import load_bundle; \\
                        print(load_bundle('bundle'))"
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description="Export the retrieval towers of a config")
    ap.add_argument("config")
    ap.add_argument("--out", required=True, help="bundle output directory")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (omit: random init, smoke only)")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--batch-sizes", default="1,8",
                    help="comma list; one artifact per batch size")
    ap.add_argument("--frames", type=int, default=None,
                    help="clip length (default: the config's test split "
                         "test_num_frames/num_frames, else 8)")
    ap.add_argument("--text-len", type=int, default=30)
    ap.add_argument("--sim-candidates", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true", help="export for the CPU")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    return ap.parse_args(argv)


def split_frames(cfg) -> int:
    """The clip length of the config's test split (else its val split's):
    ``test_num_frames``, else ``num_frames``, else 8."""
    data = cfg.get("data", {}) or {}
    split = data.get("test", data.get("val", {})) or {}
    return int(split.get("test_num_frames", split.get("num_frames", 8)))


def main(argv: Optional[List[str]] = None):
    """-> (the bundle directory, its manifest)."""
    args = parse_args(argv)
    import json

    import torch

    from clover_tpu_torch.builder import build_model
    from clover_tpu_torch.config import load_config, parse_cfg_options
    from clover_tpu_torch.engine import CheckpointManager, restore_or_init
    from clover_tpu_torch.models import init_params
    from clover_tpu_torch.serving import MANIFEST, export_retrieval_towers, save_bundle
    from clover_tpu_torch.tools.train import pick_device
    from clover_tpu_torch.utils.logging import get_logger

    logger = get_logger()
    cfg = load_config(args.config, overrides=parse_cfg_options(args.cfg_options))
    device = pick_device(args.cpu)
    model, _ = build_model(cfg.model, device=device)
    model.eval()
    seeded = torch.Generator().manual_seed(0)
    if args.ckpt_dir:
        params = CheckpointManager(args.ckpt_dir).restore_params(step=args.step)
        if params is None:
            raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
        loaded, fresh = restore_or_init(model, params, seeded)
        del params
        if not loaded:
            raise SystemExit(f"{args.ckpt_dir}: no model child matches the checkpoint")
        logger.info("restored %s from %s step %s", loaded, args.ckpt_dir, args.step)
        if fresh:
            logger.warning("not in the checkpoint, kept at their seeded init: %s", fresh)
    else:
        init_params(model, seeded)
        logger.warning("no --ckpt-dir: exporting RANDOM weights (smoke only)")

    frames = args.frames or split_frames(cfg)
    exports = export_retrieval_towers(
        model, batch_sizes=[int(b) for b in args.batch_sizes.split(",") if b], frames=frames,
        image_size=cfg.get("img_size", 224), text_len=args.text_len,
        sim_candidates=args.sim_candidates)
    out = save_bundle(exports, args.out)
    with open(os.path.join(out, MANIFEST)) as f:
        manifest = json.load(f)
    total = sum(meta["nbytes"] for meta in manifest.values())
    logger.info("wrote %d artifacts (%.1f MB) for %s to %s", len(manifest), total / 2 ** 20,
                device.type, out)

    def shapes(specs):
        return ", ".join(f"{s['dtype']}{s['shape']}" for s in specs)

    for name, meta in manifest.items():
        logger.info("  %s: %s -> %s, %d bytes (%d baked)", name, shapes(meta["inputs"]),
                    shapes(meta["outputs"]), meta["nbytes"], meta["baked_bytes"])
    return out, manifest


if __name__ == "__main__":
    main(sys.argv[1:])
