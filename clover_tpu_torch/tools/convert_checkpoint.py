"""Convert pretrained torch / HuggingFace checkpoints into a port checkpoint
(port of ``tools/convert_checkpoint.py``: the reference's init-time weight
surgery as an offline tool).

Sources:
  --swin path.pth        Video-Swin 3D torch checkpoint (a state dict, or one
                         under 'state_dict' or 'model'); --inflate-2d for an
                         image Swin
  --bert path            HF BertModel / BertForPreTraining / BertForMaskedLM
                         state dict (a local .bin / .pth file)
Output:
  --out DIR              a checkpoint directory at step 0 in the
                         CheckpointManager layout (step_0000000000/state.pt,
                         meta_0000000000.json) holding the parameters of
                         ``backbone``, ``text_backbone``,
                         ``multimodal_backbone`` and ``mlm_head`` under the
                         port's names; a config's ``load_from`` merges it
                         (each model child whose names all match)

    python -m clover_tpu_torch.tools.convert_checkpoint \\
        --swin swin_base_patch244_window877_kinetics400_22k.pth \\
        --bert bert-base-uncased/pytorch_model.bin \\
        --depths 2 2 18 2 --fusion-layers 3 --out ckpts/clover_init

Inputs are read with ``torch.load(..., weights_only=True)``; a file that
pickles more than tensors and containers is read without it, with a note.
"""

from __future__ import annotations

import argparse
import pickle
import sys
from typing import Dict, List, Optional

import numpy as np


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """{name: numpy array} of the tensors of a torch checkpoint file (its
    'state_dict' or 'model' entry where it has one)."""
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        print(f"{path}: holds more than tensors; loading it with weights_only=False",
              file=sys.stderr)
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy()
            for k, v in obj.items() if isinstance(v, torch.Tensor)}


def convert(swin=None, bert=None, inflate_2d: bool = False, depths=(2, 2, 18, 2),
            temporal_patch: int = 2, temporal_window: int = 8, bert_layers: int = 12,
            fusion_layers: int = 3) -> Dict[str, np.ndarray]:
    """The converted parameters of the given state dicts ({name: array}),
    under the model's child names."""
    from clover_tpu_torch.models.convert import (
        convert_fusion_from_hf,
        convert_hf_bert,
        convert_mlm_head,
        convert_swin3d,
        inflate_swin2d,
    )

    def under(child, params):
        return {f"{child}.{k}": v for k, v in params.items()}

    out: Dict[str, np.ndarray] = {}
    if swin is not None:
        if inflate_2d:
            swin = inflate_swin2d(swin, temporal_patch, temporal_window)
        out.update(under("backbone", convert_swin3d(swin, tuple(depths))))
    if bert is not None:
        prefixed = any(k.startswith("bert.") for k in bert)
        # the BertForPreTraining / MaskedLM 'bert.' prefix off for the text tower
        bare = {(k[5:] if k.startswith("bert.") else k): v for k, v in bert.items()}
        out.update(under("text_backbone", convert_hf_bert(bare, bert_layers)))
        out.update(under("multimodal_backbone", convert_fusion_from_hf(
            bert if prefixed else {f"bert.{k}": v for k, v in bert.items()}, fusion_layers)))
        if any(k.startswith("cls.predictions") for k in bert):
            out.update(under("mlm_head", convert_mlm_head(bert)))
    return out


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description="Convert torch / HF checkpoints for the port")
    ap.add_argument("--swin", default=None)
    ap.add_argument("--inflate-2d", action="store_true",
                    help="source is an image Swin; inflate temporally")
    ap.add_argument("--bert", default=None)
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 2, 18, 2])
    ap.add_argument("--temporal-patch", type=int, default=2)
    ap.add_argument("--temporal-window", type=int, default=8)
    ap.add_argument("--bert-layers", type=int, default=12)
    ap.add_argument("--fusion-layers", type=int, default=3)
    ap.add_argument("--out", required=True)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> str:
    """-> the written step directory."""
    args = parse_args(argv)
    import torch

    from clover_tpu_torch.engine.checkpoint import CheckpointManager

    swin = load_torch_state_dict(args.swin) if args.swin else None
    bert = load_torch_state_dict(args.bert) if args.bert else None
    if swin is None and bert is None:
        raise SystemExit("nothing to convert: pass --swin and/or --bert")
    params = convert(swin, bert, args.inflate_2d, args.depths, args.temporal_patch,
                     args.temporal_window, args.bert_layers, args.fusion_layers)
    children = sorted({k.split(".", 1)[0] for k in params})
    path = CheckpointManager(args.out).save_params(
        {k: torch.from_numpy(v) for k, v in params.items()},
        meta={"source_swin": args.swin, "source_bert": args.bert, "children": children})
    print(f"converted {children} ({len(params)} tensors) -> {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
