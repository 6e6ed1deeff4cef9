"""Config -> object builders (port of ``clover_tpu/builder.py``).

The reference wires everything through mmcv registries + type strings
(models/builder.py:8-86, datasets/builder.py). Here a small explicit
factory covers the same config-driven polymorphism with typed dataclass
configs underneath.

The port's dataclasses have fields and defaults of their own. The builder
gives everything a config leaves unsaid its JAX meaning:

- ``swin.embed_impl``: 'conv', the JAX default (the raw clip in; the port's
  dataclass defaults to 'host_s2d');
- ``swin.mlp_stash``: off where ``swin.use_checkpoint`` is set (the JAX
  builder sets ``CLOVER_MLP_STASH=0`` for remat recipes), else on;
- ``fused_attn``, ``long_attn``, ``mlp_bwd`` and ``text_bert.fused_mlp_train``
  keep the port's defaults, which are the JAX environment defaults;
- the dtype comes from ``DTYPES``.

A JAX option the port does not run raises (``swin.act_sharding``, sequence
parallelism, Queue 1 item 5; a pretrain or loss switch turned off, which no
config does).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from clover_tpu_torch.config import Config
from clover_tpu_torch.data.datasets import (
    ActionVideoDataset,
    MCRetrievalDataset,
    VideoQADataset,
    VideoTextDataset,
    make_synthetic_retrieval_dataset,
)
from clover_tpu_torch.data.loader import DataLoader
from clover_tpu_torch.data.tokenization import BertTokenizer, build_test_vocab
from clover_tpu_torch.losses.objectives import PretrainLossConfig
from clover_tpu_torch.models import (
    BertConfig,
    CloverFinetune,
    CloverPretrain,
    FinetuneConfig,
    FusionConfig,
    PretrainConfig,
    SwinConfig,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

SWIN_VARIANTS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "large": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}

# the JAX PretrainConfig's switches the port's model keeps on (every config does)
_PRETRAIN_FIXED = dict(text_agg_type="cls", use_mlm=True, use_cmask=True, symmetry_rank=True,
                       scale_pixels=False)


def _filter_fields(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: _tuplify(v) for k, v in d.items() if k in names}


def _tuplify(v):
    return tuple(v) if isinstance(v, list) else v


def build_swin_config(cfg: Dict[str, Any]) -> SwinConfig:
    cfg = dict(cfg)
    variant = cfg.pop("variant", None)
    base = dict(SWIN_VARIANTS[variant]) if variant else {}
    base.update(cfg)
    if base.get("act_sharding") is not None:
        raise ValueError("swin.act_sharding (sequence parallelism) is not ported: "
                         "ROADMAP.md Queue 1 item 5")
    fields = _filter_fields(SwinConfig, base)
    fields.setdefault("embed_impl", "conv")
    fields.setdefault("mlp_stash", not fields.get("use_checkpoint", False))
    return SwinConfig(**fields)


def build_bert_config(cfg: Optional[Dict[str, Any]] = None) -> BertConfig:
    return BertConfig(**_filter_fields(BertConfig, dict(cfg or {})))


def build_fusion_config(cfg: Dict[str, Any], text_bert: BertConfig) -> FusionConfig:
    cfg = dict(cfg)
    n_layers = cfg.pop("num_hidden_layers", 3)
    bert = dataclasses.replace(text_bert, num_hidden_layers=n_layers)
    fields = _filter_fields(FusionConfig, cfg)
    fields.pop("bert", None)
    return FusionConfig(bert=bert, **fields)


def build_model(model_cfg: Dict[str, Any], device="cuda"):
    """-> (the port's model on ``device``, its dataclass config). The model
    is built on the card unless ``device='cpu'``; its weights are zeros and
    ones until ``init_params`` or a checkpoint fills them."""
    cfg = dict(model_cfg)
    mtype = cfg.pop("type")
    dtype = DTYPES[cfg.pop("dtype", "bfloat16")]
    swin = build_swin_config(cfg.pop("swin", {}))
    text_bert = build_bert_config(cfg.pop("text_bert", {}))
    fusion = build_fusion_config(cfg.pop("fusion", {}), text_bert)

    if mtype == "CloverPretrain":
        for key, want in _PRETRAIN_FIXED.items():
            if cfg.get(key, want) != want:
                raise ValueError(f"CloverPretrain {key}={cfg[key]!r} is not ported "
                                 f"(the port runs {want!r})")
        mc = PretrainConfig(swin=swin, text_bert=text_bert, fusion=fusion,
                            **_filter_fields(PretrainConfig, cfg))
        return CloverPretrain(mc, dtype=dtype, device=device), mc
    if mtype == "CloverFinetune":
        mc = FinetuneConfig(swin=swin, text_bert=text_bert, fusion=fusion,
                            **_filter_fields(FinetuneConfig, cfg))
        return CloverFinetune(mc, dtype=dtype, device=device), mc
    raise ValueError(f"unknown model type {mtype!r}")


def build_tokenizer(cfg: Optional[Dict[str, Any]]) -> BertTokenizer:
    """The Python WordPiece tokenizer. ``native=True`` asks the JAX package
    for its C++ tokenizer where that library builds, else for this one; the
    port has no native tokenizer yet (ROADMAP.md), so it is this one."""
    cfg = dict(cfg or {})
    if cfg.get("vocab_file"):
        return BertTokenizer.from_vocab_file(
            cfg["vocab_file"], lower_case=cfg.get("lower_case", True))
    if cfg.get("synthetic", False):
        words = cfg.get("words") or (
            "a the person dog cat runs jumps sits eats red blue fast slow "
            "ball park street man woman child plays walks big small happy"
        ).split()
        return BertTokenizer(build_test_vocab(words))
    raise ValueError("tokenizer config needs vocab_file or synthetic=True")


def build_dataset(ds_cfg: Dict[str, Any], tokenizer: Optional[BertTokenizer]):
    cfg = dict(ds_cfg)
    dtype_ = cfg.pop("type")
    if dtype_ == "SyntheticRetrievalDataset":
        return make_synthetic_retrieval_dataset(**cfg)
    if dtype_ == "VideoTextDataset":
        return VideoTextDataset(tokenizer=tokenizer, **cfg)
    if dtype_ == "VideoQADataset":
        return VideoQADataset(tokenizer=tokenizer, **cfg)
    if dtype_ == "MCRetrievalDataset":
        return MCRetrievalDataset(tokenizer=tokenizer, **cfg)
    if dtype_ == "ActionVideoDataset":
        names_file = cfg.pop("class_names_file", None)
        if names_file and not cfg.get("class_names"):
            with open(names_file) as f:
                # UCF101 classInd.txt style: "1 ApplyEyeMakeup" or bare names
                cfg["class_names"] = [
                    line.split(maxsplit=1)[-1].strip()
                    for line in f if line.strip()
                ]
        return ActionVideoDataset(tokenizer=tokenizer, **cfg)
    raise ValueError(f"unknown dataset type {dtype_!r}")


def build_loader(dataset, loader_cfg: Dict[str, Any], test: bool = False,
                 seed: int = 0) -> DataLoader:
    cfg = dict(loader_cfg)
    return DataLoader(
        dataset,
        batch_size=cfg.get("batch_size", 8),
        shuffle=not test,
        num_workers=cfg.get("num_workers", 4),
        drop_last=not test,
        seed=seed,
        prefetch=cfg.get("prefetch", 2),
        worker_type=cfg.get("worker_type", "thread"),
        host_s2d=cfg.get("host_s2d"),
    )


def build_pretrain_loss_config(cfg: Config) -> PretrainLossConfig:
    model = cfg.get("model", {})
    ssl = model.get("ssl_loss", {})
    switches = dict(use_rank=ssl.get("use_rank", True),
                    use_rank_ttm=ssl.get("use_rank_ttm", True),
                    symmetry_rank=model.get("symmetry_rank", True),
                    use_mlm=model.get("use_mlm", True))
    off = [k for k, v in switches.items() if not v]
    if off:
        raise ValueError(f"pretrain loss switches {off} off are not ported "
                         "(the port's pretrain losses keep every term)")
    return PretrainLossConfig(
        nce_temperature=ssl.get("temperature", 0.05),
        margin_ttm=ssl.get("margin_ttm", 5.0),
        mlm_focal_gamma=model.get("mlm_loss", {}).get("gamma", 2.0),
    )
