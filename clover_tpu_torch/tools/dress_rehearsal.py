"""Dress rehearsal of real-weight conversion into the port, end to end, at
the production shapes with synthetic weights (port of
``tools/dress_rehearsal.py``).

Real Clover weights are a Kinetics-pretrained image or video Swin-B and HF
``bert-base-uncased``. This rehearses the whole path with seeded weights in
their published key schemas:

  1. a seeded image-Swin-B state dict in the official 2D key schema (4x4
     patch embed, 169-row relative-position bias tables,
     ``layers.{i}.{blocks,downsample}``, made with torch) and a BERT-base
     state dict in HF's ``BertForPreTraining`` key schema (plain tensors:
     ``transformers`` is not needed) -> two .pth files;
  2. ``clover_tpu_torch.tools.convert_checkpoint --swin --inflate-2d
     --bert`` -> a port checkpoint at step 0 (the 2D -> 3D inflation: the
     patch embed repeated over time and divided, the bias tables tiled);
  3. the gate: the converted patch embed (the space-to-depth Dense) against
     ``torch.nn.Conv3d`` with the reference's inflation on one clip;
  4. ``configs/exp/rehearsal_retrieval_fullsize.py`` built, its
     ``load_from`` the converted checkpoint (the backbone and the text
     backbone merged);
  5. the towers exported (``serving.export_retrieval_towers``) at a batch
     of ``BATCH``, saved, loaded back and run on one seeded batch, held
     against the eager model (max abs gap at most ``SERVE_GAP_MAX``).

The parity gates against HF's own modules (the text tower, the MLM head)
need ``transformers`` and stay with the JAX package's tool. With real
weights only the two source files change. Run:

    python -m clover_tpu_torch.tools.dress_rehearsal --work DIR [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "exp", "rehearsal_retrieval_fullsize.py")
PATCH_EMBED_TOL = 1e-5
BATCH = 2              # the exported and served batch
SERVE_GAP_MAX = 1e-3   # served against eager embeddings, max abs (the same ops: ~0 expected)


def synth_swin2d_state_dict(embed: int = 128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32),
                            window: int = 7, seed: int = 0):
    """A seeded image-Swin state dict in the official 2D key schema;
    swin_base_patch4_window7_224 by default (embed 128, depths 2/2/18/2,
    heads 4/8/16/32, window 7: 169-row bias tables)."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    E, rows, tokens = embed, (2 * window - 1) ** 2, window * window
    sd = {"patch_embed.proj.weight": t(E, 3, 4, 4), "patch_embed.proj.bias": t(E),
          "patch_embed.norm.weight": torch.ones(E), "patch_embed.norm.bias": torch.zeros(E)}
    for i, d in enumerate(depths):
        C, nH = E * 2 ** i, heads[i]
        for j in range(d):
            p = f"layers.{i}.blocks.{j}"
            sd.update({
                f"{p}.norm1.weight": torch.ones(C), f"{p}.norm1.bias": torch.zeros(C),
                f"{p}.attn.qkv.weight": t(3 * C, C), f"{p}.attn.qkv.bias": t(3 * C),
                f"{p}.attn.proj.weight": t(C, C), f"{p}.attn.proj.bias": t(C),
                f"{p}.attn.relative_position_bias_table": t(rows, nH),
                # dropped by the converter
                f"{p}.attn.relative_position_index": torch.zeros(tokens, tokens,
                                                                 dtype=torch.long),
                f"{p}.norm2.weight": torch.ones(C), f"{p}.norm2.bias": torch.zeros(C),
                f"{p}.mlp.fc1.weight": t(4 * C, C), f"{p}.mlp.fc1.bias": t(4 * C),
                f"{p}.mlp.fc2.weight": t(C, 4 * C), f"{p}.mlp.fc2.bias": t(C)})
        if i < len(depths) - 1:
            sd[f"layers.{i}.downsample.norm.weight"] = torch.ones(4 * C)
            sd[f"layers.{i}.downsample.norm.bias"] = torch.zeros(4 * C)
            sd[f"layers.{i}.downsample.reduction.weight"] = t(2 * C, 4 * C)
    F = E * 2 ** (len(depths) - 1)
    sd["norm.weight"], sd["norm.bias"] = torch.ones(F), torch.zeros(F)
    return sd


def synth_hf_bert_state_dict(hidden: int = 768, layers: int = 12, intermediate: int = 3072,
                             vocab: int = 30522, max_positions: int = 512,
                             type_vocab: int = 2, seed: int = 1):
    """A seeded state dict in HF ``BertForPreTraining``'s key schema
    (bert-base-uncased by default): ``bert.embeddings``, ``bert.encoder``,
    ``bert.pooler``, the MLM head ``cls.predictions`` with its decoder tied
    to the word embeddings, and ``cls.seq_relationship``."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    H, I = hidden, intermediate

    def norm(prefix):
        return {f"{prefix}.weight": torch.ones(H), f"{prefix}.bias": torch.zeros(H)}

    def dense(prefix, out, inp):
        return {f"{prefix}.weight": t(out, inp), f"{prefix}.bias": t(out)}

    words = t(vocab, H)
    sd = {"bert.embeddings.word_embeddings.weight": words,
          "bert.embeddings.position_embeddings.weight": t(max_positions, H),
          "bert.embeddings.token_type_embeddings.weight": t(type_vocab, H),
          **norm("bert.embeddings.LayerNorm")}
    for i in range(layers):
        p = f"bert.encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            sd.update(dense(f"{p}.attention.self.{proj}", H, H))
        sd.update({**dense(f"{p}.attention.output.dense", H, H),
                   **norm(f"{p}.attention.output.LayerNorm"),
                   **dense(f"{p}.intermediate.dense", I, H), **dense(f"{p}.output.dense", H, I),
                   **norm(f"{p}.output.LayerNorm")})
    sd.update({**dense("bert.pooler.dense", H, H),
               **dense("cls.predictions.transform.dense", H, H),
               **norm("cls.predictions.transform.LayerNorm"),
               "cls.predictions.bias": torch.zeros(vocab),
               "cls.predictions.decoder.weight": words,
               **dense("cls.seq_relationship", 2, H)})
    return sd


def write_sources(work: str, swin_sd=None, bert_sd=None):
    """The two source checkpoints as .pth files in ``work`` (the Swin under
    'model', as timm releases it). -> (swin path, bert path, swin dict)."""
    import torch

    os.makedirs(work, exist_ok=True)
    swin_sd = synth_swin2d_state_dict() if swin_sd is None else swin_sd
    bert_sd = synth_hf_bert_state_dict() if bert_sd is None else bert_sd
    swin_pth = os.path.join(work, "swin_base_patch4_window7_2d.pth")
    bert_pth = os.path.join(work, "bert_base_uncased.pth")
    torch.save({"model": swin_sd}, swin_pth)
    torch.save(bert_sd, bert_pth)
    return swin_pth, bert_pth, swin_sd


def convert_sources(work: str, swin_pth: str, bert_pth: str, depths=(2, 2, 18, 2),
                    bert_layers: int = 12, fusion_layers: int = 3) -> str:
    """convert_checkpoint on the two files (with the 2D inflation) -> the
    converted checkpoint directory."""
    from clover_tpu_torch.tools import convert_checkpoint

    out = os.path.join(work, "converted")
    convert_checkpoint.main(["--swin", swin_pth, "--inflate-2d", "--bert", bert_pth,
                             "--depths", *map(str, depths), "--bert-layers", str(bert_layers),
                             "--fusion-layers", str(fusion_layers), "--out", out])
    return out


def check_patch_embed(swin2d_sd, converted) -> float:
    """The converted patch embed (the Dense on the space-to-depth clip)
    against ``torch.nn.Conv3d`` with the reference's inflation (the 2D
    kernel repeated over 2 frames, divided by 2) on one seeded clip. ->
    max abs error (raises above ``PATCH_EMBED_TOL``)."""
    import torch

    from clover_tpu_torch.models.swin3d import space_to_depth

    w2d = swin2d_sd["patch_embed.proj.weight"].float()       # (E, 3, 4, 4)
    conv = torch.nn.Conv3d(3, w2d.shape[0], (2, 4, 4), stride=(2, 4, 4))
    clip = torch.randn(1, 3, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        conv.weight.copy_(w2d.unsqueeze(2).repeat(1, 1, 2, 1, 1) / 2.0)
        conv.bias.copy_(swin2d_sd["patch_embed.proj.bias"])
        ref = conv(clip).permute(0, 2, 3, 4, 1)
        cols = space_to_depth(clip.permute(0, 2, 3, 4, 1), (2, 4, 4))
        kernel = torch.as_tensor(converted["backbone.patch_embed.proj.weight"])
        out = cols @ kernel + torch.as_tensor(converted["backbone.patch_embed.proj.bias"])
    err = float((out - ref).abs().max())
    if not err < PATCH_EMBED_TOL:
        raise AssertionError(f"patch embed max abs err {err} (limit {PATCH_EMBED_TOL})")
    return err


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description="Rehearse real-weight conversion into the port")
    ap.add_argument("--work", required=True, help="directory for the files it writes")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """-> the rehearsal's readings (patch-embed error, the served batch's
    max gap to the eager model, export seconds, bundle bytes, the merged
    children, the converted checkpoint's directory). Raises where a gate
    fails."""
    args = parse_args(argv)
    import torch

    from clover_tpu_torch.builder import build_model
    from clover_tpu_torch.config import load_config
    from clover_tpu_torch.engine import CheckpointManager, restore_or_init
    from clover_tpu_torch.models.swin3d import embed_dims, swin_bias_cache
    from clover_tpu_torch.ops.preprocess import eval_preprocess
    from clover_tpu_torch.serving import export_retrieval_towers, load_bundle, save_bundle
    from clover_tpu_torch.tools.train import pick_device

    t0 = time.perf_counter()
    device = pick_device(args.cpu)
    swin_pth, bert_pth, swin_sd = write_sources(args.work)
    print(f"[1/5] wrote the true-shape .pth files ({time.perf_counter() - t0:.1f} s)")
    out_dir = convert_sources(args.work, swin_pth, bert_pth)
    print(f"[2/5] converted -> {out_dir} ({time.perf_counter() - t0:.1f} s)")
    converted = CheckpointManager(out_dir).restore_params()
    err = check_patch_embed(swin_sd, converted)
    print(f"[3/5] patch embed against Conv3d: max abs err {err:.2e}")

    # the config computes in fp32 for the CPU; the card's kernels take bf16
    cfg = load_config(CONFIG, overrides={"load_from": out_dir, "model.dtype":
                                         "float32" if device.type == "cpu" else "bfloat16"})
    model, _ = build_model(cfg.model, device=device)
    loaded, fresh = restore_or_init(model, CheckpointManager(cfg.load_from).restore_params(),
                                    torch.Generator().manual_seed(0))
    if "backbone" not in loaded or "text_backbone" not in loaded:
        raise AssertionError(f"load_from merged {loaded} (fresh {fresh})")
    model.eval()
    print(f"[4/5] load_from merged {loaded}; fresh {fresh}")

    B, T, S, L = BATCH, 8, cfg.get("img_size", 224), 30
    t1 = time.perf_counter()
    bundle = save_bundle(export_retrieval_towers(model, batch_sizes=(B,), frames=T, image_size=S,
                                                 text_len=L, sim_candidates=B),
                         os.path.join(args.work, "bundle"))
    export_s = time.perf_counter() - t1
    fns = load_bundle(bundle)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)).to(device)
    ids = torch.from_numpy(rng.integers(1000, 30000, (B, L))).to(device)
    mask = torch.ones((B, L), dtype=torch.int64, device=device)
    with torch.inference_mode():
        got_v, got_t = fns[f"video_tower_b{B}"](frames), fns[f"text_tower_b{B}"](ids, mask)
        imgs = eval_preprocess(frames, S, model.dtype)
        cache = swin_bias_cache(model.backbone, model.config.swin,
                                embed_dims(model.config.swin, (T, S, S)))
        want_v = model.forward_video(imgs[:, None], cache).float()
        want_t = model.forward_text(ids, mask).float()
    gap = max(float((got_v - want_v).abs().max()), float((got_t - want_t).abs().max()))
    nbytes = sum(os.path.getsize(os.path.join(bundle, f)) for f in os.listdir(bundle))
    print(f"[5/5] served batch of {B} against the eager model: max abs gap {gap:.3e} (limit "
          f"{SERVE_GAP_MAX}); export {export_s:.1f} s, bundle {nbytes} bytes "
          f"({time.perf_counter() - t0:.1f} s)")
    if not (torch.isfinite(got_v).all() and torch.isfinite(got_t).all()):
        raise AssertionError("the served towers gave a non-finite embedding")
    if not gap <= SERVE_GAP_MAX:
        raise AssertionError(f"the served towers differ from the eager model: max abs gap {gap} "
                             f"(limit {SERVE_GAP_MAX})")
    return {"patch_embed_err": err, "gap": gap, "export_s": export_s, "bundle_bytes": nbytes,
            "loaded": loaded, "converted": out_dir}


if __name__ == "__main__":
    main(sys.argv[1:])
