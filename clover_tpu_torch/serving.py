"""Serving: the retrieval towers as ``torch.export`` artifacts (port of
``clover_tpu/serving.py``).

Three artifacts a bundle, each a traced graph with a static batch size:

  video_tower_b{B}  (B, T, S, S, 3) uint8 frames -> (B, D) fp32 embedding
                    (the eval preprocess on the device inside, so the
                    serving edge ships raw pixels)
  text_tower_b{B}   (B, L) int64 ids + (B, L) int64 mask -> (B, D) fp32
  similarity        (Nt, D) x (Nv, D) -> (Nt, Nv) t2v scores: both towers
                    L2-normalized, then text @ video.T, the retrieval eval's
                    protocol (``evaluation/metrics.py``)

Design points, as in the JAX package:

- one static batch size an artifact (``batch_sizes``): export one per
  served batch size and pad at the edge;
- the weights and the Swin bias cache are baked in (``bake_params=True``),
  or the weights and the cache are inputs of the artifact
  (``bake_params=False``, through ``torch.func.functional_call``); each
  tower holds only the modules it runs, so the text artifact carries no
  Swin weight;
- ``embed_impl='host_s2d'`` (a loader-side layout) is swapped for the
  on-device ``'s2d'``, with the same GEMM parameters;
- the cache holds each block's bias and the layout its kernel reads
  (``swin_bias_cache``), made before the trace: a graph
  holds them as buffers and lays nothing out per call.

Every kernel of the towers sits in the graph as its registered op
(``torch.ops.clover.*``, ``ops/library.py``): on the card the op launches
the kernel, on the CPU it runs the plain version. A route that reaches a
kernel without an op cannot be traced on the card (the wrapper reads a
data pointer, which a traced tensor has not). ``load_bundle`` needs
``clover_tpu_torch.ops`` (to register the ops) and nothing of the models.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

MANIFEST = "manifest.json"
SUFFIX = ".pt2"


def similarity_fn(text_emb: torch.Tensor, video_emb: torch.Tensor) -> torch.Tensor:
    """t2v score matrix: L2-normalize both sides, text @ video.T."""
    t, v = text_emb.float(), video_emb.float()
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp_min(1e-12)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-12)
    return t @ v.T


class _Similarity(nn.Module):
    def forward(self, text_emb, video_emb):
        return similarity_fn(text_emb, video_emb)


def _part(module: nn.Module, names: Sequence[str]) -> nn.Module:
    """The submodules ``names`` of ``module`` (shared, not copied) and its
    other attributes, in an ``nn.Module`` of their own: ``module``'s
    methods run on it and its state dict holds those submodules only."""
    part = nn.Module()
    for key, val in vars(module).items():
        if not key.startswith("_") and key != "training":
            setattr(part, key, val)
    for name in names:
        setattr(part, name, getattr(module, name))
    return part


class _Buffers(nn.Module):
    """A dict of tensors as buffers (keys with '.' spelled '/')."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        for key, t in tensors.items():
            self.register_buffer(key.replace(".", "/"), t)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {key.replace("/", "."): t for key, t in self.named_buffers()}


class VideoTower(nn.Module):
    """uint8 frames (B, T, S, S, 3) -> (B, D) fp32: the eval preprocess (the
    normalize unless the patch embed folds it), the Swin backbone on the
    bias cache (held here, or passed in as ``bias_cache``) and the head's
    vision projector. Holds ``model.backbone`` and the projector only."""

    def __init__(self, model, image_size: int, bias_cache=None):
        super().__init__()
        self.backbone = model.backbone
        self.ssl_head = _part(model.ssl_head, ("img_fc1", "img_norm1", "img_fc2", "img_norm2"))
        self._vision = type(model.ssl_head).forward_vision
        self.image_size, self.dtype = image_size, model.dtype
        self.scale_pixels = model.config.scale_pixels
        self.cache = None if bias_cache is None else _Buffers(bias_cache)

    def forward(self, frames_u8: torch.Tensor,
                bias_cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        from clover_tpu_torch.ops.preprocess import eval_preprocess

        cache = self.cache.as_dict() if bias_cache is None else bias_cache
        imgs = eval_preprocess(frames_u8, self.image_size, self.dtype,
                               normalize=not self.backbone.cfg.fold_normalize)
        if self.scale_pixels:
            imgs = imgs / 255.0
        feat = self.backbone(imgs.to(self.dtype), cache)
        return self._vision(self.ssl_head, feat).float()


class TextTower(nn.Module):
    """ids and mask (B, L) -> (B, D) fp32: the BERT text tower and the head's
    text projector, and nothing else of the model."""

    def __init__(self, model):
        super().__init__()
        self.text_backbone = model.text_backbone
        self.ssl_head = _part(model.ssl_head, ("text_fc1", "text_norm", "text_fc2"))
        self._text = type(model.ssl_head).forward_text

    def forward(self, token_ids: torch.Tensor, input_mask: torch.Tensor) -> torch.Tensor:
        hidden = self.text_backbone(token_ids, input_mask)
        return self._text(self.ssl_head, hidden, input_mask, token_ids).float()


class _WeightsIn(nn.Module):
    """A tower whose weights (and bias cache) are inputs:
    ``forward(params, *inputs)`` or, for the video tower, ``forward(params,
    bias_cache, frames)`` -> ``functional_call`` of the tower. The tower is
    not a submodule, so the artifact holds none of its weights."""

    def __init__(self, tower: nn.Module, video: bool):
        super().__init__()
        object.__setattr__(self, "_tower", tower)
        self.video = video

    def forward(self, params: Dict[str, torch.Tensor], *inputs):
        if self.video:
            cache, frames = inputs
            return torch.func.functional_call(self._tower, params, (frames, cache))
        return torch.func.functional_call(self._tower, params, inputs)


def _state(params) -> Dict[str, Any]:
    """{port parameter name: tensor} from a port state dict, or from a JAX
    parameter tree, bare or under 'params' (``bridge.state_from_jax``)."""
    nested = isinstance(params, Mapping) and any(isinstance(v, Mapping) for v in params.values())
    if nested:
        from clover_tpu_torch.models.bridge import state_from_jax

        return {k: torch.from_numpy(v) for k, v in state_from_jax(params).items()}
    return {k: torch.as_tensor(v) for k, v in params.items()}


def _serving_model(model, params):
    """The model to export: a copy of ``model``'s structure (on the meta
    device, no memory) holding ``model``'s own tensors, or ``params`` moved
    to its device, with ``embed_impl='host_s2d'`` swapped for 's2d'."""
    cfg = model.config
    if cfg.swin.embed_impl == "host_s2d":
        cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, embed_impl="s2d"))
    device = next(model.parameters()).device
    served = type(model)(cfg, dtype=model.dtype, kernels=model.kernels, device="meta")
    state = model.state_dict()
    if params is not None:
        given = _state(params)
        missing = sorted(k for k, _ in model.named_parameters() if k not in given)
        if missing:
            raise KeyError(f"params lack {len(missing)} parameters of the model: {missing[:5]}")
        state = {**state, **{k: v.to(device, torch.float32) for k, v in given.items()
                             if k in state}}
    served.load_state_dict(state, assign=True)
    return served.eval()


def _user_io(ep) -> Dict[str, Any]:
    """The artifact's user inputs and outputs as [{'shape', 'dtype'}] and
    the device type of its inputs."""
    from torch.export.graph_signature import InputKind, OutputKind

    vals = {n.name: n.meta["val"] for n in ep.graph.nodes if "val" in n.meta}
    sig = ep.graph_signature
    ins = [vals[s.arg.name] for s in sig.input_specs if s.kind == InputKind.USER_INPUT]
    outs = [vals[s.arg.name] for s in sig.output_specs if s.kind == OutputKind.USER_OUTPUT]

    def spec(t):
        return {"shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", "")}

    return {"inputs": [spec(t) for t in ins], "outputs": [spec(t) for t in outs],
            "device": ins[0].device.type}


def export_retrieval_towers(model, params=None, *, batch_sizes: Sequence[int] = (1,),
                            frames: int = 8, image_size: int = 224, text_len: int = 30,
                            sim_candidates: int = 1000, bake_params: bool = True) -> Dict[str, Any]:
    """Export a retrieval ``CloverFinetune``'s serving surface on the
    model's device. -> {name: torch.export.ExportedProgram}; pass it to
    :func:`save_bundle`.

    ``params``: the weights to export, a port state dict or a JAX parameter
    tree (bare or under 'params'); None exports the model's own.
    ``bake_params=False`` makes the weights inputs: the video artifact takes
    (params, bias_cache, frames), the text one (params, ids, mask), params
    keyed by the model's parameter names (each tower's own) and the cache as
    ``swin_bias_cache`` gives it. The similarity
    artifact holds no weight either way."""
    from clover_tpu_torch.models.swin3d import embed_dims, swin_bias_cache

    if model.config.task != "retrieval":
        raise ValueError(f"export_retrieval_towers requires task='retrieval' "
                         f"(got {model.config.task!r})")
    served = _serving_model(model, params)
    swin_cfg = served.config.swin
    device = next(served.parameters()).device
    S = image_size
    cache = swin_bias_cache(served.backbone, swin_cfg, embed_dims(swin_cfg, (frames, S, S)))
    video = VideoTower(served, S, cache if bake_params else None).eval()
    text = TextTower(served).eval()
    with torch.no_grad():
        # one eager forward first: the shift permutations and region ids
        # are device constants made at their first use, which must not be
        # inside the trace
        video(torch.zeros((1, frames, S, S, 3), dtype=torch.uint8, device=device), cache)
    exports = {}
    for B in batch_sizes:
        clips = torch.zeros((B, frames, S, S, 3), dtype=torch.uint8, device=device)
        ids = torch.zeros((B, text_len), dtype=torch.int64, device=device)
        mask = torch.ones((B, text_len), dtype=torch.int64, device=device)
        if bake_params:
            vmod, vargs, tmod, targs = video, (clips,), text, (ids, mask)
        else:
            vmod, tmod = _WeightsIn(video, True), _WeightsIn(text, False)
            vargs = (dict(video.named_parameters()), cache, clips)
            targs = (dict(text.named_parameters()), ids, mask)
        with torch.no_grad():
            exports[f"video_tower_b{B}"] = torch.export.export(vmod, vargs, strict=False)
            exports[f"text_tower_b{B}"] = torch.export.export(tmod, targs, strict=False)
    D = served.config.vts_embed_dim
    # two tensors: one passed twice would be traced as one input
    emb = tuple(torch.zeros((sim_candidates, D), dtype=torch.float32, device=device)
                for _ in range(2))
    exports["similarity"] = torch.export.export(_Similarity(), emb, strict=False)
    return exports


def save_bundle(exports: Dict[str, Any], out_dir: str) -> str:
    """Each ExportedProgram to ``<out_dir>/<name>.pt2`` (``torch.export.save``)
    plus a manifest.json: its user inputs' and outputs' shapes and dtypes
    (with ``bake_params=False`` the weights and the cache come first among
    the inputs), the device type it runs on ('cuda' or 'cpu'), its file's
    bytes and the bytes of the tensors baked into it. -> out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = {}
    for name, ep in exports.items():
        path = os.path.join(out_dir, name + SUFFIX)
        # the trace's example inputs (zeros, 38 MB at B=32 x 8 x 224^2) stay out of the file
        ep = copy.copy(ep)
        ep.example_inputs = None
        torch.export.save(ep, path)
        held = list(ep.state_dict.values()) + [t for t in ep.constants.values()
                                               if isinstance(t, torch.Tensor)]
        manifest[name] = {**_user_io(ep), "nbytes": os.path.getsize(path),
                          "baked_bytes": sum(t.numel() * t.element_size() for t in held)}
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


def load_bundle(bundle_dir: str) -> Dict[str, Any]:
    """Every artifact of a bundle directory -> {name: callable}. Each
    callable runs the loaded graph: no model code, config or checkpoint
    (the weights are baked in, or passed as an input). Imports
    ``clover_tpu_torch.ops`` to register the ops the graphs call, and
    nothing of ``clover_tpu_torch.models``."""
    import clover_tpu_torch.ops  # noqa: F401  (registers torch.ops.clover.*)

    fns: Dict[str, Any] = {}
    for fname in sorted(os.listdir(bundle_dir)):
        if fname.endswith(SUFFIX):
            # served weights take no gradient
            fns[fname[:-len(SUFFIX)]] = torch.export.load(
                os.path.join(bundle_dir, fname)).module().requires_grad_(False)
    return fns
