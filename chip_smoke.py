#!/usr/bin/env python3
"""Smoke run of clover_tpu_torch's retrieval-eval path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from clover_tpu_torch/csrc (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version at the shapes the
   Swin-B + BERT-base eval forward gives it (B=32 clips of 8 x 224^2,
   L=30), bf16, and time both with CUDA events;
4. drive the port's main path -- make_embed_eval_step + run_retrieval_eval
   over a few batches of seeded random clips and captions, with seeded
   random weights -- and check the per-forward launch counts, finite
   embeddings and the R@K metrics;
5. run the same batches through the plain versions on the card, compare the
   embeddings (cosine per row) and print clips/s of both paths;
6. print the kernel table as one JSON line, then the device line.

Nothing here imports JAX: the JAX package is the reference of the CPU tests.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import numpy as np

B, T, S, L = 32, 8, 224, 30     # bench.py's default eval batch
N_BATCHES = 3
SEED = 0
COS_MIN = 0.99                  # kernel-path vs plain-path embeddings, per row
# kernel vs plain, bf16: max|k - p| <= atol + rtol * max|p|. Both round to
# bf16 (2^-8 relative) at different points -- the kernels keep fp32 where
# the plain versions round (logits, pre-GELU hidden, MLP output) -- so
# disagreements of one to a few bf16 ulps of the largest values are expected.
TOL = {"K1": (2e-2, 1e-2), "K2": (2e-2, 2e-2), "K3": (2e-2, 2e-2), "K4": (1e-2, 1e-2)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def path_shapes(cfg):
    """Per-forward kernel calls of the eval path: {kernel: [(args, count)]}."""
    from clover_tpu_torch.models.swin3d import _shift_region_ids, effective_window

    sw, bt = cfg.swin, cfg.text_bert
    dims = (T // sw.patch_size[0], S // sw.patch_size[1], S // sw.patch_size[2])
    shift = tuple(s // 2 for s in sw.window_size)
    calls = {"K1": [], "K2": [], "K3": [], "K4": []}
    calls["K4"].append(((B * int(np.prod(dims)), sw.embed_dim), 1))          # patch norm
    for i, depth in enumerate(sw.depths):
        C, nH = sw.embed_dim * 2 ** i, sw.num_heads[i]
        rows = B * int(np.prod(dims))
        window, sh = effective_window(dims, sw.window_size, shift)
        N = int(np.prod(window))
        ids = _shift_region_ids(dims, window, sh)
        n_shifted = depth // 2 if ids is not None else 0
        calls["K1"].append(((rows // N, N, nH, None), depth - n_shifted))
        if n_shifted:
            calls["K1"].append(((rows // N, N, nH, ids), n_shifted))
        calls["K2"].append(((rows, C), depth))
        calls["K4"].append(((rows, C), depth))                               # norm1
        if i < len(sw.depths) - 1:
            dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
            calls["K4"].append(((B * int(np.prod(dims)), 4 * C), 1))         # merging
    calls["K4"].append(((B * int(np.prod(dims)), sw.num_features), 1))       # final norm
    calls["K4"].append(((B * L, bt.hidden_size), 1 + bt.num_hidden_layers))  # BERT norms
    calls["K3"].append(((B * L, bt.hidden_size), bt.num_hidden_layers))
    return calls


def kernel_phase(cfg, dev):
    """Each kernel against its plain version at the path's shapes."""
    import torch

    from clover_tpu_torch import ops
    from clover_tpu_torch.models.swin3d import _shift_region_ids

    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    results = {}
    calls = path_shapes(cfg)
    # the region mask at nH=32 too (stage 3 has no shifted block at 8 frames)
    ids_extra = _shift_region_ids((4, 14, 14), (4, 7, 7), (0, 3, 3))[:1]
    calls["K1"].append(((B, 196, 32, ids_extra), 0))

    def record(key, name, label, out, ref, t_k, t_p, count):
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        atol, rtol = TOL[key]
        ok = err <= atol + rtol * scale and bool(torch.isfinite(out).all())
        print(f"{key} {name} {label}: max_abs_err={err:.3e} max|plain|={scale:.3e} "
              f"rel={err / scale:.2e} tol={atol + rtol * scale:.3e} kernel={t_k:.4f} ms "
              f"plain={t_p:.4f} ms x{count}/forward {'OK' if ok else 'FAIL'}")
        r = results.setdefault(key, {"name": name, "err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["err"] = max(r["err"], err)
        r["ms"] += t_k * count
        r["plain_ms"] += t_p * count
        check(ok, f"{key} {label}: kernel disagrees with its plain version")

    for (Bn, N, nH, ids), count in calls["K1"]:
        C = nH * 32
        qkv = randn(Bn * N, 3 * C)
        bias = randn(nH, N, N, dtype=torch.float32)
        rid = None if ids is None else torch.from_numpy(ids).to(dev)
        scale = 32 ** -0.5

        def k():
            return ops.flat2_window_attention(qkv, bias, rid, scale, nH, N)

        def p():
            return ops.window_attention_plain(qkv, bias, rid, scale, nH, N)

        out, ref = k(), p()
        record("K1", "flat2_window_attention", f"Bn={Bn} N={N} nH={nH} "
               f"mask={'yes' if ids is not None else 'no'}", out, ref,
               cuda_ms(k, 5), cuda_ms(p, 5), count)

    def mlp_weights(C, H):
        return (1 + randn(C, std=0.1, dtype=torch.float32), randn(C, std=0.1, dtype=torch.float32),
                randn(H, C, std=C ** -0.5, dtype=torch.float32),
                randn(H, std=0.1, dtype=torch.float32),
                randn(C, H, std=H ** -0.5, dtype=torch.float32),
                randn(C, std=0.1, dtype=torch.float32))

    for (rows, C), count in calls["K2"]:
        x, w = randn(rows, C), mlp_weights(C, 4 * C)
        k = lambda: ops.fused_ln_mlp_residual(x, *w, 1e-5, cfg.swin.gelu)   # noqa: E731
        p = lambda: ops.ln_mlp_residual_plain(x, *w, 1e-5, cfg.swin.gelu)   # noqa: E731
        record("K2", "fused_ln_mlp_residual", f"rows={rows} C={C}", k(), p(),
               cuda_ms(k, 5), cuda_ms(p, 5), count)

    for (rows, C), count in calls["K3"]:
        H = cfg.text_bert.intermediate_size
        x, w = randn(rows, C), mlp_weights(C, H)
        eps = cfg.text_bert.layer_norm_eps
        k = lambda: ops.fused_mlp_postln(x, *w, eps)   # noqa: E731
        p = lambda: ops.mlp_postln_plain(x, *w, eps)   # noqa: E731
        record("K3", "fused_mlp_postln", f"rows={rows} C={C}", k(), p(),
               cuda_ms(k, 20), cuda_ms(p, 20), count)

    for (rows, C), count in calls["K4"]:
        x = randn(rows, C)
        w = 1 + randn(C, std=0.1, dtype=torch.float32)
        b = randn(C, std=0.1, dtype=torch.float32)
        k = lambda: ops.fused_layer_norm(x, w, b, 1e-5)   # noqa: E731
        p = lambda: ops.layer_norm_plain(x, w, b, 1e-5)   # noqa: E731
        record("K4", "fused_layer_norm", f"rows={rows} C={C}", k(), p(),
               cuda_ms(k, 10), cuda_ms(p, 10), count)
    return results


def make_batches(cfg):
    from clover_tpu_torch.ops.preprocess import space_to_depth_host

    rng = np.random.default_rng(SEED)
    batches = []
    for i in range(N_BATCHES):
        frames = rng.integers(0, 256, size=(B, T, S, S, 3), dtype=np.uint8)
        lengths = rng.integers(8, L + 1, size=B)
        tok = rng.integers(1000, cfg.text_bert.vocab_size, size=(B, L))
        tok[:, 0] = 101                                   # [CLS]
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
        batches.append({
            "imgs": space_to_depth_host(frames, cfg.swin.patch_size)[:, None],
            "token_ids": tok * mask, "input_mask": mask,
            "index": np.arange(i * B, (i + 1) * B), "video_index": np.arange(i * B, (i + 1) * B),
        })
    return batches


def drive_main_path(model, cfg, batches):
    """The port's main path, as a user runs it: the eval step through the
    retrieval loop, bias cache built at the first batch. -> R@K metrics."""
    import torch

    from clover_tpu_torch.engine import make_embed_eval_step, run_retrieval_eval
    from clover_tpu_torch.models import swin_bias_cache

    dataset = types.SimpleNamespace(text_video_ids=[[i] for i in range(B * N_BATCHES)])
    metrics = run_retrieval_eval(
        make_embed_eval_step(model), model, dataset, iter(batches),
        bias_cache=lambda m, dims: swin_bias_cache(m.backbone, cfg.swin, dims))
    torch.cuda.synchronize()
    return metrics


def timed_embeddings(model, cfg, batches, dev):
    """The same forwards on batches already on the card, timed with a host
    clock around work that ends in a synchronize. -> (v, t, clips/s)."""
    import torch

    from clover_tpu_torch.engine import make_embed_eval_step
    from clover_tpu_torch.models import swin_bias_cache

    step = make_embed_eval_step(model)
    cache = swin_bias_cache(model.backbone, cfg.swin, batches[0]["imgs"].shape[2:5])
    on_dev = [tuple(torch.as_tensor(b[k]).to(dev) for k in ("imgs", "token_ids", "input_mask"))
              for b in batches]
    torch.cuda.synchronize()
    vs, ts = [], []
    t0 = time.perf_counter()
    for imgs, tok, mask in on_dev:
        v, t = step(imgs, tok, mask, cache)
        vs.append(v)
        ts.append(t)
    torch.cuda.synchronize()
    clips_per_s = B * len(on_dev) / (time.perf_counter() - t0)
    return torch.cat(vs).float(), torch.cat(ts).float(), clips_per_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    try:
        from clover_tpu_torch import ops
        from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig,
                                             SwinConfig, init_params)
        from clover_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a clover_tpu checkout ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0:.1f} s, "
          f"{_build.library_path().name})", flush=True)

    cfg = FinetuneConfig(swin=SwinConfig.base(fold_normalize=True), text_bert=BertConfig())
    results = kernel_phase(cfg, dev)

    model = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=True)
    init_params(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    plain = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=False).to(dev).eval()
    plain.load_state_dict(model.state_dict())
    batches = make_batches(cfg)

    wrappers = {"K1": ops.flat2_window_attention, "K2": ops.fused_ln_mlp_residual,
                "K3": ops.fused_mlp_postln, "K4": ops.fused_layer_norm}
    ops.reset_launch_counts()
    metrics = drive_main_path(model, cfg, batches)
    counts = {k: fn.launches for k, fn in wrappers.items()}
    per_forward = {"K1": 24, "K2": 24, "K3": 12, "K4": 42}
    print(f"launches over {N_BATCHES} forwards: {counts} "
          f"(expected per forward: {per_forward})", flush=True)
    for k, n in per_forward.items():
        check(counts[k] == n * N_BATCHES,
              f"{k}: {counts[k]} launches, expected {n * N_BATCHES}")
    v, t, cps = timed_embeddings(model, cfg, batches, dev)
    check(v.shape == (B * N_BATCHES, cfg.vts_embed_dim) and t.shape == v.shape,
          f"embedding shapes {tuple(v.shape)}, {tuple(t.shape)}")
    check(bool(torch.isfinite(v).all() and torch.isfinite(t).all()), "non-finite embedding")
    check(set(metrics) >= {"Recall@1", "Recall@5", "Recall@10", "MR"}, f"metrics {metrics}")
    print(f"kernel path R@K: {metrics}", flush=True)

    ops.reset_launch_counts()
    p_metrics = drive_main_path(plain, cfg, batches)
    pv, pt, p_cps = timed_embeddings(plain, cfg, batches, dev)
    check(all(fn.launches == 0 for fn in ops.KERNELS), "the plain path launched a kernel")
    cos_v = torch.nn.functional.cosine_similarity(v, pv, dim=-1).min().item()
    cos_t = torch.nn.functional.cosine_similarity(t, pt, dim=-1).min().item()
    print(f"plain path R@K: {p_metrics}")
    print(f"kernel vs plain embeddings: min cosine video {cos_v:.6f} text {cos_t:.6f} "
          f"(bound {COS_MIN})")
    check(cos_v >= COS_MIN and cos_t >= COS_MIN,
          f"kernel path disagrees with the plain path: min cosine video {cos_v:.6f} "
          f"text {cos_t:.6f}, bound {COS_MIN}")
    print(f"clips/s (B={B}, {T}x{S}^2, L={L}, {N_BATCHES} batches, forward only): "
          f"kernels {cps:.2f} plain {p_cps:.2f} on {card}", flush=True)

    sources = {"K1": ("csrc/window_attention.cu", "clover_tpu/ops/window_attention.py:1274"),
               "K2": ("csrc/mlp_block.cu", "clover_tpu/ops/mlp_block.py:565"),
               "K3": ("csrc/mlp_block.cu", "clover_tpu/ops/mlp_block.py:245"),
               "K4": ("csrc/layer_norm.cu", "clover_tpu/ops/layer_norm.py:64")}
    table = [{"name": results[k]["name"], "route": "cuda",
              "source": "clover_tpu_torch/" + sources[k][0], "replaces": sources[k][1],
              "launches": counts[k], "max_abs_err": results[k]["err"],
              "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
             for k in ("K1", "K2", "K3", "K4")]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
