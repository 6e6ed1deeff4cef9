"""K9 and K10 on one CUDA card at the stage shapes of the 8-frame eval
(B=32 clips of 224^2) and of the padded 256^2 eval (B=4 clips), each stage
unshifted and shifted, then K1 at every call shape of the eval and train
paths:

    python3 -m clover_tpu_torch.ops.heads_sweep [--only K9|K1]

K1 (``k1_main``): at each call shape of the 8-frame eval (B=32), the
pretrain and P8E steps (16 clips of 8 frames), the 12-frame finetune and the
32-frame finetune / P32 (16 clips; K6's recompute), unshifted and shifted,
the public call against its plain version, then times: the plan's launch
alone (queued behind a sleep on the card, so host time does not show), the
public call on the model's terms laid out before ("terms", as the eval
cache's) and, on the train paths, on the terms gathered from the table in
the same call ("gathered", as a train step runs it), the public call with
the wrapper's layout ("call") (CUDA events), and SDPA on the same q, k, v
with the bias as a bf16 float mask; then the sums per eval forward or train
step. It prints K1's registers and spills first.

K9 / K10 (``main``): for each shape it checks the public call against its plain version (and,
with a bias of magnitude ~10 and a mask of arbitrary fp32 values, once
more), then times with CUDA events: the public call with the terms laid
out by the wrapper ("call") and with the terms laid out before, as the
model passes its cached forms ("cached"), the layout of the terms alone,
the kernel alone at 1, 2, 4, 8 and 16 windows a block (the wrapper's choice
marked), one SDPA call with bias + mask as one bf16 float mask, and K1 on
the same q, k, v with the mask as region ids (the bf16 bias). It prints each
kernel's registers and spills first (nvcc -Xptxas -v) and the card's name
and power limit. Needs a card; the build is ``_build``'s.
"""

from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from clover_tpu_torch.models.swin3d import (_shift_region_ids, bias_from_table, effective_window,
                                            k1_terms_from_table, shift_attn_mask, table_ext)
from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops import window_attention as wa

PATHS = {"E8": (32, 224), "E8P": (4, 256)}   # clips, clip size; 8 frames, Swin-B
HEADS, WINDOW, PER = (4, 8, 16, 32), (8, 7, 7), (1, 2, 4, 8, 16)


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps=10):
    """Device time per call of ``fn`` with its launches queued behind a
    sleep on the card, so that the host's time to launch does not show
    (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(30_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_lines(source):
    """Each kernel's registers and spills in ``csrc/<source>`` (nvcc -Xptxas -v)."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                               str(Path(tmp) / "k.o"), str(_build.CSRC / source)],
                              capture_output=True, text=True, check=True)
    return [ln.split(":", 1)[-1].strip() for ln in proc.stderr.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def stage_shapes(clips, size):
    """(stage, padded dims, window, shift or None, heads) of the 8-frame eval."""
    dims = (4, size // 4, size // 4)
    out = []
    for i, nH in enumerate(HEADS):
        window, sh = effective_window(dims, WINDOW, tuple(w // 2 for w in WINDOW))
        padded = tuple(-(-d // w) * w for d, w in zip(dims, window))
        out.append((i, padded, window, None, nH))
        if any(sh):
            out.append((i, padded, window, sh, nH))
        dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
    return out


def err(a, b):
    return (a.float() - b.float()).abs().max().item()


def main():
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.library()
    print("\n".join(ptxas_lines("window_attention_heads.cu")))
    g = torch.Generator(device=dev).manual_seed(0)
    scale = 32 ** -0.5
    sms = _build.sms(dev)
    for path, (clips, size) in PATHS.items():
        for stage, padded, window, shift, nH in stage_shapes(clips, size):
            N = int(np.prod(window))
            kt = wa.key_tiles(N)
            grid = tuple(p // w for p, w in zip(padded, window))
            Bn = clips * int(np.prod(grid))
            qkv5 = torch.randn(clips, *padded, 3, nH, 32, generator=g, device=dev).bfloat16()
            q, k, v = (t.contiguous() for t in wa.spatial_heads(qkv5, window))
            bias = torch.randn(nH, N, N, generator=g, device=dev)
            mask = None if shift is None else torch.from_numpy(
                shift_attn_mask(padded, window, shift)).to(dev)
            mgrid = None if mask is None else mask.view(*grid, N, N)
            label = f"{path} stage {stage} Bn={Bn} N={N} nH={nH} mask={mask is not None}"
            e9 = err(wa.fused_window_attention(q, k, v, bias, mask, scale),
                     wa.window_attention_heads_plain(q, k, v, bias, mask, scale))
            e10 = err(wa.spatial_window_attention(qkv5, bias, mgrid, window, scale),
                      wa.spatial_window_attention_plain(qkv5, bias, mgrid, window, scale))
            wild_b = bias * 10
            wild_m = None if mask is None else torch.randn(mask.shape, generator=g, device=dev) * 10
            ew = err(wa.fused_window_attention(q, k, v, wild_b, wild_m, scale),
                     wa.window_attention_heads_plain(q, k, v, wild_b, wild_m, scale))
            print(f"{label}: max err K9 {e9:.3e} K10 {e10:.3e} K9 wild terms {ew:.3e}")
            terms = (wa.bias_terms(bias, N), None if mask is None else wa.mask_terms(mask, N))
            nW = 1 if mask is None else mask.shape[0]
            out9, out10 = torch.empty_like(q), torch.empty(clips, *padded, nH, 32, device=dev,
                                                           dtype=torch.bfloat16)

            def k9(per):
                _build.launch("clover_window_attention_heads", q, k, v, *terms, out9, Bn, N, nH,
                              nW, kt, per, scale, _build.stream(dev))

            def k10(per):
                _build.launch("clover_window_attention_spatial", qkv5, *terms, out10, clips,
                              *padded, *window, nH, kt, per, scale, _build.stream(dev))

            chosen = wa.windows_per_block(Bn, nH, sms)
            t9 = {p: cuda_ms(lambda: k9(p)) for p in PER}
            t10 = {p: cuda_ms(lambda: k10(p)) for p in PER}
            fm = bias[None] if mask is None else bias[None] + mask[:, None]
            fm = fm.bfloat16().reshape(1, nW * nH, N, N)
            q4, k4, v4 = (t.view(Bn // nW, nW * nH, N, 32) for t in (q, k, v))
            ids = _shift_region_ids(padded, window, shift) if shift else None
            rid = None if ids is None else torch.from_numpy(ids).to(dev)
            qkv2 = wa._grid_windows(qkv5, window).reshape(Bn * N, 3 * nH * 32).contiguous()
            times = {
                "K9 call": cuda_ms(lambda: wa.fused_window_attention(q, k, v, bias, mask, scale)),
                "K10 call": cuda_ms(lambda: wa.spatial_window_attention(qkv5, bias, mgrid, window,
                                                                        scale)),
                "K9 cached": cuda_ms(lambda: wa.fused_window_attention(q, k, v, bias, mask, scale,
                                                                       terms)),
                "K10 cached": cuda_ms(lambda: wa.spatial_window_attention(
                    qkv5, bias, mgrid, window, scale, terms)),
                "terms": cuda_ms(lambda: (wa.bias_terms(bias, N), None if mask is None
                                          else wa.mask_terms(mask, N))),
                "SDPA": cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=fm,
                                                                       scale=scale)),
                "K1": cuda_ms(lambda: wa.flat2_window_attention(qkv2, bias, rid, scale, nH, N)),
            }
            print(f"{label}: " + " ".join(f"{n}={t:.4f}" for n, t in times.items()))
            mark = {p: "*" if p == chosen else "" for p in PER}
            print(f"{label}: kernel alone by windows a block (* the wrapper's): K9 "
                  + " ".join(f"{p}{mark[p]}:{t:.4f}" for p, t in t9.items()) + " | K10 "
                  + " ".join(f"{p}{mark[p]}:{t:.4f}" for p, t in t10.items()))
            del qkv5, q, k, v, qkv2, out9, out10, terms
            torch.cuda.empty_cache()
    # the 32-frame window (N=392, 25 key tiles) and N=147, checks only
    for dims, window, shift, nH in (((16, 56, 56), (8, 7, 7), (4, 3, 3), 4),
                                    ((16, 14, 14), (8, 7, 7), None, 32),
                                    ((3, 14, 14), (3, 7, 7), (0, 3, 3), 2)):
        N = int(np.prod(window))
        grid = tuple(d // w for d, w in zip(dims, window))
        qkv5 = torch.randn(1, *dims, 3, nH, 32, generator=g, device=dev).bfloat16()
        q, k, v = (t.contiguous() for t in wa.spatial_heads(qkv5, window))
        bias = torch.randn(nH, N, N, generator=g, device=dev) * 10
        mask = None if shift is None else torch.randn(int(np.prod(grid)), N, N, generator=g,
                                                      device=dev) * 10
        mgrid = None if mask is None else mask.view(*grid, N, N)
        e9 = err(wa.fused_window_attention(q, k, v, bias, mask, scale),
                 wa.window_attention_heads_plain(q, k, v, bias, mask, scale))
        e10 = err(wa.spatial_window_attention(qkv5, bias, mgrid, window, scale),
                  wa.spatial_window_attention_plain(qkv5, bias, mgrid, window, scale))
        print(f"dims {dims} N={N} nH={nH} wild terms: max err K9 {e9:.3e} K10 {e10:.3e}")


# K1's paths: clips, frames, K1 calls per block (P8E recomputes every block)
K1_PATHS = {"eval8": (32, 8, 1), "pretrain": (16, 8, 1), "P8E": (16, 8, 2),
            "finetune12": (16, 12, 1), "finetune32/P32": (16, 32, 1)}
DEPTHS = (2, 2, 18, 2)


def k1_shapes(clips, frames):
    """(stage, Bn, window, nH, region ids or None, blocks) of K1 in one forward."""
    dims = (frames // 2, 56, 56)
    out = []
    for i, (depth, nH) in enumerate(zip(DEPTHS, HEADS)):
        window, sh = effective_window(dims, WINDOW, tuple(w // 2 for w in WINDOW))
        N = int(np.prod(window))
        Bn = clips * int(np.prod(dims)) // N
        ids = _shift_region_ids(dims, window, sh)
        shifted = depth // 2 if ids is not None else 0
        out.append((i, Bn, window, nH, None, depth - shifted))
        if shifted:
            out.append((i, Bn, window, nH, ids, shifted))
        dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
    return out


def k1_main():
    dev = torch.device("cuda", 0)
    print("\n".join(ptxas_lines("window_attention.cu")))
    g = torch.Generator(device=dev).manual_seed(1)
    scale = 32 ** -0.5
    sms = _build.sms(dev)
    for path, (clips, frames, per_block) in K1_PATHS.items():
        sums = {}
        for stage, Bn, window, nH, ids, blocks in k1_shapes(clips, frames):
            calls, N = blocks * per_block, int(np.prod(window))
            qkv = torch.randn(Bn * N, 3 * nH * 32, generator=g, device=dev).bfloat16()
            table = torch.randn(int(np.prod([2 * w - 1 for w in WINDOW])), nH, generator=g,
                                device=dev)
            bias, ext = bias_from_table(table, WINDOW, window, nH), table_ext(table)
            rid = None if ids is None else torch.from_numpy(ids).to(dev)
            nW = 1 if ids is None else ids.shape[0]
            bias_c = bias.bfloat16()
            terms = wa.fragment_bias(bias_c, N, wa.key_tiles(N))
            label = f"{path} stage {stage} Bn={Bn} N={N} nH={nH} mask={ids is not None} x{calls}"
            got = wa.flat2_window_attention(qkv, bias_c, rid, scale, nH, N, terms)
            e = err(got, wa.window_attention_plain(qkv, bias_c, rid, scale, nH, N))
            plan = wa.k1_grid(Bn, nH, N, sms, nW)
            out = torch.empty_like(got)
            q4, k4, v4 = qkv.view(Bn, N, 3, nH, 32).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
            times = {
                "alone": queued_ms(lambda: wa.k1_launch(qkv, terms, rid, out, plan, scale,
                                                        nH, N)),
                "terms": cuda_ms(lambda: wa.flat2_window_attention(qkv, bias_c, rid, scale, nH,
                                                                   N, terms)),
                "call": cuda_ms(lambda: wa.flat2_window_attention(qkv, bias, rid, scale, nH, N)),
                "SDPA": cuda_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=bias_c[None], scale=scale)),
            }
            if path != "eval8":
                if not torch.equal(k1_terms_from_table(table, WINDOW, window, ext), terms):
                    raise RuntimeError(f"{label}: the table's gather differs from the layout")
                times["gathered"] = cuda_ms(lambda: wa.flat2_window_attention(
                    qkv, bias, rid, scale, nH, N, k1_terms_from_table(table, WINDOW, window, ext)))
            for n, t in times.items():
                sums[n] = sums.get(n, 0.0) + t * calls
            print(f"{label}: max err {e:.3e} plan per={plan.per} min_blocks={plan.min_blocks} "
                  f"blocks={plan.blocks} smem={plan.smem}; "
                  + " ".join(f"{n}={t:.4f}" for n, t in times.items()), flush=True)
            del qkv, q4, k4, v4, out, got
            torch.cuda.empty_cache()
        print(f"{path}: ms per {'forward' if path == 'eval8' else 'step'}: "
              + " ".join(f"{n}={t:.3f}" for n, t in sums.items()), flush=True)


if __name__ == "__main__":
    import sys

    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else None
    if only in (None, "K9"):
        main()
    if only in (None, "K1"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
        k1_main()
