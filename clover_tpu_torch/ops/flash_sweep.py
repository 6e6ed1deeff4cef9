"""K11, the key-tiled window attention, on one CUDA card at every call shape
of the 32-frame eval forward on its long-window route (E32L: B=32 clips of
32 x 224^2, Swin-B, every stage's 8 x 7 x 7 window, N=392), each stage
unshifted and shifted:

    python3 -m clover_tpu_torch.ops.flash_sweep

For each shape it checks both public calls (the flat qkv,
``flat_flash_window_attention``, and head-major q, k, v,
``flash_window_attention``) against their plain version (max|kernel -
plain| <= 2e-2 + 1e-2 max|plain|, ``chip_smoke.py``'s ``TOL["K11"]``) and
against each other (bitwise: one kernel template), then times with CUDA
events each public call, one SDPA call on the same q, k, v with bias +
region mask as one float mask (as ``chip_smoke.py`` times it), and K1 on
the same qkv; and with torch.profiler the K11 launch alone (device ms per
call). It prints the bound (bytes over 3.35 TB/s or two N x N x 32
products over 989 TFLOP/s bf16, whichever is larger), each shape's calls
per forward and the sums per forward, each kernel's registers and spills
first (nvcc -Xptxas -v) and the card's name and power limit. Needs a
card; the build is ``_build``'s.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from clover_tpu_torch.models.swin3d import _shift_region_ids, effective_window
from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops import window_attention as wa
from clover_tpu_torch.ops.bwd_sweep import kernel_ms
from clover_tpu_torch.ops.heads_sweep import cuda_ms, ptxas_lines

CLIPS, FRAMES, SIZE = 32, 32, 224
DEPTHS, HEADS, WINDOW = (2, 2, 18, 2), (4, 8, 16, 32), (8, 7, 7)
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
TOL = (2e-2, 1e-2)   # atol, rtol of max|plain|


def forward_shapes():
    """(stage, Bn, N, nH, region ids or None, calls per forward) of K11 in
    the E32L forward."""
    dims = (FRAMES // 2, SIZE // 4, SIZE // 4)
    out = []
    for i, (depth, nH) in enumerate(zip(DEPTHS, HEADS)):
        window, sh = effective_window(dims, WINDOW, tuple(w // 2 for w in WINDOW))
        N = int(np.prod(window))
        Bn = CLIPS * int(np.prod(dims)) // N
        ids = _shift_region_ids(dims, window, sh)
        shifted = depth // 2 if ids is not None else 0
        out.append((i, Bn, N, nH, None, depth - shifted))
        if shifted:
            out.append((i, Bn, N, nH, ids, shifted))
        dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
    return out


def bound_ms(Bn, N, nH, ids):
    """Two N x N x 32 products per (window, head); qkv in and out once, the
    bf16 bias, the region ids."""
    C = nH * 32
    flops = 2 * 2 * Bn * nH * N * N * 32
    nbytes = Bn * N * 4 * C * 2 + nH * N * N * 2 + (0 if ids is None else ids.size * 4)
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3


def sdpa_ms(q, k, v, bias, mask, scale):
    """One SDPA call with bias + mask as one bf16 float mask: window b's
    (nW, nH) pair is a head of a (Bn / nW, nW * nH) batch."""
    Bn, nH, N, hd = q.shape
    nW = 1 if mask is None else mask.shape[0]
    fm = bias[None] if mask is None else bias[None] + mask[:, None]
    fm = fm.to(q.dtype).reshape(1, nW * nH, N, N)
    q4, k4, v4 = (t.view(Bn // nW, nW * nH, N, hd) for t in (q, k, v))
    return cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=fm, scale=scale))


def main():
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.library()
    print("\n".join(ptxas_lines("window_attention_flash.cu")))
    g = torch.Generator(device=dev).manual_seed(0)
    scale = 32 ** -0.5
    ok = True
    fwd = dict.fromkeys(("K11", "K11h", "K11 alone", "K11h alone", "SDPA", "K1", "bound"), 0.0)
    for stage, Bn, N, nH, ids, count in forward_shapes():
        C = nH * 32
        qkv = torch.randn(Bn * N, 3 * C, generator=g, device=dev).bfloat16()
        q, k, v = wa.heads_from_flat(qkv, nH, N)
        bias = torch.randn(nH, N, N, generator=g, device=dev)
        rid = None if ids is None else torch.from_numpy(ids).to(dev)
        label = f"stage {stage} Bn={Bn} N={N} nH={nH} mask={ids is not None}"

        def flat():
            return wa.flat_flash_window_attention(qkv, bias, rid, scale, nH, N)

        def heads():
            return wa.flash_window_attention(q, k, v, bias, rid, scale)

        ref = wa.window_attention_flat_flash_plain(qkv, bias, rid, scale, nH, N)
        got, got_h = flat(), wa.flat_from_heads(heads())
        lim = TOL[0] + TOL[1] * ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        same = torch.equal(got, got_h)
        ok &= err <= lim and same
        del ref, got, got_h
        mask = None if rid is None else wa.region_mask(rid, torch.float32)
        times = {"K11": cuda_ms(flat), "K11h": cuda_ms(heads),
                 "K11 alone": sum(ms for n, ms in kernel_ms(flat).items() if "flash" in n),
                 "K11h alone": sum(ms for n, ms in kernel_ms(heads).items() if "flash" in n),
                 "SDPA": sdpa_ms(q, k, v, bias.bfloat16().float(), mask, scale),
                 "K1": cuda_ms(lambda: wa.flat2_window_attention(qkv, bias, rid, scale, nH, N)),
                 "bound": bound_ms(Bn, N, nH, ids)}
        print(f"{label}: x{count} a forward; max err {err:.3e} (limit {lim:.3e}), flat == "
              f"heads {same}; ms per call: "
              + ", ".join(f"{n} {t:.4f}" for n, t in times.items()), flush=True)
        for n, t in times.items():
            fwd[n] += count * t
        del qkv, q, k, v, bias
        torch.cuda.empty_cache()
    print("E32L per forward (ms): " + ", ".join(f"{n} {t:.3f}" for n, t in fwd.items()))
    print("all checks passed" if ok else "CHECK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
