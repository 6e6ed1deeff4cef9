"""K4 (``ops.fused_layer_norm``) on one CUDA card at every call shape of the
eval routes:

    python3 -m clover_tpu_torch.ops.ln_sweep

Routes (Swin-B + BERT-base, L=30): eval8 (B=32 clips of 8 x 224^2; E8H and
E8S make the same calls), E8P (B=4 clips of 8 x 256^2), eval32 (B=32 x 32
frames, LN1 inside K6) and E32L (32 frames, ``fused_attn='off'``: LN1 on
K4). At each (rows, C) it checks the public call against its plain version
(max |kernel - plain| <= 1e-2 + 1e-2 max |plain|, as ``chip_smoke.py``),
then times: the launch alone (the public call queued behind a sleep on the
card, so the host's time does not show), the public call back to back
(CUDA events), the host's time per public call (the wall time of 200
back-to-back calls, before the card is waited for), ``F.layer_norm`` on the
same input (bf16 weight and bias) back to back and queued behind a sleep,
the bound (4 rows C + 8 C bytes over 3.35 TB/s) and the launch's share of
it; then each route's sums per forward. It uses only the public call, so
the same file times any checkout's K4. Needs a card; the build is
``_build``'s.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from clover_tpu_torch import ops
from clover_tpu_torch.models.swin3d import effective_window, fused_attn_enabled
from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops.heads_sweep import cuda_ms, queued_ms

PEAK_BYTES = 3.35e12
# route: clips, frames, clip size, SwinConfig.fused_attn
ROUTES = {"eval8": (32, 8, 224, "auto"), "E8P": (4, 8, 256, "auto"),
          "eval32": (32, 32, 224, "auto"), "E32L": (32, 32, 224, "off")}
EMBED, DEPTHS, PATCH, WINDOW = 128, (2, 2, 18, 2), (2, 4, 4), (8, 7, 7)
TEXT_LEN, BERT_WIDTH, BERT_LAYERS = 30, 768, 12


def k4_shapes(clips, frames, size, fused_attn):
    """K4's ((rows, C), calls) in one eval forward of Swin-B + BERT-base:
    the patch norm, LN1 of each block that does not run K6, the merging
    norms, the final norm, BERT's embedding and attention-output norms."""
    dims = (frames // PATCH[0], size // PATCH[1], size // PATCH[2])
    calls = {(clips * int(np.prod(dims)), EMBED): 1}
    for i, depth in enumerate(DEPTHS):
        C, rows = EMBED * 2 ** i, clips * int(np.prod(dims))
        if not fused_attn_enabled(fused_attn, int(np.prod(effective_window(dims, WINDOW)))):
            calls[(rows, C)] = calls.get((rows, C), 0) + depth
        if i < len(DEPTHS) - 1:
            dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
            key = (clips * int(np.prod(dims)), 4 * C)
            calls[key] = calls.get(key, 0) + 1
    key = (clips * int(np.prod(dims)), EMBED * 2 ** (len(DEPTHS) - 1))
    calls[key] = calls.get(key, 0) + 1
    calls[(clips * TEXT_LEN, BERT_WIDTH)] = 1 + BERT_LAYERS
    return list(calls.items())


def host_ms(fn, reps=200):
    """The host's wall time per call of ``fn`` over ``reps`` back-to-back
    calls, taken before the card is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    measured = {}
    ok = True
    for route, spec in ROUTES.items():
        sums = np.zeros(6)
        print(f"{route}: rows x C, calls a forward; ms a call: launch alone, public call, host "
              f"time, F.layer_norm (back to back, alone), bound (bytes), share of the bound",
              flush=True)
        for (rows, C), calls in k4_shapes(*spec):
            if (rows, C) not in measured:
                x = torch.randn(rows, C, generator=g, device=dev).bfloat16()
                w = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
                b = 0.1 * torch.randn(C, generator=g, device=dev)
                wb, bb = w.bfloat16(), b.bfloat16()
                k = lambda: ops.fused_layer_norm(x, w, b, 1e-5)   # noqa: E731
                lib = lambda: F.layer_norm(x, (C,), wb, bb, 1e-5)   # noqa: E731
                ref = ops.layer_norm_plain(x, w, b, 1e-5).float()
                err = (k().float() - ref).abs().max().item()
                good = err <= 1e-2 + 1e-2 * ref.abs().max().item()
                ok &= good
                measured[(rows, C)] = (
                    err, good, queued_ms(k, 20), cuda_ms(k, 20), host_ms(k), cuda_ms(lib, 20),
                    queued_ms(lib, 20), (4 * rows * C + 8 * C) / PEAK_BYTES * 1e3)
                del x, w, b, wb, bb, ref
            err, good, alone, call, host, lib, lib_alone, bound = measured[(rows, C)]
            sums += calls * np.array([alone, call, host, lib, lib_alone, bound])
            print(f"  {rows:>8} x {C:<5} x{calls:<3} err={err:.3e} {'OK' if good else 'FAIL'} "
                  f"alone={alone:.4f} call={call:.4f} host={host:.4f} F.layer_norm={lib:.4f} "
                  f"F.layer_norm alone={lib_alone:.4f} bound={bound:.4f} "
                  f"share={bound / alone:.3f}", flush=True)
        print(f"{route} per forward (ms): alone={sums[0]:.4f} call={sums[1]:.4f} "
              f"host={sums[2]:.4f} F.layer_norm={sums[3]:.4f} F.layer_norm alone={sums[4]:.4f} "
              f"bound={sums[5]:.4f} share={sums[5] / sums[0]:.3f} on {card}", flush=True)
        torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("K4 disagrees with its plain version")


if __name__ == "__main__":
    main()
