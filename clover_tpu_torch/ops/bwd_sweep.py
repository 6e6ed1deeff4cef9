"""K5, the window-attention backward, on one CUDA card at every call shape
of the 12-frame and 32-frame finetune steps and of the 8-frame pretrain
step (B=16 clips of 224^2 each: the pretrain step's clean and masked passes
make its Swin batch 2 x 8), each stage unshifted and shifted:

    python3 -m clover_tpu_torch.ops.bwd_sweep

For each shape it checks the public call against its plain version (dqkv
within (2e-2, 2e-2), dbias within (0, 1e-5) of max|plain|, both over
max|plain|), then times with CUDA events the public call and SDPA's
backward on the same q, k, v with the bias as a float mask that requires
grad (as ``chip_smoke.py`` times it), and with torch.profiler each kernel
the call launches, alone (ms per call by kernel name). It prints the
bound (bytes over 3.35 TB/s or five N x N x 32 products over 989 TFLOP/s
bf16, whichever is larger), the grid the wrapper picks, each shape's
calls per train step and their sum, each kernel's registers and spills
first (nvcc -Xptxas -v) and the card's name and power limit. Needs a card;
the build is ``_build``'s.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from clover_tpu_torch.models.swin3d import _shift_region_ids, effective_window
from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops import window_attention as wa
from clover_tpu_torch.ops.heads_sweep import cuda_ms, ptxas_lines

CLIPS, SIZE = 16, 224
PATHS = {"12f": 12, "32f": 32, "pretrain": 8}   # frames; Swin-B, patch (2, 4, 4)
DEPTHS, HEADS, WINDOW = (2, 2, 18, 2), (4, 8, 16, 32), (8, 7, 7)
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
TOL = {"dqkv": (2e-2, 2e-2), "dbias": (0.0, 1e-5)}


def kernel_ms(fn, reps=5):
    """Device time per call of each kernel ``fn`` launches: {name: ms}."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            out[evt.name] = out.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3 / reps
    return out


def _short(name):
    """A kernel's name without its namespace and arguments."""
    return name.split("::")[-1].split("(")[0]


def launch_ms(fn, reps=5):
    """K5's launches alone in one call of ``fn``: {kernel: ms per call}."""
    return {_short(name): ms for name, ms in kernel_ms(fn, reps).items() if "wa_bwd_" in name}


def step_shapes(frames):
    """(stage, Bn, N, nH, region ids or None, calls per train step) of K5
    in a train step of CLIPS clips at ``frames`` frames."""
    dims = (frames // 2, SIZE // 4, SIZE // 4)
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
    """Five N x N x 32 products per (window, head); qkv and g in, dqkv out,
    the bf16 bias in and the fp32 dbias out once, the region ids."""
    C = nH * 32
    flops = 5 * 2 * Bn * nH * N * N * 32
    nbytes = Bn * N * 7 * C * 2 + nH * N * N * 6 + (0 if ids is None else ids.size * 4)
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3


def sdpa_bwd_ms(qkv, bias, grad, nH, N, scale):
    Bn = qkv.shape[0] // N
    q, k, v = qkv.view(Bn, N, 3, nH, 32).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
    q, k, v, mask = (t.detach().requires_grad_() for t in (q, k, v, bias.to(qkv.dtype)[None]))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    g = grad.view(Bn, N, nH, 32).permute(0, 2, 1, 3)
    return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v, mask), g, retain_graph=True), 3)


def rel_err(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def main():
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.library()
    print("\n".join(ptxas_lines("window_attention_bwd.cu")))
    g = torch.Generator(device=dev).manual_seed(0)
    scale = 32 ** -0.5
    sms = _build.sms(dev)
    ok = True
    for path, frames in PATHS.items():
        step = {"K5": 0.0, "SDPA": 0.0, "bound": 0.0}
        for stage, Bn, N, nH, ids, count in step_shapes(frames):
            C = nH * 32
            qkv = torch.randn(Bn * N, 3 * C, generator=g, device=dev).bfloat16()
            grad = torch.randn(Bn * N, C, generator=g, device=dev).bfloat16()
            bias = torch.randn(nH, N, N, generator=g, device=dev)
            rid = None if ids is None else torch.from_numpy(ids).to(dev)
            label = f"{path} stage {stage} Bn={Bn} N={N} nH={nH} mask={ids is not None}"

            def call():
                return wa.flat2_window_attention_bwd(qkv, bias, rid, grad, scale, nH, N)

            (dqkv, dbias), (rdqkv, rdbias) = call(), wa.window_attention_bwd_plain(
                qkv, bias, rid, grad, scale, nH, N)
            errs = {"dqkv": rel_err(dqkv, rdqkv), "dbias": rel_err(dbias, rdbias)}
            for part, e in errs.items():
                atol, rtol = TOL[part]
                lim = atol / rdqkv.float().abs().max().item() + rtol if part == "dqkv" else rtol
                ok &= e <= lim
            del dqkv, dbias, rdqkv, rdbias
            t = cuda_ms(call)
            lib = sdpa_bwd_ms(qkv, bias, grad, nH, N, scale)
            bound = bound_ms(Bn, N, nH, ids)
            grid = wa._bwd_grid(Bn, nH, N, sms)
            print(f"{label}: x{count} a step; rel err dqkv {errs['dqkv']:.3e} dbias "
                  f"{errs['dbias']:.3e}; call {t:.4f} ms, SDPA backward {lib:.4f}, bound "
                  f"{bound:.4f}; {grid}", flush=True)
            kms = kernel_ms(call)
            k5 = {_short(n): ms for n, ms in kms.items() if "wa_bwd_" in n}
            other = sum(ms for n, ms in kms.items() if "wa_bwd_" not in n)
            print(f"{label}: launches alone (device ms per call): "
                  + "; ".join(f"{n} {ms:.4f}" for n, ms in k5.items())
                  + f"; the wrapper's PyTorch ops {other:.4f}", flush=True)
            for n, ms in k5.items():
                key = n.split("<")[0]
                step[key] = step.get(key, 0.0) + count * ms
            step["K5"] += count * t
            step["SDPA"] += count * lib
            step["bound"] += count * bound
            del qkv, grad, bias
            torch.cuda.empty_cache()
        print(f"{path} per train step (ms): "
              + ", ".join(f"{n} {ms:.2f}" for n, ms in step.items()), flush=True)
    print("all checks passed" if ok else "CHECK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
