"""K6, the fused window-attention half-block, on one CUDA card at every call
shape of the 32-frame retrieval eval (B=32 clips of 32 x 224^2), of the
32-frame finetune step (B=16, DropPath's row scale) and of the 32-frame
remat pretrain step (P32: its clean and masked passes make the Swin batch
2 x 8 clips, the finetune step's shapes), each stage unshifted and shifted,
and at the 8-frame eval's shapes under ``fused_attn='on'`` (N=196):

    python3 -m clover_tpu_torch.ops.attn_block_sweep

For each shape it checks the public call (``fused_window_attn_block``)
against ``window_attn_block_plain`` with ``chip_smoke.py``'s K6 limit (max
|kernel - plain| <= 2e-2 + 1e-2 max|plain|) and two calls for bitwise
equality, then times with CUDA events the public call, the plain version
and, as a yardstick the port never calls, the same function composed of
PyTorch calls (``F.layer_norm``, ``F.linear``, SDPA with bias + mask as
one bf16 float mask, ``F.linear`` and the residual); with torch.profiler
each kernel one call launches, alone (device ms per call by name); and,
on the same qkv, the attention alone through K11 (flat) and K1. It prints
the bound (``chip_smoke.py``'s ``attn_block_work``: the qkv, attention and
proj products over 989 TFLOP/s bf16, or the bytes over 3.35 TB/s, whichever
is larger), each shape's calls per forward or step and the sums, each
kernel's registers and spills first (nvcc -Xptxas -v) and the card's name
and power limit. Needs a card; the build is ``_build``'s.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from clover_tpu_torch import ops
from clover_tpu_torch.models.swin3d import _shift_region_ids, effective_window
from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops.bwd_sweep import kernel_ms
from clover_tpu_torch.ops.heads_sweep import cuda_ms, ptxas_lines
from clover_tpu_torch.ops.mlp_bwd_sweep import short
from clover_tpu_torch.ops.window_attention import region_mask

SIZE, EMBED = 224, 128
DEPTHS, HEADS = (2, 2, 18, 2), (4, 8, 16, 32)
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
TOL = (2e-2, 1e-2)        # atol, rtol of max|plain|: chip_smoke.py's K6
# (path, clips, frames, window, row scale?, {sum: calls of a block}); a
# P32 step runs K6 once more in each block of stages 0-1 (rematerialised)
PATHS = (("eval32", 32, 32, (8, 7, 7), False, ("eval32",)),
         ("train32", 16, 32, (8, 7, 7), True, ("finetune32", "P32")),
         ("eval8-on", 32, 8, (4, 7, 7), False, ("eval8-on",)))


def call_shapes():
    """(path, stage, Bn, N, C, nH, region ids or None, row scale?, {sum:
    calls}) of K6 on each path."""
    out = []
    for path, clips, frames, window, with_rs, sums in PATHS:
        dims = (frames // 2, SIZE // 4, SIZE // 4)
        for i, (depth, nH) in enumerate(zip(DEPTHS, HEADS)):
            win, sh = effective_window(dims, window, tuple(w // 2 for w in window))
            N = int(np.prod(win))
            Bn = clips * int(np.prod(dims)) // N
            ids = _shift_region_ids(dims, win, sh)
            shifted = depth // 2 if ids is not None else 0
            for mask, n in ((None, depth - shifted), (ids, shifted)):
                if n:
                    calls = {s: n * (2 if s == "P32" and i < 2 else 1) for s in sums}
                    out.append((path, i, Bn, N, EMBED * 2 ** i, nH, mask, with_rs, calls))
            dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
    return out


def bound_ms(Bn, N, C, nH, ids, with_rs):
    """The qkv, attention and proj products; x in, out, the fp32 weights and
    biases, the fp32 bias, the region ids, the row scale."""
    flops = 2 * Bn * N * (4 * C * C + 2 * N * C)
    nbytes = (4 * Bn * N * C + 16 * C * C + 24 * C + 4 * nH * N * N
              + (0 if ids is None else ids.size * 4) + (4 * Bn if with_rs else 0))
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3


def inputs(g, dev, Bn, N, C, nH, ids, with_rs):
    """The public call's arguments: x bf16, fp32 LN1 / qkv / proj parameters
    in torch layout, an fp32 bias, region ids, a row scale (every fourth
    clip's windows 0, the rest 1 / 0.9) or None."""
    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x = randn(Bn * N, C).bfloat16()
    w = (1 + randn(C, std=0.1), randn(C, std=0.1), randn(3 * C, C, std=C ** -0.5),
         randn(3 * C, std=0.1), randn(C, C, std=C ** -0.5), randn(C, std=0.1))
    bias = randn(nH, N, N)
    rid = None if ids is None else torch.from_numpy(ids).to(dev)
    rs = None
    if with_rs:
        per = torch.arange(Bn, device=dev) // (Bn // 16)     # the clip of each window
        rs = torch.where(per % 4 == 1, 0.0, 1 / 0.9)
    return (x, w[0], w[1], w[2], w[3], bias, rid, w[4], w[5], 32 ** -0.5, nH, N, 1e-5, rs)


def composed(args):
    """The half-block from PyTorch calls, bf16 throughout: -> a callable.
    Window b's (mask row, head) pair is a head of a (Bn / nW, nW * nH)
    batch, so one (nW * nH, N, N) float mask broadcasts over it."""
    x, ln_w, ln_b, wqkv, bqkv, bias, rid, wp, bp, scale, nH, N, eps, rs = args
    M, C = x.shape
    nW = 1 if rid is None else rid.shape[0]
    G = M // N // nW
    bf = [t.bfloat16() for t in (ln_w, ln_b, wqkv, bqkv, wp, bp)]
    fm = bias[None] if rid is None else bias[None] + region_mask(rid, torch.float32)[:, None]
    fm = fm.bfloat16().reshape(1, nW * nH, N, N)
    rs_rows = None if rs is None else rs.bfloat16().view(-1, 1, 1)

    def run():
        xn = F.layer_norm(x, (C,), bf[0], bf[1], eps)
        qkv = F.linear(xn, bf[2], bf[3]).view(G, nW, N, 3, nH, 32)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).reshape(3, G, nW * nH, N, 32).unbind(0)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=fm, scale=scale)
        o = o.view(G, nW, nH, N, 32).permute(0, 1, 3, 2, 4).reshape(M, C)
        y = F.linear(o, bf[4], bf[5])
        if rs_rows is not None:
            y = (y.view(-1, N, C) * rs_rows).view(M, C)
        return x + y

    return run


def main(argv=None):
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.library()
    for src in ("attn_block.cu", "window_attention_flash.cu"):
        print("\n".join(f"{src}: {ln}" for ln in ptxas_lines(src)), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    sums = {}
    for path, stage, Bn, N, C, nH, ids, with_rs, calls in call_shapes():
        args = inputs(gen, dev, Bn, N, C, nH, ids, with_rs)
        label = (f"{path} stage {stage} Bn={Bn} N={N} C={C} mask={'yes' if ids is not None else 'no'}"
                 f" row_scale={'yes' if with_rs else 'no'}")
        k = lambda: ops.fused_window_attn_block(*args)   # noqa: E731
        p = lambda: ops.window_attn_block_plain(*args)   # noqa: E731
        got, again = k(), k()
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        ref = p()
        err = (got.float() - ref.float()).abs().max().item()
        lim = TOL[0] + TOL[1] * ref.float().abs().max().item()
        good = err <= lim and bool(torch.isfinite(got).all()) and same
        ok &= good
        print(f"{label}: {' '.join(f'x{n} a {s}' for s, n in calls.items())}; check "
              f"{'OK' if good else 'FAIL'}: max_abs_err {err:.3e} (limit {lim:.3e}), two calls "
              f"bitwise equal {same}", flush=True)
        del got, again, ref
        times = {"K6": cuda_ms(k, 3)}
        kms = kernel_ms(k, 3)
        print(f"{label}: launches alone (device ms per call): "
              + "; ".join(f"{short(n)} {ms:.4f}" for n, ms in kms.items()), flush=True)
        times["plain"] = cuda_ms(p, 2)
        times["composed"] = cuda_ms(composed(args), 3)
        qkv = torch.randn(Bn * N, 3 * C, generator=gen, device=dev).bfloat16()
        bias, rid, scale = args[5], args[6], args[9]
        times["K11 attention"] = cuda_ms(
            lambda: ops.flat_flash_window_attention(qkv, bias, rid, scale, nH, N), 3)
        times["K1 attention"] = cuda_ms(
            lambda: ops.flat2_window_attention(qkv, bias, rid, scale, nH, N), 3)
        times["bound"] = bound_ms(Bn, N, C, nH, ids, with_rs)
        print(f"{label}: ms per call: " + ", ".join(f"{n} {t:.4f}" for n, t in times.items()),
              flush=True)
        for s, n in calls.items():
            acc = sums.setdefault(s, {})
            for name, t in list(times.items()) + [(short(n_), t_) for n_, t_ in kms.items()]:
                acc[name] = acc.get(name, 0.0) + n * t
        del args, qkv
        torch.cuda.empty_cache()
    for s, acc in sums.items():
        print(f"per {s} forward or step (ms): "
              + ", ".join(f"{n} {t:.2f}" for n, t in acc.items()))
    print("all checks passed" if ok else "CHECK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
