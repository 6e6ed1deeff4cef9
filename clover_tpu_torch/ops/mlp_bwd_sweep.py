"""K7, the recompute backward of the Swin MLP half, on one CUDA card at the
four call shapes of the 32-frame pretrain step under the remat recipe (P32:
the clean and masked passes make its Swin batch 2 x 8 clips of 32 x 224^2),
with and without the DropPath row scale:

    python3 -m clover_tpu_torch.ops.mlp_bwd_sweep [--gelu tanh|erf]

For each shape it checks the public call (``ln_mlp_residual_bwd_onepass``)
against the plain recompute (``chip_smoke.py``'s limits: dx within (2e-2,
2e-2) of max|plain|; each fp32 output's error against the plain version run
in fp32 at most 1.5 x the bf16 plain version's + 1e-6 of max|reference|,
cosine with the plain one >= 0.9999; two calls bitwise equal), then times
with CUDA events the public call and the plain recompute, and with
torch.profiler each kernel one call launches, alone (device ms per call by name; a kernel
that is not the port's is flagged). It prints the bound (10 rows C H flops
over 989 TFLOP/s bf16, or the bytes over 3.35 TB/s, whichever is larger),
the plan, each shape's calls per P32 step and the sums per step, each
kernel's registers and spills first (nvcc -Xptxas -v) and the card's name
and power limit. Needs a card; the build is ``_build``'s.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops import mlp_block as mb
from clover_tpu_torch.ops.bwd_sweep import kernel_ms
from clover_tpu_torch.ops.heads_sweep import cuda_ms, ptxas_lines

CLIPS, FRAMES, SIZE, EMBED = 16, 32, 224, 128
DEPTHS = (2, 2, 18, 2)
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
DX_TOL = (2e-2, 2e-2)                      # atol, rtol of max|plain|
ERR_RATIO, ERR_FLOOR, COS_MIN = 1.5, 1e-6, 0.9999
NAMES = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2", "drs")


def step_calls():
    """(rows, C, row scale?, calls per P32 step): every Swin block's MLP
    backward; block 0 (DropPath rate 0) runs without the row scale."""
    out = []
    tokens = FRAMES // 2 * (SIZE // 4) ** 2
    for i, depth in enumerate(DEPTHS):
        rows, C = CLIPS * tokens // 4 ** i, EMBED * 2 ** i
        if i == 0:
            out.append((rows, C, False, 1))
        out.append((rows, C, True, depth - (i == 0)))
    return out


def bound_ms(rows, C, H, with_rs):
    """10 rows C H flops; x and g in, dx out (bf16), the fp32 weights in and
    parameter gradients out, the row scale in and drs out."""
    nbytes = 6 * rows * C + 16 * C * H + (8 * rows if with_rs else 0)
    return max(10 * rows * C * H / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3


def inputs(g, dev, rows, C, with_rs):
    """x, g (rows, C) bf16; fp32 Swin MLP weights with bf16-exact values; a
    keep-0.9 row scale or None."""
    H = 4 * C

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x, grad = randn(rows, C).bfloat16(), randn(rows, C).bfloat16()
    w = [1 + randn(C, std=0.1), randn(C, std=0.1), randn(H, C, std=C ** -0.5),
         randn(H, std=0.1), randn(C, H, std=H ** -0.5), randn(C, std=0.1)]
    w = [t.bfloat16().float() for t in w]
    rs = ((torch.rand(rows, generator=g, device=dev) < 0.9).float() / 0.9) if with_rs else None
    return x, w, rs, grad


def check(got, x, w, rs, gelu, grad):
    """The public call's outputs against the plain recompute: -> (ok, text)."""
    plain = mb.ln_mlp_residual_bwd_recompute(x, *w, rs, 1e-5, gelu, grad)
    ref = mb.ln_mlp_residual_bwd_recompute(x.float(), *w, rs, 1e-5, gelu, grad.float())
    err = (got[0].float() - plain[0].float()).abs().max().item()
    lim = DX_TOL[0] + DX_TOL[1] * plain[0].float().abs().max().item()
    ok, text = err <= lim, [f"dx {err:.3e} (limit {lim:.3e})"]
    for name, k, p, r in list(zip(NAMES, got, plain, ref))[1:]:
        if r is None:
            ok &= k is None
            continue
        r = r.float()
        e_k, e_p = (k - r).abs().max().item(), (p - r).abs().max().item()
        limit = ERR_RATIO * e_p + ERR_FLOOR * r.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(k.flatten(), p.flatten(), 0).item()
        ok &= e_k <= limit and cos >= COS_MIN and bool(torch.isfinite(k).all())
        text.append(f"{name} {e_k:.3e}/{e_p:.3e} cos {cos:.7f}")
    return ok, "; ".join(text)


def short(name):
    """A kernel's name without its namespaces, return type and arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gelu", default="tanh", choices=("tanh", "erf"))
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    print("\n".join(ptxas_lines("mlp_block_bwd_passes.cu")), flush=True)
    sms = _build.sms(dev)
    ok = True
    step = {"K7": 0.0, "plain": 0.0, "bound": 0.0}
    for rows, C, with_rs, count in step_calls():
        H = 4 * C
        x, w, rs, grad = inputs(gen, dev, rows, C, with_rs)
        label = f"rows={rows} C={C} row_scale={'yes' if with_rs else 'no'}"
        args_ = (x, *w, rs, 1e-5, args.gelu, grad)
        got = mb.ln_mlp_residual_bwd_onepass(*args_)
        again = mb.ln_mlp_residual_bwd_onepass(*args_)
        torch.cuda.synchronize()
        same = all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, again))
        good, text = check(got, x, w, rs, args.gelu, grad)
        ok &= good and same
        print(f"{label}: x{count} a step; {mb.k7_plan(rows, C, H, sms)}", flush=True)
        print(f"{label}: check {'OK' if good else 'FAIL'}, two calls bitwise equal {same}: {text}",
              flush=True)
        times = {"K7": cuda_ms(lambda: mb.ln_mlp_residual_bwd_onepass(*args_), 5)}
        kms = kernel_ms(lambda: mb.ln_mlp_residual_bwd_onepass(*args_), 3)
        alien = [n for n in kms if not n.startswith(("void clover::", "clover::"))]
        ok &= not alien
        print(f"{label}: launches alone (device ms per call): "
              + "; ".join(f"{short(n)} {ms:.4f}" for n, ms in kms.items())
              + (f"; NOT THE PORT'S: {alien}" if alien else ""), flush=True)
        del got, again
        times["plain"] = cuda_ms(lambda: mb.ln_mlp_residual_bwd_recompute(*args_), 3)
        times["bound"] = bound_ms(rows, C, H, with_rs)
        print(f"{label}: ms per call: " + ", ".join(f"{n} {t:.4f}" for n, t in times.items()),
              flush=True)
        for n, t in times.items():
            step[n] += count * t
        del x, w, rs, grad
        torch.cuda.empty_cache()
    print("P32 per step (ms): " + ", ".join(f"{n} {t:.2f}" for n, t in step.items()))
    print("all checks passed" if ok else "CHECK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
