"""K2, the Swin LN2 + MLP + residual half (eval form, stash form K2S,
training form K2T), and K3 / K3M, the BERT post-LN FFN (K3M with the hidden
dropout's mask), on one CUDA card at every call shape of the paths
``chip_smoke.py`` drives:

    python3 -m clover_tpu_torch.ops.mlp_sweep [--only eval8,K3]
    python3 -m clover_tpu_torch.ops.mlp_sweep --turns base,hx4 [--only ...]

The shapes: K2 at the 8- and 32-frame retrieval eval (B=32 clips of 224^2),
K2S at the 12- and 32-frame finetune step and the 8-frame pretrain step (16
clips; every block timed with DropPath's row scale, as ``chip_smoke.py``
counts them), K2T at the 32-frame remat pretrain step (P32: stages 0-1 run
their forward twice) and the 8-frame erf pretrain step (P8E: every stage
twice), K3 at the eval's 960 text rows (12 BERT layers) and K3M at the
fusion tower's 3616 and 13024 rows (3 layers, keep 0.9).

For each shape it checks the public call against its plain version with
``chip_smoke.py``'s limits (max |kernel - plain| <= 2e-2 + 2e-2 max|plain|;
K2S also its z, and its fp32 mean and rstd at rtol 1e-5 / 2e-6) and two
calls for bitwise equality, then times with CUDA events the public call,
the plain version and, as a yardstick the port never calls, the same
function composed of PyTorch calls (``F.layer_norm``, ``F.linear``,
``F.gelu``, ``F.linear``, the residual; K3: the LayerNorm last); with
torch.profiler each kernel one call launches, alone (device ms per call by
name). It prints the bound (two rows x C x H products over 989 TFLOP/s
bf16, or x in, out, the fp32 weights and what the form adds over 3.35
TB/s, whichever is larger), each shape's calls per forward or step and the
sums, the registers and spills of ``csrc/mlp_block.cu`` (nvcc -Xptxas -v)
and the card's name and power limit. Needs a card; the build is
``_build``'s.

``--turns`` instead times each form per call and per forward or step under
each chunk plan named, in turns (A B ... B A), after checking each plan's
outputs bitwise against the first's: ``base`` the module's constants,
``capN`` chunks of N MB (``_K2_CHUNK_BYTES``), ``hxN`` K2's h under N
times x (``_K2_HIDDEN_OVER_X``).
"""

from __future__ import annotations

import argparse
import subprocess

import torch
import torch.nn.functional as F

from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops import mlp_block as mb
from clover_tpu_torch.ops.bwd_sweep import kernel_ms
from clover_tpu_torch.ops.heads_sweep import cuda_ms, ptxas_lines
from clover_tpu_torch.ops.mlp_bwd_sweep import short

SIZE, EMBED = 224, 128
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
TOL = {"out": (2e-2, 2e-2), "z": (2e-2, 2e-2), "mean": (0.0, 1e-5), "rstd": (0.0, 2e-6)}
BERT_C, BERT_H, BERT_EPS = 768, 3072, 1e-12
# (path, form, clips, frames, gelu, calls per stage)
SWIN_PATHS = (("eval8", "K2", 32, 8, "tanh", (2, 2, 18, 2)),
              ("eval32", "K2", 32, 32, "tanh", (2, 2, 18, 2)),
              ("finetune12", "K2S", 16, 12, "tanh", (2, 2, 18, 2)),
              ("finetune32", "K2S", 16, 32, "tanh", (2, 2, 18, 2)),
              ("pretrain", "K2S", 16, 8, "tanh", (2, 2, 18, 2)),
              ("P32", "K2T", 16, 32, "tanh", (4, 4, 18, 2)),
              ("P8E", "K2T", 16, 8, "erf", (4, 4, 36, 4)))
# (path, form, rows, calls): the eval's text tower, the fusion tower's
BERT_PATHS = (("eval", "K3", 960, 12), ("pretrain", "K3M", 3616, 3), ("P32", "K3M", 13024, 3))


def call_shapes():
    """(path, form, stage or None, rows, C, H, gelu, calls) of every K2 /
    K2S / K2T / K3 / K3M call shape."""
    out = []
    for path, form, clips, frames, gelu, calls in SWIN_PATHS:
        tokens = clips * frames // 2 * (SIZE // 4) ** 2
        for i, n in enumerate(calls):
            C = EMBED * 2 ** i
            out.append((path, form, i, tokens // 4 ** i, C, 4 * C, gelu, n))
    for path, form, rows, n in BERT_PATHS:
        out.append((path, form, None, rows, BERT_C, BERT_H, "erf", n))
    return out


def bound_ms(form, rows, C, H):
    """Two rows x C x H products; x in, out (bf16), the fp32 weights and
    biases; K2S adds its stash (z bf16, mean and rstd) and the row scale,
    K2T the row scale, K3M the fp32 mask."""
    extra = {"K2S": 2 * rows * H + 12 * rows, "K2T": 4 * rows, "K3M": 4 * rows * C}.get(form, 0)
    nbytes = 4 * rows * C + 8 * C * H + 4 * (H + 3 * C) + extra
    return max(4 * rows * C * H / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3


def inputs(g, dev, form, rows, C, H):
    """x bf16 (rows, C); fp32 LN scale / bias, W1 (H, C), b1, W2 (C, H), b2
    in torch layout; the row scale (DropPath's keep / 0.9 per clip of 16)
    for K2S / K2T, the {0, 1/0.9} fp32 mask for K3M, else None."""
    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x = randn(rows, C).bfloat16()
    w = (1 + randn(C, std=0.1), randn(C, std=0.1), randn(H, C, std=C ** -0.5),
         randn(H, std=0.1), randn(C, H, std=H ** -0.5), randn(C, std=0.1))
    extra = None
    if form in ("K2S", "K2T"):
        keep = (torch.rand(16, generator=g, device=dev) < 0.9).float() / 0.9
        extra = keep.repeat_interleave(rows // 16)
    elif form == "K3M":
        extra = (torch.rand(rows, C, generator=g, device=dev) < 0.9).float() / 0.9
    return x, w, extra


def calls_of(form, x, w, extra, gelu):
    """(the public call, its plain version, the composed PyTorch calls)."""
    C = x.shape[1]
    if form == "K2":
        k = lambda: mb.fused_ln_mlp_residual(x, *w, 1e-5, gelu)   # noqa: E731
        p = lambda: mb.ln_mlp_residual_plain(x, *w, 1e-5, gelu)   # noqa: E731
    elif form == "K2S":
        k = lambda: mb.fused_ln_mlp_residual_stash(x, *w, 1e-5, gelu, extra)   # noqa: E731
        p = lambda: mb.ln_mlp_residual_plain(   # noqa: E731
            x, *w, 1e-5, gelu, row_scale=extra, want_stash=True)
    elif form == "K2T":
        k = lambda: mb.fused_ln_mlp_residual_train(x, *w, 1e-5, gelu, extra)   # noqa: E731
        p = lambda: mb.ln_mlp_residual_plain(x, *w, 1e-5, gelu, extra)   # noqa: E731
    elif form == "K3":
        k = lambda: mb.fused_mlp_postln(x, *w, BERT_EPS)   # noqa: E731
        p = lambda: mb.mlp_postln_plain(x, *w, BERT_EPS)   # noqa: E731
    else:
        k = lambda: mb.fused_mlp_postln_dropout(x, *w, extra, BERT_EPS)   # noqa: E731
        p = lambda: mb.mlp_postln_mask_plain(x, *w, extra, BERT_EPS)   # noqa: E731
    lw, lb, w1, b1, w2, b2 = (t.bfloat16() for t in w)
    approx = "tanh" if gelu == "tanh" else "none"
    rs = None if extra is None or form.startswith("K3") else extra.bfloat16()[:, None]
    mask = extra.bfloat16() if form == "K3M" else None

    def composed():
        if form.startswith("K3"):
            y = F.linear(F.gelu(F.linear(x, w1, b1), approximate=approx), w2, b2)
            return F.layer_norm(x + (y if mask is None else y * mask), (C,), lw, lb, BERT_EPS)
        y = F.linear(F.gelu(F.linear(F.layer_norm(x, (C,), lw, lb, 1e-5), w1, b1),
                            approximate=approx), w2, b2)
        return x + (y if rs is None else y * rs)

    return k, p, composed


def check(form, got, ref):
    """chip_smoke.py's limits, each output: -> (ok, text)."""
    parts = (("out", got[0], ref[0]), *zip(("z", "mean", "rstd"), got[1], ref[1])) \
        if form == "K2S" else (("out", got, ref),)
    ok, text = True, []
    for name, a, b in parts:
        err = (a.float() - b.float()).abs().max().item()
        lim = TOL[name][0] + TOL[name][1] * b.float().abs().max().item()
        ok &= err <= lim and bool(torch.isfinite(a).all())
        text.append(f"{name} max_abs_err {err:.3e} (limit {lim:.3e})")
    return ok, ", ".join(text)


def same(a, b):
    if isinstance(a, tuple):
        return all(same(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def set_plan(turn, defaults):
    """Apply one ``--turns`` entry to the module's chunk caps."""
    mb._K2_CHUNK_BYTES, mb._K2_HIDDEN_OVER_X = defaults
    if turn.startswith("cap"):
        mb._K2_CHUNK_BYTES = int(turn[3:]) << 20
    elif turn.startswith("hx"):
        mb._K2_HIDDEN_OVER_X = int(turn[2:])
    elif turn != "base":
        raise ValueError(f"unknown turn {turn!r}")


def turns(order, only, dev):
    """Each form per call and per forward or step under each plan of
    ``order``, in turns."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for path, form, stage, rows, C, H, gelu, calls in call_shapes():
        if not only or only & {path, form}:
            x, w, extra = inputs(gen, dev, form, rows, C, H)
            name = f"{form} {path}" + ("" if stage is None else f" s{stage}")
            cases.append((name, f"{form} {path}", calls, calls_of(form, x, w, extra, gelu)[0]))
    defaults = mb._K2_CHUNK_BYTES, mb._K2_HIDDEN_OVER_X
    set_plan(order[0], defaults)
    ref = [k() for *_, k in cases]
    ok = True
    for turn in order[1:]:
        set_plan(turn, defaults)
        bitwise = all(same(k(), r) for (*_, k), r in zip(cases, ref))
        ok &= bitwise
        print(f"{turn}: outputs bitwise {order[0]}'s: {bitwise}", flush=True)
    del ref
    torch.cuda.empty_cache()
    for turn in order + order[::-1]:
        set_plan(turn, defaults)
        per_call, sums = [], {}
        for name, path, calls, k in cases:
            t = cuda_ms(k, 5)
            per_call.append(f"{name} {t:.4f}")
            sums[path] = sums.get(path, 0.0) + calls * t
        print(f"{turn} (ms per call): " + ", ".join(per_call), flush=True)
        print(f"{turn} (ms per forward or step): "
              + ", ".join(f"{n} {t:.2f}" for n, t in sums.items()), flush=True)
    set_plan("base", defaults)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated paths or forms to run (default: all)")
    ap.add_argument("--turns", default="",
                    help="comma-separated chunk plans to time the forms under, in turns")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.library()
    if args.turns:
        ok = turns(args.turns.split(","), only, dev)
        print("all checks passed" if ok else "CHECK FAILED")
        return 0 if ok else 1
    print("\n".join(f"mlp_block.cu: {ln}" for ln in ptxas_lines("mlp_block.cu")), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    sums = {}
    for path, form, stage, rows, C, H, gelu, calls in call_shapes():
        if only and not only & {path, form}:
            continue
        x, w, extra = inputs(gen, dev, form, rows, C, H)
        k, p, composed = calls_of(form, x, w, extra, gelu)
        label = (f"{form} {path} stage {stage} rows={rows} C={C} gelu={gelu}" if stage is not None
                 else f"{form} {path} rows={rows} C={C}")
        got, again = k(), k()
        torch.cuda.synchronize()
        bitwise = same(got, again)
        good, text = check(form, got, p())
        ok &= good and bitwise
        print(f"{label}: x{calls}; check {'OK' if good else 'FAIL'}: {text}; two calls bitwise "
              f"equal {bitwise}", flush=True)
        del got, again
        times = {form: cuda_ms(k, 5)}
        print(f"{label}: launches alone (device ms per call): "
              + "; ".join(f"{short(n)} {ms:.4f}" for n, ms in kernel_ms(k, 3).items()),
              flush=True)
        times["plain"] = cuda_ms(p, 3)
        times["composed"] = cuda_ms(composed, 5)
        times["bound"] = bound_ms(form, rows, C, H)
        print(f"{label}: ms per call: " + ", ".join(f"{n} {t:.4f}" for n, t in times.items()),
              flush=True)
        acc = sums.setdefault(f"{form} {path}", {})
        for n, t in times.items():
            acc[n] = acc.get(n, 0.0) + calls * t
        del x, w, extra
        torch.cuda.empty_cache()
    for s, acc in sums.items():
        print(f"{s} per forward or step (ms): " + ", ".join(f"{n} {t:.2f}" for n, t in acc.items()))
    print("all checks passed" if ok else "CHECK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
