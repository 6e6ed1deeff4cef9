"""clover_tpu_torch ops held against the JAX package's kernels.

On the CPU every wrapper runs its plain PyTorch version; these tests feed
the same seeded numpy inputs to that version and to the JAX kernel run as
the JAX tests run it (Pallas interpret mode: ``_FORCE_PALLAS`` for the MLP
and LayerNorm kernels, ``flat2_window_attention`` directly), in fp32.
Tolerances are fp32 summation-order noise: 2e-5 absolute/relative, 5e-5
where the JAX MLP kernel's rational erf (|err| <= 1.5e-7) feeds a product.

The ``gpu`` tests launch the CUDA kernels and skip without a card. JAX is
imported inside the tests that compare with it (the ``jx`` fixture), so on
a machine without JAX the ``gpu`` tests still run:
``python -m pytest tests/test_torch_ops.py -m gpu --noconftest``.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from clover_tpu_torch import ops
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.ops.preprocess import space_to_depth_host

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture
def jx():
    """The JAX package's modules under test."""
    jnp = pytest.importorskip("jax.numpy")
    import clover_tpu.models.swin3d as swin
    import clover_tpu.ops.layer_norm as ln
    import clover_tpu.ops.mlp_block as mlp
    import clover_tpu.ops.preprocess as prep
    import clover_tpu.ops.window_attention as wa

    return types.SimpleNamespace(jnp=jnp, swin=swin, ln=ln, mlp=mlp, prep=prep, wa=wa)


def _np(t):
    return np.asarray(t, np.float32)


def _mlp_args(rng, C, H):
    """JAX-layout MLP params: LN scale/bias, kernels (C, H) / (H, C)."""
    return [rng.normal(size=s).astype(np.float32) * f for s, f in
            [(C, 1.0), (C, 0.1), ((C, H), C ** -0.5), (H, 0.1), ((H, C), H ** -0.5), (C, 0.1)]]


def _torch_mlp_args(a):
    s, b, k1, b1, k2, b2 = (torch.from_numpy(v) for v in a)
    return s, b, k1.T.contiguous(), b1, k2.T.contiguous(), b2


@pytest.mark.parametrize("C,eps", [(64, 1e-5), (768, 1e-12)])
def test_layer_norm_matches_pallas(C, eps, jx, monkeypatch):
    jnp, jln = jx.jnp, jx.ln
    monkeypatch.setattr(jln, "_FORCE_PALLAS", True)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, C)).astype(np.float32) * 2 + 0.5
    w = rng.normal(size=C).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32) * 0.1
    ref = jln.fused_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps)
    got = ops.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               eps)
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_ln_mlp_residual_matches_pallas(gelu, jx, monkeypatch):
    jnp, jmlp = jx.jnp, jx.mlp
    monkeypatch.setattr(jmlp, "_FORCE_PALLAS", True)
    rng = np.random.default_rng(1)
    rows, C, H = 40, 64, 256
    x = rng.normal(size=(rows, C)).astype(np.float32)
    a = _mlp_args(rng, C, H)
    ref = jmlp.fused_ln_mlp_residual(jnp.asarray(x), *map(jnp.asarray, a), None, 1e-5, gelu)
    got = ops.fused_ln_mlp_residual(torch.from_numpy(x), *_torch_mlp_args(a), 1e-5, gelu)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5, rtol=5e-5)


def test_mlp_postln_matches_pallas(jx, monkeypatch):
    jnp, jmlp = jx.jnp, jx.mlp
    monkeypatch.setattr(jmlp, "_FORCE_PALLAS", True)
    rng = np.random.default_rng(2)
    rows, C, H = 24, 64, 256
    x = rng.normal(size=(rows, C)).astype(np.float32)
    a = _mlp_args(rng, C, H)
    ref = jmlp.fused_mlp_postln(jnp.asarray(x), *map(jnp.asarray, a), 1e-12)
    got = ops.fused_mlp_postln(torch.from_numpy(x), *_torch_mlp_args(a), 1e-12)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=5e-5, rtol=5e-5)


# a shifted block of the tiny slice config: stage-1 dims (2, 14, 14), window
# clamped to (2, 7, 7), shift (0, 3, 3): N = 98 (N % 8 != 0), nW = 4
_DIMS, _WIN, _SHIFT = (2, 14, 14), (2, 7, 7), (0, 3, 3)


@pytest.mark.parametrize("route", ["flat2", "flat_fallback"])
@pytest.mark.parametrize("mask_form", ["none", "additive", "lanes"])
def test_window_attention_matches_pallas(route, mask_form, jx, monkeypatch):
    """The plain version against flat2_window_attention, both where the flat2
    kernel runs and where it falls back to _forward_flat. The port takes the
    shift mask as region ids; the JAX side takes it in its additive and its
    region-lanes form."""
    jnp, jswin, jwa = jx.jnp, jx.swin, jx.wa
    if route == "flat_fallback":
        monkeypatch.setattr(jwa, "_flat2_feasible", lambda *a, **k: False)
        calls = []
        real = jwa._forward_flat
        monkeypatch.setattr(jwa, "_forward_flat",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(3)
    nH, hd, B = 2, 32, 2
    N, nW = int(np.prod(_WIN)), (_DIMS[1] // _WIN[1]) * (_DIMS[2] // _WIN[2])
    C = nH * hd
    qkv = rng.normal(size=(B * nW * N, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(nH, N, N)).astype(np.float32)
    mask = {"none": None,
            "additive": jswin.shift_attn_mask(_DIMS, _WIN, _SHIFT),
            "lanes": jswin.shift_region_lanes(_DIMS, _WIN, _SHIFT)}[mask_form]
    ids = None if mask is None else torch.from_numpy(pswin._shift_region_ids(_DIMS, _WIN, _SHIFT))
    scale = hd ** -0.5
    ref = jwa.flat2_window_attention(jnp.asarray(qkv), jnp.asarray(bias),
                                     None if mask is None else jnp.asarray(mask), scale, nH, N)
    got = ops.flat2_window_attention(torch.from_numpy(qkv), torch.from_numpy(bias), ids,
                                     scale, nH, N)
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)
    if route == "flat_fallback":
        assert calls, "flat2 did not fall back to _forward_flat"


# K1 / K5 / K6 tile counts; then K11 only, past K1's 400 keys, at ceil(N / 16)
@pytest.mark.parametrize("N,key_tiles", [(98, 7), (196, 13), (401, 26), (448, 28), (520, 33)])
def test_fragment_bias_is_the_kernel_accumulator_order(N, key_tiles):
    """The kernels read bias[h][strip][tile][lane] as rows (g, g+8) x keys
    (2t, 2t+1) of the strip and tile, lane = 4g + t: -inf past N keys, 0
    past N rows, values rounded to bf16."""
    from clover_tpu_torch.ops.window_attention import fragment_bias

    nH, Np = 2, 16 * key_tiles
    bias = torch.from_numpy(np.random.default_rng(12).normal(size=(nH, N, N)).astype(np.float32))
    got = fragment_bias(bias, N, key_tiles).float().reshape(nH, key_tiles, 2 * key_tiles, 32, 4)
    want = torch.zeros(nH, Np, Np)
    want[:, :, N:] = float("-inf")
    want[:, :N, :N] = bias.to(torch.bfloat16).float()
    s, nt, lane = np.meshgrid(np.arange(key_tiles), np.arange(2 * key_tiles), np.arange(32),
                              indexing="ij")
    row, key = s * 16 + lane // 4, nt * 8 + (lane % 4) * 2
    for j, (dr, dk) in enumerate([(0, 0), (0, 1), (8, 0), (8, 1)]):
        assert torch.equal(got[..., j], want[:, row + dr, key + dk])


def test_region_mask_is_the_additive_shift_mask(jx):
    jswin = jx.swin
    ids = torch.from_numpy(pswin._shift_region_ids(_DIMS, _WIN, _SHIFT))
    from clover_tpu_torch.ops.window_attention import region_mask

    np.testing.assert_array_equal(region_mask(ids, torch.float32).numpy(),
                                  jswin.shift_attn_mask(_DIMS, _WIN, _SHIFT))


@pytest.mark.parametrize("dims,shift", [((4, 56, 56), (4, 3, 3)), ((2, 14, 14), (4, 3, 3)),
                                        ((4, 7, 7), (4, 3, 3))])
def test_swin_static_helpers_match_jax(dims, shift, jx):
    jswin = jx.swin
    full = (8, 7, 7)
    win, sh = pswin.effective_window(dims, full, shift)
    assert (win, sh) == jswin.effective_window(dims, full, shift)
    np.testing.assert_array_equal(pswin.relative_position_index(full, win),
                                  jswin.relative_position_index(full, win))
    for a, b in ((pswin._shift_region_ids(dims, win, sh), jswin._shift_region_ids(dims, win, sh)),
                 (pswin.shift_attn_mask(dims, win, sh), jswin.shift_attn_mask(dims, win, sh))):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(pswin._window_shift_perm_np(dims, win, sh),
                    jswin._window_shift_perm_np(dims, win, sh)):
        np.testing.assert_array_equal(a, b)


def test_window_layout_ops_match_jax(jx):
    jnp, jswin = jx.jnp, jx.swin
    rng = np.random.default_rng(4)
    B, C = 2, 8
    x = rng.normal(size=(B,) + _DIMS + (C,)).astype(np.float32)
    jp = jswin.window_partition(jnp.asarray(x), _WIN)
    pp = pswin.window_partition(torch.from_numpy(x), _WIN)
    np.testing.assert_array_equal(pp.numpy(), _np(jp))
    np.testing.assert_array_equal(pswin.window_reverse(pp, _WIN, B, *_DIMS).numpy(), x)
    tokens = pp.reshape(B, -1, C)
    for inverse in (False, True):
        ref = jswin._apply_window_perm(jnp.asarray(tokens.numpy()), _DIMS, _WIN, _SHIFT, inverse)
        got = pswin._apply_window_perm(tokens, _DIMS, _WIN, _SHIFT, inverse)
        np.testing.assert_array_equal(got.numpy(), _np(ref))


def test_space_to_depth_matches_jax(jx):
    frames = np.random.default_rng(5).integers(0, 256, (2, 4, 16, 16, 3), dtype=np.uint8)
    np.testing.assert_array_equal(space_to_depth_host(frames),
                                  jx.prep.space_to_depth_host(frames))


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers return their plain version's values and
    launch nothing."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    a = _torch_mlp_args(_mlp_args(rng, 64, 128))
    assert torch.equal(ops.fused_layer_norm(x, a[0], a[1]), ops.layer_norm_plain(x, a[0], a[1]))
    assert torch.equal(ops.fused_ln_mlp_residual(x, *a, 1e-5, "tanh"),
                       ops.ln_mlp_residual_plain(x, *a, 1e-5, "tanh"))
    assert torch.equal(ops.fused_mlp_postln(x, *a), ops.mlp_postln_plain(x, *a))
    qkv = torch.from_numpy(rng.normal(size=(2 * 4, 96)).astype(np.float32))
    bias = torch.zeros(1, 4, 4)
    assert torch.equal(ops.flat2_window_attention(qkv, bias, None, 0.2, 1, 4),
                       ops.window_attention_plain(qkv, bias, None, 0.2, 1, 4))
    assert all(n == 0 for n in ops.launch_counts().values())


def test_launch_takes_buffers_as_tensors(monkeypatch):
    """``_build.launch`` receives the tensors themselves (so the caller holds
    them through the call) and hands their pointers to the C entry; other
    arguments pass as they are."""
    from clover_tpu_torch.ops import _build

    seen = []
    lib = types.SimpleNamespace(clover_entry=lambda *a: seen.extend(a) or 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    t = torch.zeros(4)
    _build.launch("clover_entry", t, None, 3, 0.5)
    assert seen == [t.data_ptr(), None, 3, 0.5]


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _bf16(rng, shape, std, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * std).to(dev,
                                                                                 torch.bfloat16)


def _close(got, ref, atol, rtol):
    """bf16 outputs: max|got - ref| <= atol + rtol * max|ref|, as chip_smoke.py."""
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= atol + rtol * ref.float().abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_kernel_on_card(cuda, masked):
    rng = np.random.default_rng(7)
    nH, N = 4, int(np.prod(_WIN))
    nW = 4
    qkv = _bf16(rng, (2 * nW * N, 3 * nH * 32), 1.0, cuda)
    bias = torch.from_numpy(rng.normal(size=(nH, N, N)).astype(np.float32)).to(cuda)
    ids = (torch.from_numpy(pswin._shift_region_ids(_DIMS, _WIN, _SHIFT)).to(cuda)
           if masked else None)
    before = ops.flat2_window_attention.launches
    got = ops.flat2_window_attention(qkv, bias, ids, 32 ** -0.5, nH, N)
    torch.cuda.synchronize()
    assert ops.flat2_window_attention.launches == before + 1
    _close(got, ops.window_attention_plain(qkv, bias, ids, 32 ** -0.5, nH, N), 2e-2, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [128, 256, 512, 1024])
def test_ln_mlp_residual_kernel_on_card(cuda, C):
    rng = np.random.default_rng(8)
    x = _bf16(rng, (1000, C), 1.0, cuda)          # rows not a multiple of the row block
    a = [t.to(cuda) for t in _torch_mlp_args(_mlp_args(rng, C, 4 * C))]
    for gelu in ("tanh", "erf"):
        _close(ops.fused_ln_mlp_residual(x, *a, 1e-5, gelu),
               ops.ln_mlp_residual_plain(x, *a, 1e-5, gelu), 2e-2, 2e-2)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_mlp_postln_kernel_on_card(cuda):
    rng = np.random.default_rng(9)
    C = 768
    x = _bf16(rng, (100, C), 1.0, cuda)
    a = [t.to(cuda) for t in _torch_mlp_args(_mlp_args(rng, C, 4 * C))]
    _close(ops.fused_mlp_postln(x, *a, 1e-12), ops.mlp_postln_plain(x, *a, 1e-12), 2e-2, 2e-2)
    torch.cuda.synchronize()


# Every wrapper once, at BERT-base / Swin-B widths, with fp32 weights (so
# the wrappers make bf16 copies), against its plain version.
_UNCACHED_CHECK = r"""
import sys
import torch
from clover_tpu_torch import ops
from clover_tpu_torch.models.swin3d import _shift_region_ids

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)

def randn(*shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

def mlp(C, H):
    f = torch.float32
    return (1 + randn(C, std=0.1, dtype=f), randn(C, std=0.1, dtype=f),
            randn(H, C, std=C ** -0.5, dtype=f), randn(H, std=0.1, dtype=f),
            randn(C, H, std=H ** -0.5, dtype=f), randn(C, std=0.1, dtype=f))

x3, w3 = randn(960, 768), mlp(768, 3072)
x2, w2 = randn(1000, 512), mlp(512, 2048)
qkv, bias = randn(8 * 196, 3 * 128), randn(4, 196, 196, dtype=torch.float32)
ids = torch.from_numpy(_shift_region_ids((4, 14, 14), (4, 7, 7), (0, 3, 3))).to(dev)
dout = randn(8 * 196, 128)
rs = torch.ones(1000, device=dev)
xn, wn, bn = randn(1000, 768), randn(768, dtype=torch.float32), randn(768, dtype=torch.float32)
f32 = torch.float32
x6 = randn(2 * 392, 128)
w6 = (1 + randn(128, std=0.1, dtype=f32), randn(128, std=0.1, dtype=f32),
      randn(384, 128, std=128 ** -0.5, dtype=f32), randn(384, std=0.1, dtype=f32))
p6 = (randn(128, 128, std=128 ** -0.5, dtype=f32), randn(128, std=0.1, dtype=f32))
bias6 = randn(4, 392, 392, dtype=f32)
ids6 = torch.from_numpy(_shift_region_ids((16, 14, 14), (8, 7, 7), (4, 3, 3))[:2]).to(dev)
cases = {
    "K1": (lambda: ops.flat2_window_attention(qkv, bias, ids, 32 ** -0.5, 4, 196),
           lambda: ops.window_attention_plain(qkv, bias, ids, 32 ** -0.5, 4, 196)),
    "K2": (lambda: ops.fused_ln_mlp_residual(x2, *w2, 1e-5, "tanh"),
           lambda: ops.ln_mlp_residual_plain(x2, *w2, 1e-5, "tanh")),
    "K3": (lambda: ops.fused_mlp_postln(x3, *w3, 1e-12),
           lambda: ops.mlp_postln_plain(x3, *w3, 1e-12)),
    "K4": (lambda: ops.fused_layer_norm(xn, wn, bn), lambda: ops.layer_norm_plain(xn, wn, bn)),
    "K5 dqkv": (lambda: ops.flat2_window_attention_bwd(qkv, bias, ids, dout, 32 ** -0.5, 4,
                                                       196)[0],
                lambda: ops.window_attention_bwd_plain(qkv, bias, ids, dout, 32 ** -0.5, 4,
                                                       196)[0]),
    "K5 dbias": (lambda: ops.flat2_window_attention_bwd(qkv, bias, ids, dout, 32 ** -0.5, 4,
                                                        196)[1],
                 lambda: ops.window_attention_bwd_plain(qkv, bias, ids, dout, 32 ** -0.5, 4,
                                                        196)[1]),
    "K6": (lambda: ops.fused_window_attn_block(x6, *w6, bias6, ids6, *p6, 32 ** -0.5, 4, 392),
           lambda: ops.window_attn_block_plain(x6, *w6, bias6, ids6, *p6, 32 ** -0.5, 4, 392)),
    "K2 stash z": (lambda: ops.fused_ln_mlp_residual_stash(x2, *w2, 1e-5, "tanh", rs)[1][0],
                   lambda: ops.ln_mlp_residual_plain(x2, *w2, 1e-5, "tanh", row_scale=rs,
                                                     want_stash=True)[1][0]),
}
bad = []
for name, (kernel, plain) in cases.items():
    got, ref = kernel().float(), plain().float()
    err = (got - ref).abs().max().item()
    if not err <= 2e-2 + 2e-2 * ref.abs().max().item():
        bad.append(f"{name}: max abs err {err}")
torch.cuda.synchronize()
sys.exit("; ".join(bad) or None)
"""


@pytest.mark.gpu
def test_kernels_read_no_freed_buffer(cuda):
    """Each buffer a kernel reads must be held until its launch is queued.
    With PyTorch's caching allocator off, memory freed before the launch
    goes back to the driver at once (and is handed out again), so a wrapper
    that let its bf16 weight copies go early would read freed memory here;
    with the cache on, it reads them only if a later buffer of the same call
    takes their place, which depends on the allocator's state."""
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    proc = subprocess.run([sys.executable, "-c", _UNCACHED_CHECK],
                          cwd=Path(__file__).resolve().parent.parent, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.gpu
def test_layer_norm_kernel_on_card(cuda):
    rng = np.random.default_rng(10)
    x = _bf16(rng, (1000, 768), 2.0, cuda)
    w = torch.from_numpy(rng.normal(size=768).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.normal(size=768).astype(np.float32)).to(cuda)
    _close(ops.fused_layer_norm(x, w, b), ops.layer_norm_plain(x, w, b), 1e-2, 1e-2)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_they_cannot_run(cuda):
    x = torch.zeros(4, 64, device=cuda)                  # fp32: the kernels take bf16
    w = torch.ones(64, device=cuda)
    with pytest.raises(ValueError):
        ops.fused_layer_norm(x, w, w)
    qkv = torch.zeros(8, 3 * 48, device=cuda, dtype=torch.bfloat16)   # head dim 24
    with pytest.raises(ValueError):
        ops.flat2_window_attention(qkv, torch.zeros(2, 4, 4, device=cuda), None, 0.2, 2, 4)
