"""The port's head-major, spatial-grid and key-tiled window attention (K9,
K10, K11) held against the JAX package's kernels on the CPU.

On the CPU every wrapper runs its plain PyTorch version; these tests feed
the same seeded numpy inputs to it and to the JAX function, run as the JAX
tests run it (Pallas interpret mode), in fp32:

- (a) ``window_attention_heads_plain`` against ``_forward`` (v1) and
  ``_forward_v2`` (v2, v4), with and without a mask and with a window block
  W < nW; ``spatial_window_attention_plain`` against
  ``fused_partition_window_attention``; the key-tiled plain versions
  against ``_forward_long_from_flat`` and ``_forward_flat_flash`` at N=72,
  128, 150 and 196 (the last key tile partial or full). Tolerance 2e-5,
  fp32 summation order.
- (b) ``HeadsWindowAttentionFn`` and ``SpatialWindowAttentionFn`` against
  ``jax.grad`` through ``fused_window_attention`` / ``spatial_window_attention``
  (the mask's gradient included), 1e-4 as the JAX package's own test.
- (e') DropPath on the spatial layout, port only; (f) the config refusals.

The ``gpu`` tests launch K9, K10 and K11 against their plain versions at
the Swin-B shapes (K9 and K10 also with a bias of magnitude ~10 and a mask
of arbitrary fp32 values, at N=392 and on grids too small to fill the
card, one launch a call) and skip without a card: ``python -m pytest
tests/test_torch_spatial.py -m gpu --noconftest`` (JAX is imported inside
the tests that compare with it).
"""

import types

import numpy as np
import pytest
import torch

from clover_tpu_torch import ops
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.ops import window_attention as pwa

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
HD = 32


@pytest.fixture
def jx():
    """The JAX package's modules under test."""
    jnp = pytest.importorskip("jax.numpy")
    import jax

    import clover_tpu.ops.window_attention as wa

    return types.SimpleNamespace(jax=jax, jnp=jnp, wa=wa)


def _np(t):
    return np.asarray(t, np.float32)


def _random_mask(rng, nW, N):
    return np.where(rng.random((nW, N, N)) < 0.3, -100.0, 0.0).astype(np.float32)


def _heads_inputs(rng, Bn=16, nH=2, N=49, nW=8, masked=True):
    q, k, v = (rng.normal(size=(Bn, nH, N, HD)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(nH, N, N)).astype(np.float32)
    return q, k, v, bias, (_random_mask(rng, nW, N) if masked else None)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(jx, a):
    return None if a is None else jx.jnp.asarray(a)


# ------------------------------------------------------------------ (a) K9

@pytest.mark.parametrize("version", ["v1", "v2", "v4"])
@pytest.mark.parametrize("masked", [False, True])
def test_heads_plain_matches_pallas(version, masked, jx):
    """window_attention_heads_plain against the JAX head-major kernels: v1
    is _forward (a program per (window, head)), v2 / v4 _forward_v2."""
    rng = np.random.default_rng(0)
    q, k, v, bias, mask = _heads_inputs(rng, masked=masked)
    scale = HD ** -0.5
    args = [jx.jnp.asarray(a) for a in (q, k, v, bias)] + [_j(jx, mask), scale]
    if version == "v1":
        ref = jx.wa._forward(*args)
    else:
        ref = jx.wa._forward_v2(*args, version=version)
    got = pwa.window_attention_heads_plain(*map(_t, (q, k, v, bias, mask)), scale)
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)
    # on a CPU tensor the wrapper is the plain version
    wrapped = ops.fused_window_attention(*map(_t, (q, k, v, bias, mask)), scale)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("version", ["v2", "v4"])
def test_heads_plain_matches_pallas_with_a_block_smaller_than_nw(version, jx, monkeypatch):
    """A window block W=4 < nW=8: the JAX kernel's mask index map walks
    blocks of the mask; the plain version's chunks start at mask row 0."""
    rng = np.random.default_rng(1)
    q, k, v, bias, mask = _heads_inputs(rng, Bn=32)
    monkeypatch.setattr(jx.wa, "_pick_window_block", lambda *a, **kw: 4)
    monkeypatch.setattr(jx.wa, "_pick_window_block_v4", lambda *a, **kw: 4)
    monkeypatch.setattr(pwa, "_PLAIN_LOGITS", 1)     # plain chunks of one nW-group
    scale = HD ** -0.5
    ref = jx.wa._forward_v2(*(jx.jnp.asarray(a) for a in (q, k, v, bias, mask)), scale,
                            version=version)
    got = pwa.window_attention_heads_plain(*map(_t, (q, k, v, bias, mask)), scale)
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)


# ----------------------------------------------------------------- (a) K10

# a padded, rolled grid of 2 clips: (Dp, Hp, Wp) = (4, 14, 21), window
# (2, 7, 7): a (2, 2, 3) grid of windows, N = 98
GRID, WIN = (4, 14, 21), (2, 7, 7)


def _grid_inputs(rng, nH=2, B=2, masked=True):
    N = int(np.prod(WIN))
    gd, gh, gw = (g // w for g, w in zip(GRID, WIN))
    qkv5 = rng.normal(size=(B, *GRID, 3, nH, HD)).astype(np.float32)
    bias = rng.normal(size=(nH, N, N)).astype(np.float32)
    grid = _random_mask(rng, gd * gh * gw, N).reshape(gd, gh, gw, N, N) if masked else None
    return qkv5, bias, grid


@pytest.mark.parametrize("masked", [False, True])
def test_spatial_plain_matches_pallas(masked, jx):
    """spatial_window_attention_plain against fused_partition_window_attention
    (the Pallas kernel in interpret mode), output (B, Dp, Hp, Wp, nH, hd)."""
    rng = np.random.default_rng(2)
    qkv5, bias, grid = _grid_inputs(rng, masked=masked)
    scale = HD ** -0.5
    ref = jx.wa.fused_partition_window_attention(jx.jnp.asarray(qkv5), jx.jnp.asarray(bias),
                                                 _j(jx, grid), WIN, scale)
    got = pwa.spatial_window_attention_plain(_t(qkv5), _t(bias), _t(grid), WIN, scale)
    assert got.shape == (2, *GRID, 2, HD)
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)
    assert torch.equal(ops.spatial_window_attention(_t(qkv5), _t(bias), _t(grid), WIN, scale),
                       got)


# ----------------------------------------------------------------- (a) K11

# the keys in the port's last 64-key tile: 8, 64 (full), 22, 4
LONG_N = [72, 128, 150, 196]


@pytest.mark.parametrize("route", ["v6", "v7"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N", LONG_N)
def test_long_plain_matches_pallas(N, route, masked, jx):
    """The key-tiled plain versions on the flat qkv against
    _forward_long_from_flat (v6) and _forward_flat_flash (v7): the JAX
    kernels take 128-key tiles, the port 64, and N puts the end of the last
    tile at each place (LONG_N; at N=128 both end in a full tile). The
    port's region ids against the JAX additive mask built from them; the
    bias and mask rounded to the compute dtype on both sides."""
    rng = np.random.default_rng(3)
    Bn, nH, nW = 4, 2, 2
    C = nH * HD
    qkv = rng.normal(size=(Bn, N, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(nH, N, N)).astype(np.float32)
    ids = rng.integers(0, 3, size=(nW, N)).astype(np.int32) if masked else None
    mask = None if ids is None else pwa.region_mask(torch.from_numpy(ids), torch.float32).numpy()
    scale = HD ** -0.5
    jfn = jx.wa._forward_long_from_flat if route == "v6" else jx.wa._forward_flat_flash
    ref = jfn(jx.jnp.asarray(qkv), jx.jnp.asarray(bias), _j(jx, mask), scale, nH)
    assert ref is not None
    qkv2 = torch.from_numpy(qkv.reshape(Bn * N, 3 * C))
    fn = (pwa.long_window_attention_from_flat if route == "v6"
          else pwa.flat_flash_window_attention)
    got = fn(qkv2, _t(bias), _t(ids), scale, nH, N)
    np.testing.assert_allclose(got.numpy(), _np(ref).reshape(Bn * N, C), **TOL)
    # and against the full-softmax plain version: the tiles change the rounding only
    full = pwa.window_attention_plain(qkv2, _t(bias), _t(ids), scale, nH, N)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("N", LONG_N)
def test_long_heads_plain_matches_forward_long(N, jx):
    """window_attention_long_plain on head-major q, k, v against
    _forward_long, the TPU's head-major flash kernel, with a region mask."""
    rng = np.random.default_rng(4)
    q, k, v, bias, _ = _heads_inputs(rng, Bn=4, N=N, masked=False)
    ids = rng.integers(0, 3, size=(2, N)).astype(np.int32)
    mask = pwa.region_mask(torch.from_numpy(ids), torch.float32).numpy()
    scale = HD ** -0.5
    ref = jx.wa._forward_long(*(jx.jnp.asarray(a) for a in (q, k, v, bias, mask)), scale)
    got = pwa.window_attention_long_plain(*map(_t, (q, k, v, bias, ids)), scale)
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)
    assert torch.equal(ops.flash_window_attention(*map(_t, (q, k, v, bias, ids)), scale), got)


def test_long_route_feeds_window_attention_fn_with_the_k5_backward(monkeypatch):
    """WindowAttentionFn with long_attn takes the key-tiled forward and keeps
    the flat backward: its gradients equal those of the K1 route."""
    rng = np.random.default_rng(5)
    Bn, nH, N = 2, 2, 150
    qkv = torch.from_numpy(rng.normal(size=(Bn * N, 3 * nH * HD)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(nH, N, N)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 3, size=(1, N)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(Bn * N, nH * HD)).astype(np.float32))
    calls = []
    real = pwa.window_attention_flat_flash_plain
    monkeypatch.setattr(pwa, "window_attention_flat_flash_plain",
                        lambda *a: calls.append(1) or real(*a))
    grads = {}
    for route in ("off", "v7", "v6"):
        a, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        out = pwa.WindowAttentionFn.apply(a, b, ids, HD ** -0.5, nH, N, False, route)
        out.backward(g)
        grads[route] = (out.detach(), a.grad, b.grad)
    assert len(calls) == 2
    for route in ("v7", "v6"):
        for got, want in zip(grads[route], grads["off"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# --------------------------------------------------------------- (b) grads

@pytest.mark.parametrize("masked", [False, True])
def test_heads_fn_gradients_match_jax(masked, jx):
    """HeadsWindowAttentionFn's backward (_bwd's math) against jax.grad of
    sum(fused_window_attention(...) * G): q, k, v, bias and the mask."""
    rng = np.random.default_rng(6)
    q, k, v, bias, mask = _heads_inputs(rng, Bn=8, nW=4, N=20, masked=masked)
    G = rng.normal(size=q.shape).astype(np.float32)
    scale = HD ** -0.5
    jnp = jx.jnp
    n = 5 if masked else 4

    def loss(*a):
        m = a[4] if masked else None
        return jnp.sum(jx.wa.fused_window_attention(*a[:4], m, scale) * jnp.asarray(G))

    want = jx.jax.grad(loss, argnums=tuple(range(n)))(
        *(jnp.asarray(a) for a in (q, k, v, bias, mask)[:n]))
    ts = [_t(a).requires_grad_() for a in (q, k, v, bias, mask)[:n]]
    out = pwa.HeadsWindowAttentionFn.apply(*ts[:4], ts[4] if masked else None, scale, False)
    out.backward(torch.from_numpy(G))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), **GRAD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_spatial_fn_gradients_match_jax(masked, jx):
    """SpatialWindowAttentionFn's backward (_spatial_bwd's math) against
    jax.grad through spatial_window_attention: qkv5, bias and the mask grid."""
    rng = np.random.default_rng(7)
    qkv5, bias, grid = _grid_inputs(rng, B=1, masked=masked)
    G = rng.normal(size=(1, *GRID, 2, HD)).astype(np.float32)
    scale = HD ** -0.5
    jnp = jx.jnp
    n = 3 if masked else 2

    def loss(*a):
        m = a[2] if masked else None
        return jnp.sum(jx.wa.spatial_window_attention(a[0], a[1], m, WIN, scale)
                       * jnp.asarray(G))

    want = jx.jax.grad(loss, argnums=tuple(range(n)))(
        *(jnp.asarray(a) for a in (qkv5, bias, grid)[:n]))
    ts = [_t(a).requires_grad_() for a in (qkv5, bias, grid)[:n]]
    out = pwa.SpatialWindowAttentionFn.apply(ts[0], ts[1], ts[2] if masked else None, WIN,
                                             scale, False)
    out.backward(torch.from_numpy(G))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), **GRAD_TOL)


# --------------------------------------------------------- (e') DropPath

def _spatial_block(drop_path, impl="pallas_fused", C=64, nH=2):
    block = pswin.SwinBlock3D(C, nH, (8, 7, 7), (0, 3, 3), drop_path=drop_path,
                              attention_impl=impl)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + (1.0 if p.ndim == 1 else 0.0))
    return block


def test_drop_path_on_the_spatial_layout_drops_and_scales_whole_samples():
    """A training block on (B, D, H, W, C) tokens (dims (2, 9, 9): padded,
    shifted): a sample whose two DropPath draws are 0 leaves the block
    equal to its input on all D*H*W tokens; the MLP half's per-sample factor
    covers all D*H*W rows of its sample (not D rows, the (B, L, C) count)."""
    rate, B = 0.5, 6
    block = _spatial_block(rate).train()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(B, 2, 9, 9, 64)).astype(np.float32))
    seed = 11
    draws = torch.Generator().manual_seed(seed)
    keep_attn = torch.rand(B, generator=draws) < 1 - rate
    keep_mlp = torch.rand(B, generator=draws) < 1 - rate
    both = (~keep_attn & ~keep_mlp).nonzero().flatten().tolist()
    assert both and (keep_attn & keep_mlp).any(), "pick a seed with both cases"
    with torch.no_grad():
        out = block(x, None, None, torch.Generator().manual_seed(seed))
    for b in both:
        assert torch.equal(out[b], x[b])

    scale = torch.tensor([0.0, 2.0, 1.0, 2.0, 0.0, 2.0])
    block.drop_path.sample_scale = lambda n, generator, device: scale[:n]
    with torch.no_grad():
        got = block._mlp_half(x, torch.Generator())
        block.drop_path.rate = 0.0
        ref = block._mlp_half(x, None)
    want = x + scale.view(B, 1, 1, 1, 1) * (ref - x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------- (f) config refusals

@pytest.mark.parametrize("fields,match", [
    (dict(fold_normalize=True, patch_size=(2, 4, 4), stride=(1, 2, 2)),
     "fold_normalize requires kernel == stride"),
    (dict(attention_impl="flash"), "attention_impl must be one of"),
    (dict(long_attn="v8"), "long_attn must be"),
    (dict(long_attn="v7"), "fused_attn='off'"),
    (dict(long_attn="v6", fused_attn="on"), "fused_attn='off'"),
    (dict(long_attn="v7", fused_attn="off", attention_impl="pallas"), "flat attention"),
])
def test_swin_config_refuses(fields, match):
    with pytest.raises(ValueError, match=match):
        pswin.SwinConfig(**fields)


def test_swin_config_takes_the_new_fields():
    cfg = pswin.SwinConfig(attention_impl="pallas_fused", window_resident=False)
    assert (cfg.attention_impl, cfg.window_resident, cfg.long_attn) == ("pallas_fused", False,
                                                                        "off")
    cfg = pswin.SwinConfig(long_attn="v6", fused_attn="off")
    assert cfg.long_attn == "v6" and cfg.attention_impl == "auto"


def test_bias_from_table_is_contiguous():
    """K9 and K10 read the (nH, N, N) bias in place and refuse a strided
    one: the table's bias (and so the eval bias cache) comes contiguous."""
    table = torch.randn(15 * 13 * 13, 4)
    bias = pswin.bias_from_table(table, (8, 7, 7), (4, 7, 7), 4)
    assert bias.shape == (4, 196, 196) and bias.is_contiguous()


# ---------------------------------------------------------- (g) on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _bf16(rng, shape, dev, std=1.0):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * std).to(dev,
                                                                                 torch.bfloat16)


def _f32(rng, shape, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)


def _close(got, ref, atol=2e-2, rtol=1e-2):
    """bf16 outputs: max|got - ref| <= atol + rtol * max|ref| (chip_smoke.py's K1 limit)."""
    assert bool(torch.isfinite(got).all())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= atol + rtol * ref.float().abs().max().item(), err


def _shift_mask(dims, window, shift, dev):
    return torch.from_numpy(pswin.shift_attn_mask(dims, window, shift)).to(dev)


def _terms(rng, shift_mask, nH, N, dev, wild):
    """The bias and mask a kernel test feeds: a unit-normal bias and the
    0 / -100 shift mask, or (``wild``) a bias of magnitude ~10 and a mask of
    arbitrary fp32 values, which any rounding to bf16 or any region-id
    shortcut would get wrong."""
    bias = _f32(rng, (nH, N, N), dev) * (10.0 if wild else 1.0)
    if shift_mask is None or not wild:
        return bias, shift_mask
    return bias, _f32(rng, tuple(shift_mask.shape), dev) * 10.0


@pytest.mark.gpu
@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("dims,window,shift,nH", [
    ((4, 14, 14), (4, 7, 7), (0, 3, 3), 4),     # 8-frame stage 0, N=196
    ((4, 7, 7), (4, 7, 7), (0, 0, 0), 32),      # 8-frame stage 3: a grid too small to fill the card
    ((16, 14, 14), (8, 7, 7), (4, 3, 3), 4),    # N=392, 25 key tiles
    ((3, 14, 14), (3, 7, 7), (0, 3, 3), 2),     # N=147: odd rows of bias and mask
])
def test_heads_kernel_on_card(cuda, dims, window, shift, nH, wild):
    rng = np.random.default_rng(20)
    N = int(np.prod(window))
    mask = _shift_mask(dims, window, shift, cuda) if any(shift) else None
    nW = 1 if mask is None else mask.shape[0]
    q, k, v = (_bf16(rng, (2 * nW, nH, N, HD), cuda) for _ in range(3))
    bias, mask = _terms(rng, mask, nH, N, cuda, wild)
    before = ops.fused_window_attention.launches
    got = ops.fused_window_attention(q, k, v, bias, mask, HD ** -0.5)
    torch.cuda.synchronize()
    assert ops.fused_window_attention.launches == before + 1
    _close(got, pwa.window_attention_heads_plain(q, k, v, bias, mask, HD ** -0.5))
    terms = (pwa.bias_terms(bias, N), None if mask is None else pwa.mask_terms(mask, N))
    assert torch.equal(ops.fused_window_attention(q, k, v, bias, mask, HD ** -0.5, terms), got)
    assert ops.fused_window_attention.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("B,dims,window,shift,nH", [
    (2, (4, 64, 64), (4, 7, 7), (0, 3, 3), 4),     # the 256^2 clip's stage 0, padded to 70
    (2, (4, 8, 8), (4, 7, 7), (0, 0, 0), 4),       # its stage 3, padded to 14
    (4, (4, 8, 8), (4, 7, 7), (0, 0, 0), 32),      # E8P's stage 3: too small to fill the card
    (2, (4, 56, 56), (4, 7, 7), (0, 3, 3), 4),     # 224^2, no padding
    (1, (16, 56, 56), (8, 7, 7), (4, 3, 3), 4),    # 32 frames: 8 x 7 x 7 windows, N=392
])
def test_spatial_kernel_on_card(cuda, B, dims, window, shift, nH, wild):
    rng = np.random.default_rng(21)
    padded = tuple(-(-d // w) * w for d, w in zip(dims, window))
    N = int(np.prod(window))
    mask = _shift_mask(padded, window, shift, cuda) if any(shift) else None
    bias, mask = _terms(rng, mask, nH, N, cuda, wild)
    grid = None if mask is None else mask.view(*(p // w for p, w in zip(padded, window)), N, N)
    qkv5 = _bf16(rng, (B, *padded, 3, nH, HD), cuda)
    before = ops.spatial_window_attention.launches
    got = ops.spatial_window_attention(qkv5, bias, grid, window, HD ** -0.5)
    torch.cuda.synchronize()
    assert ops.spatial_window_attention.launches == before + 1
    _close(got, pwa.spatial_window_attention_plain(qkv5, bias, grid, window, HD ** -0.5))


@pytest.mark.gpu
def test_attention_keeps_its_bias_terms_in_eval_on_card(cuda):
    """K9 / K10 read the bias terms the eval cache carries (that tensor
    itself); without them the model lays the bias out for the call, in eval
    and in training alike."""
    attn = pswin.WindowAttention3D(64, (2, 7, 7), 2).to(cuda)
    bias = _f32(np.random.default_rng(24), (2, 98, 98), cuda)
    cached = pwa.bias_terms(bias, 98)
    assert attn.eval()._terms(bias, None, 98, cached)[0] is cached
    first = attn._terms(bias, None, 98)
    assert torch.equal(first[0], cached)
    assert attn._terms(bias, None, 98)[0] is not first[0]
    assert torch.equal(attn.train()._terms(bias, None, 98)[0], cached)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N,nH", [(17, 2), (33, 2), (64, 2), (72, 2), (150, 2), (384, 4),
                                  (385, 4), (392, 4), (392, 32), (400, 8)])
def test_flash_kernels_on_card(cuda, N, nH, masked):
    rng = np.random.default_rng(22)
    nW = 4
    Bn, C = 2 * nW, nH * HD
    qkv = _bf16(rng, (Bn * N, 3 * C), cuda)
    bias = _f32(rng, (nH, N, N), cuda)
    ids = (torch.from_numpy(rng.integers(0, 4, size=(nW, N)).astype(np.int32)).to(cuda)
           if masked else None)
    ref = pwa.window_attention_flat_flash_plain(qkv, bias, ids, HD ** -0.5, nH, N)
    before = (ops.flat_flash_window_attention.launches, ops.flash_window_attention.launches)
    flat = ops.flat_flash_window_attention(qkv, bias, ids, HD ** -0.5, nH, N)
    heads = ops.long_window_attention_from_flat(qkv, bias, ids, HD ** -0.5, nH, N)
    torch.cuda.synchronize()
    assert (ops.flat_flash_window_attention.launches,
            ops.flash_window_attention.launches) == (before[0] + 1, before[1] + 1)
    _close(flat, ref)
    assert torch.equal(flat, heads)       # one kernel template, two layouts
    # the full-softmax plain version: the tiles change the rounding only
    _close(flat, ops.window_attention_plain(qkv, bias.bfloat16(), ids, HD ** -0.5, nH, N))


@pytest.mark.gpu
def test_autograd_fns_run_the_kernels_forward_on_card(cuda):
    rng = np.random.default_rng(23)
    N, nH = 98, 2
    q, k, v = (_bf16(rng, (4, nH, N, HD), cuda).requires_grad_() for _ in range(3))
    bias = _f32(rng, (nH, N, N), cuda).requires_grad_()
    before = ops.fused_window_attention.launches
    out = pwa.HeadsWindowAttentionFn.apply(q, k, v, bias, None, HD ** -0.5, True)
    out.float().sum().backward()
    assert ops.fused_window_attention.launches == before + 1
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v, bias))
    qkv5 = _bf16(rng, (1, 2, 14, 14, 3, nH, HD), cuda).requires_grad_()
    before = ops.spatial_window_attention.launches
    out = pwa.SpatialWindowAttentionFn.apply(qkv5, bias, None, (2, 7, 7), HD ** -0.5, True)
    out.float().sum().backward()
    assert ops.spatial_window_attention.launches == before + 1
    assert bool(torch.isfinite(qkv5.grad).all())


@pytest.mark.gpu
def test_new_kernel_wrappers_reject_what_they_cannot_run(cuda):
    q = torch.zeros(2, 2, 16, 16, device=cuda, dtype=torch.bfloat16)      # head dim 16
    bias = torch.zeros(2, 16, 16, device=cuda)
    with pytest.raises(ValueError):
        ops.fused_window_attention(q, q, q, bias, None, 0.25)
    with pytest.raises(ValueError):
        ops.flash_window_attention(q, q, q, bias, None, 0.25)
    q = torch.zeros(2, 2, 16, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                                       # bf16 bias: K9 takes fp32
        ops.fused_window_attention(q, q, q, bias.bfloat16(), None, 0.2)
    qkv5 = torch.zeros(1, 4, 14, 15, 3, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                                       # 15 is not whole windows
        ops.spatial_window_attention(qkv5, torch.zeros(2, 98, 98, device=cuda), None,
                                     (2, 7, 7), 0.2)
