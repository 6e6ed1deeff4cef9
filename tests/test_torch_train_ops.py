"""clover_tpu_torch's training ops held against the JAX package's kernels.

On the CPU every wrapper runs its plain PyTorch version. These tests feed
the same seeded numpy inputs to that version and to the JAX function run as
its own tests run it (Pallas interpret mode for the window-attention
backward kernels, ``_FORCE_PALLAS`` for the stashing MLP forward, the XLA
stash backward as it is), in fp32. Each test states its tolerance and the
gap observed when it was written.

The ``gpu`` tests launch the CUDA kernels (K1 at the 12-frame window, K5,
K2's stash form) and skip without a card. JAX is imported inside the tests
that compare with it (the ``jx`` fixture), so on a machine without JAX the
``gpu`` tests still run:
``python -m pytest tests/test_torch_train_ops.py -m gpu --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

from clover_tpu_torch import ops
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.models.layers import DropPath, dropout
from clover_tpu_torch.ops import window_attention as wa


@pytest.fixture
def jx():
    """The JAX package's modules under test."""
    jnp = pytest.importorskip("jax.numpy")
    import clover_tpu.models.swin3d as swin
    import clover_tpu.ops.mlp_block as mlp
    import clover_tpu.ops.window_attention as wa

    return types.SimpleNamespace(jnp=jnp, swin=swin, mlp=mlp, wa=wa)


def _np(t):
    return np.asarray(t, np.float32)


# a shifted block at 4 frames: token dims (2, 14, 14), window (2, 7, 7),
# shift (0, 3, 3): N = 98 (N % 8 != 0) and nW = 4, so Bn = 2 * nW windows
# are a multiple of the flat2 kernels' 8 / gcd(N, 8) = 4
_DIMS, _WIN, _SHIFT = (2, 14, 14), (2, 7, 7), (0, 3, 3)


def _attn_inputs(rng, nH, B=2):
    N, nW = int(np.prod(_WIN)), (_DIMS[1] // _WIN[1]) * (_DIMS[2] // _WIN[2])
    C = nH * 32
    qkv = rng.normal(size=(B * nW * N, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(nH, N, N)).astype(np.float32)
    g = rng.normal(size=(B * nW * N, C)).astype(np.float32)
    return N, qkv, bias, g


@pytest.mark.parametrize("nH", [2, 4])
@pytest.mark.parametrize("mask_form", ["none", "additive"])
@pytest.mark.parametrize("route", ["flat2", "flat"])
def test_window_attention_bwd_matches_pallas(route, mask_form, nH, jx):
    """The plain backward against the interpret-mode Pallas backward:
    ``_backward_flat2`` (per-window kernel at nH=2, head-grouped
    window-batched kernel at nH=4) and ``_backward_flat`` on the
    (Bn, N, 3C) view, with the true row max. Tolerance 5e-5 absolute and
    relative (fp32 summation order; dbias sums 8 windows); observed
    max |diff| 2.4e-6."""
    jnp, jswin, jwa = jx.jnp, jx.swin, jx.wa
    rng = np.random.default_rng(20)
    N, qkv, bias, g = _attn_inputs(rng, nH)
    mask = None if mask_form == "none" else jswin.shift_attn_mask(_DIMS, _WIN, _SHIFT)
    ids = None if mask is None else torch.from_numpy(pswin._shift_region_ids(_DIMS, _WIN, _SHIFT))
    scale = 32 ** -0.5
    jm = None if mask is None else jnp.asarray(mask)
    if route == "flat2":
        ref = jwa._backward_flat2(jnp.asarray(qkv), jnp.asarray(bias), jm, scale, nH, N,
                                  jnp.asarray(g), no_max=False)
    else:
        M = qkv.shape[0]
        ref = jwa._backward_flat(jnp.asarray(qkv).reshape(M // N, N, -1), jnp.asarray(bias), jm,
                                 scale, nH, jnp.asarray(g).reshape(M // N, N, -1), no_max=False)
    assert ref is not None, "the Pallas backward refused the shape"
    want_dqkv, want_dbias = _np(ref[0]).reshape(qkv.shape), _np(ref[1])
    dqkv, dbias = ops.flat2_window_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(bias), ids,
                                                 torch.from_numpy(g), scale, nH, N)
    np.testing.assert_allclose(dqkv.numpy(), want_dqkv, atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(dbias.numpy(), want_dbias, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_fn_gradcheck(masked):
    """WindowAttentionFn's backward (the plain halves) against finite
    differences in float64 at a tiny shape (gradcheck's own tolerances). On
    one intra-op thread: gradcheck's thousands of tiny calls take ~3 s so,
    and minutes when the thread pool shares busy cores with other test
    processes."""
    rng = np.random.default_rng(21)
    Bn, N, nH = 2, 6, 2
    qkv = torch.tensor(rng.normal(size=(Bn * N, 3 * nH * 32)), requires_grad=True)
    bias = torch.tensor(rng.normal(size=(nH, N, N)), requires_grad=True)
    ids = torch.tensor([[0, 0, 1, 1, 1, 2]], dtype=torch.int32) if masked else None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(
            lambda q, b: ops.WindowAttentionFn.apply(q, b, ids, 0.3, nH, N, True), (qkv, bias))
    finally:
        torch.set_num_threads(threads)


def _mlp_args(rng, C, H):
    """JAX-layout MLP params: LN scale/bias, kernels (C, H) / (H, C)."""
    return [rng.normal(size=s).astype(np.float32) * f for s, f in
            [(C, 1.0), (C, 0.1), ((C, H), C ** -0.5), (H, 0.1), ((H, C), H ** -0.5), (C, 0.1)]]


def _torch_mlp_args(a):
    s, b, k1, b1, k2, b2 = (torch.from_numpy(v) for v in a)
    return s, b, k1.T.contiguous(), b1, k2.T.contiguous(), b2


def _row_scale(rng, rows, with_scale):
    if not with_scale:
        return None
    return (rng.random(rows) < 0.8).astype(np.float32) / 0.8


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_ln_mlp_residual_stash_matches_pallas(gelu, with_scale, jx, monkeypatch):
    """K2's training form (plain version) against the interpret-mode Pallas
    ``_forward(..., want_stash=True)``: out, z, LN mean and rstd.
    Tolerance 5e-5 (the JAX kernel's rational erf is within 1.5e-7 of
    erf); observed max |diff| 1.6e-6."""
    jnp, jmlp = jx.jnp, jx.mlp
    monkeypatch.setattr(jmlp, "_FORCE_PALLAS", True)
    rng = np.random.default_rng(22)
    rows, C, H = 40, 64, 256
    x = rng.normal(size=(rows, C)).astype(np.float32) * 1.5 + 0.3
    a = _mlp_args(rng, C, H)
    rs = _row_scale(rng, rows, with_scale)
    out, (z, mean, rstd) = jmlp._forward(jnp.asarray(x), *map(jnp.asarray, a),
                                         None if rs is None else jnp.asarray(rs), 1e-5, gelu,
                                         want_stash=True)
    got, (gz, gmean, grstd) = ops.fused_ln_mlp_residual_stash(
        torch.from_numpy(x), *_torch_mlp_args(a), 1e-5, gelu,
        None if rs is None else torch.from_numpy(rs))
    np.testing.assert_allclose(got.numpy(), _np(out), atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(gz.numpy(), _np(z), atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(gmean.numpy(), _np(mean)[:, 0], atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(grstd.numpy(), _np(rstd)[:, 0], atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_ln_mlp_residual_bwd_stash_matches_jax(gelu, with_scale, jx):
    """``ln_mlp_residual_bwd_stash`` against ``_xla_backward_stash`` on the
    same stash: dx, dln_w, dln_b, dW1, db1, dW2, db2 (the JAX kernels
    transposed). Tolerance 1e-4 absolute and relative (the JAX gelu' takes
    the rational erf; column sums over 40 rows); observed max |diff| 1.1e-5."""
    jnp, jmlp = jx.jnp, jx.mlp
    rng = np.random.default_rng(23)
    rows, C, H = 40, 64, 256
    x = rng.normal(size=(rows, C)).astype(np.float32)
    a = _mlp_args(rng, C, H)
    g = rng.normal(size=(rows, C)).astype(np.float32)
    rs = _row_scale(rng, rows, with_scale)
    jrs = None if rs is None else jnp.asarray(rs)
    _, stash = jmlp._xla_reference(jnp.asarray(x), *map(jnp.asarray, a), jrs, 1e-5, gelu,
                                   want_stash=True)
    want = jmlp._xla_backward_stash(jnp.asarray(x), *map(jnp.asarray, a), jrs, stash, 1e-5, gelu,
                                    jnp.asarray(g))[:7]
    z, mean, rstd = (torch.tensor(_np(t)) for t in stash)
    got = ops.ln_mlp_residual_bwd_stash(torch.from_numpy(x), *_torch_mlp_args(a),
                                        None if rs is None else torch.from_numpy(rs),
                                        (z, mean[:, 0], rstd[:, 0]), 1e-5, gelu,
                                        torch.from_numpy(g))
    for i, (p, w) in enumerate(zip(got, want)):
        w = _np(w).T if i in (3, 5) else _np(w)          # dW1, dW2 in torch layout
        np.testing.assert_allclose(p.numpy(), w, atol=1e-4, rtol=1e-4, err_msg=f"grad {i}")


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_mlp_fn_gradients_match_autograd_of_plain(gelu):
    """FusedLnMlpResidualFn's stash backward against autograd through the
    plain forward (with a row scale), fp32. Tolerance 1e-4 absolute and
    relative; observed max |diff| 4.8e-7."""
    rng = np.random.default_rng(24)
    rows, C, H = 24, 32, 128
    x = torch.tensor(rng.normal(size=(rows, C)).astype(np.float32), requires_grad=True)
    params = [t.clone().requires_grad_(True) for t in _torch_mlp_args(_mlp_args(rng, C, H))]
    rs = torch.from_numpy(_row_scale(rng, rows, True))
    g = torch.from_numpy(rng.normal(size=(rows, C)).astype(np.float32))
    leaves = [x, *params]
    got = torch.autograd.grad(
        ops.FusedLnMlpResidualFn.apply(x, *params, rs, 1e-5, gelu, False), leaves, g)
    want = torch.autograd.grad(
        ops.ln_mlp_residual_plain(x, *params, 1e-5, gelu, row_scale=rs), leaves, g)
    for p, w in zip(got, want):
        np.testing.assert_allclose(p.numpy(), w.numpy(), atol=1e-4, rtol=1e-4)


def test_drop_path_keeps_whole_samples_at_the_keep_rate():
    """DropPath zeroes or rescales whole samples by 1/keep, keeps ~keep of
    them (4000 samples: within 5 standard deviations), draws from the
    generator it is given, and is the identity in eval mode."""
    dp = DropPath(0.3).train()
    x = torch.ones(4000, 3, 2)
    out = dp(x, torch.Generator().manual_seed(5))
    per_sample = out.reshape(4000, -1)
    assert torch.all(per_sample == per_sample[:, :1])            # whole samples
    vals = set(per_sample[:, 0].tolist())
    assert vals <= {0.0, torch.tensor(1 / 0.7).item()}
    kept = (per_sample[:, 0] > 0).float().mean().item()
    assert abs(kept - 0.7) < 5 * (0.7 * 0.3 / 4000) ** 0.5
    assert torch.equal(out, dp(x, torch.Generator().manual_seed(5)))
    scale = dp.sample_scale(4000, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(scale, per_sample[:, 0])                  # the same draw
    assert torch.equal(dp.eval()(x), x)
    with pytest.raises(ValueError):
        dp.train()(x, None)


def test_dropout_keeps_elements_at_the_keep_rate():
    x = torch.ones(200, 100)
    out = dropout(x, 0.1, torch.Generator().manual_seed(6), True)
    assert set(out.unique().tolist()) <= {0.0, torch.tensor(1 / 0.9).item()}
    assert abs((out > 0).float().mean().item() - 0.9) < 5 * (0.9 * 0.1 / 20000) ** 0.5
    assert dropout(x, 0.1, None, False) is x
    assert dropout(x, 0.0, None, True) is x


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, ref, atol, rtol):
    """max|got - ref| <= atol + rtol * max|ref|, as chip_smoke.py."""
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= atol + rtol * ref.float().abs().max().item(), err


# the 12-frame window (6, 7, 7): N = 294, stage 1's token dims, 16 windows
_DIMS12, _WIN12, _SHIFT12 = (6, 28, 28), (6, 7, 7), (0, 3, 3)


def _attn12(rng, nH, dev, masked):
    N, nW = 294, 16
    qkv = torch.from_numpy(rng.normal(size=(2 * nW * N, 3 * nH * 32)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(nH, N, N)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(2 * nW * N, nH * 32)).astype(np.float32))
    ids = (torch.from_numpy(pswin._shift_region_ids(_DIMS12, _WIN12, _SHIFT12)).to(dev)
           if masked else None)
    return N, qkv.to(dev, torch.bfloat16), bias, g.to(dev, torch.bfloat16), ids


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_kernel_at_294_on_card(cuda, masked):
    """K1 at the 12-frame window (19 key tiles) against its plain version."""
    N, qkv, bias, _, ids = _attn12(np.random.default_rng(30), 8, cuda, masked)
    got = ops.flat2_window_attention(qkv, bias, ids, 32 ** -0.5, 8, N)
    _close(got, ops.window_attention_plain(qkv, bias, ids, 32 ** -0.5, 8, N), 2e-2, 1e-2)


# K5's card shapes: (Bn, nH, token dims, window, shift) at N = 196 (Bn = 44,
# which the key pass's 9 chunks do not divide), 294 (the 12-frame stage 1
# block, 3 chunks for 32 windows), 392 at the 32-frame step's stage 3 (32
# windows, 32 heads) and 392 on 2 windows of 4 heads, whose key pass has
# fewer blocks (104) than the card has SMs
_BWD_CARD = {"196": (44, 8, (4, 14, 14), (4, 7, 7), (2, 3, 3)),
             "294": (32, 8, _DIMS12, _WIN12, _SHIFT12),
             "392 stage 3": (32, 32, (16, 7, 7), (8, 7, 7), (4, 0, 0)),
             "392 small": (2, 4, (16, 7, 7), (8, 7, 7), (4, 0, 0))}


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", list(_BWD_CARD))
def test_window_attention_bwd_kernel_on_card(cuda, masked, shape):
    """K5 against its plain version (dqkv, and dbias within chip_smoke.py's
    fp32 limit) with a bias of magnitude ~10, the row pass's statistics
    against the plain row pass, one launch counted per call, and dqkv and
    dbias bitwise equal over two calls: each dbias element has one owner
    in the key pass and the finish sums the chunks in a fixed order."""
    Bn, nH, dims, win, shift = _BWD_CARD[shape]
    N = int(np.prod(win))
    rng = np.random.default_rng(31)
    C, scale = nH * 32, 32 ** -0.5
    qkv = torch.from_numpy(rng.normal(size=(Bn * N, 3 * C)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(Bn * N, C)).astype(np.float32)).to(cuda, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(size=(nH, N, N)).astype(np.float32) * 10).to(cuda)
    ids = pswin._shift_region_ids(dims, win, shift) if masked else None
    ids = None if ids is None else torch.from_numpy(ids).to(cuda)
    before = ops.flat2_window_attention_bwd.launches
    dqkv, dbias = ops.flat2_window_attention_bwd(qkv, bias, ids, g, scale, nH, N)
    dqkv2, dbias2 = ops.flat2_window_attention_bwd(qkv, bias, ids, g, scale, nH, N)
    torch.cuda.synchronize()
    assert ops.flat2_window_attention_bwd.launches == before + 2
    want_dqkv, want_dbias = ops.window_attention_bwd_plain(qkv, bias, ids, g, scale, nH, N)
    _close(dqkv, want_dqkv, 2e-2, 2e-2)
    _close(dbias, want_dbias, 0.0, 1e-5)
    assert torch.equal(dbias, dbias2) and torch.equal(dqkv, dqkv2)
    _, _, stats = wa._bwd_launch(qkv, bias, ids, g, scale, nH, N)
    _, want_stats = ops.window_attention_bwd_rows_plain(qkv, bias, ids, g, scale, nH, N)
    _close(stats[:, :, :N], want_stats, 0.0, 1e-5)
    if shape == "196":
        assert Bn % wa._bwd_grid(Bn, nH, N, torch.cuda.get_device_properties(
            cuda).multi_processor_count).chunks


@pytest.mark.gpu
@pytest.mark.parametrize("C", [128, 1024])
def test_ln_mlp_residual_stash_kernel_on_card(cuda, C):
    """K2's stash form against its plain version: out, z, mean, rstd, with
    and without a row scale; rows not a multiple of the row block."""
    rng = np.random.default_rng(32)
    rows = 1000
    x = torch.from_numpy(rng.normal(size=(rows, C)).astype(np.float32)).to(cuda, torch.bfloat16)
    a = [t.to(cuda) for t in _torch_mlp_args(_mlp_args(rng, C, 4 * C))]
    for rs in (None, torch.from_numpy(_row_scale(rng, rows, True)).to(cuda)):
        out, (z, mean, rstd) = ops.fused_ln_mlp_residual_stash(x, *a, 1e-5, "tanh", rs)
        ref, (rz, rmean, rrstd) = ops.ln_mlp_residual_plain(x, *a, 1e-5, "tanh", row_scale=rs,
                                                            want_stash=True)
        _close(out, ref, 2e-2, 2e-2)
        _close(z, rz, 2e-2, 2e-2)
        _close(mean, rmean, 1e-5, 1e-5)
        _close(rstd, rrstd, 1e-5, 1e-5)
    torch.cuda.synchronize()
