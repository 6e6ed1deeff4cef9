"""The fused window-attention half-block (K6) held against the JAX package.

On the CPU ``fused_window_attn_block`` runs its plain version; these tests
feed the same seeded numpy inputs to it and to the JAX kernel as the JAX
tests run it (``attn_block._forward`` in Pallas interpret mode through
``_FORCE_PALLAS``, ``_forward_grouped`` directly), in fp32. The port takes
the shift mask as region ids, the JAX side as its additive or region-lanes
mask for the same dims. Tolerance 2e-5 absolute and relative, fp32
summation-order noise, as K1's plain-vs-Pallas tests have.

The ``gpu`` tests launch K6 at the four Swin-B stage shapes of the 32-frame
eval, and in a Swin block under ``attention_impl='fused_block'`` at 8-frame
stage shapes (N=196, the window-resident layout), and skip without a card. JAX is imported inside the tests that compare
with it (the ``jx`` fixture), so on a machine without JAX the ``gpu`` tests
still run: ``python -m pytest tests/test_torch_attn_block.py -m gpu
--noconftest``.
"""

import dataclasses
import hashlib
import types

import numpy as np
import pytest
import torch

from clover_tpu_torch import ops
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.ops import attn_block as pab
from clover_tpu_torch.ops import window_attention as pwa

TOL = dict(atol=2e-5, rtol=2e-5)
# (token dims, window, shift): a shifted block of the 8-frame-shaped tiny
# stage (N=98, nW=4) and of the 32-frame window 8x7x7 (N=392, nW=8)
SHAPES = {98: ((2, 14, 14), (2, 7, 7), (0, 3, 3)), 392: ((16, 14, 14), (8, 7, 7), (4, 3, 3))}


@pytest.fixture
def jx():
    """The JAX package's modules under test."""
    jnp = pytest.importorskip("jax.numpy")
    import clover_tpu.evaluation.metrics as metrics
    import clover_tpu.models.swin3d as swin
    import clover_tpu.ops.attn_block as ab

    return types.SimpleNamespace(jnp=jnp, swin=swin, ab=ab, metrics=metrics)


def _np(t):
    return np.asarray(t, np.float32)


def _block_args(rng, Bn, N, C, nH):
    """JAX-layout arguments of fused_window_attn_block, mask aside: x (Bn,
    N, C), LN scale / bias, wqkv (C, 3C), bqkv, bias (nH, N, N), wproj (C, C),
    bproj."""
    f = np.float32
    return [rng.normal(size=(Bn, N, C)).astype(f),
            (1 + 0.1 * rng.normal(size=C)).astype(f), (0.1 * rng.normal(size=C)).astype(f),
            (rng.normal(size=(C, 3 * C)) / np.sqrt(C)).astype(f),
            (0.1 * rng.normal(size=3 * C)).astype(f),
            (0.5 * rng.normal(size=(nH, N, N))).astype(f),
            (rng.normal(size=(C, C)) / np.sqrt(C)).astype(f), (0.1 * rng.normal(size=C)).astype(f)]


def _port(a, ids, nH, row_scale=None, scale=32 ** -0.5):
    """The port's plain block on the JAX-layout arguments -> (Bn, N, C)."""
    x, ls, lb, wqkv, bqkv, bias, wp, bp = (torch.from_numpy(v) for v in a)
    Bn, N, C = x.shape
    rs = None if row_scale is None else torch.from_numpy(row_scale)
    out = ops.fused_window_attn_block(x.reshape(-1, C), ls, lb, wqkv.T.contiguous(), bqkv, bias,
                                      ids, wp.T.contiguous(), bp, scale, nH, N, 1e-5, rs)
    return out.reshape(Bn, N, C).numpy()


def _jax(jx, a, mask, row_scale=None, route="forward", no_max=False, scale=32 ** -0.5):
    jnp = jx.jnp
    x, ls, lb, wqkv, bqkv, bias, wp, bp = (jnp.asarray(v) for v in a)
    m = None if mask is None else jnp.asarray(mask)
    rs = None if row_scale is None else jnp.asarray(row_scale)
    fn = jx.ab._forward if route == "forward" else jx.ab._forward_grouped
    out = fn(x, ls, lb, wqkv, bqkv, bias, m, wp, bp, rs, scale, 1e-5, no_max=no_max)
    assert out is not None, "no (W, G) fits the grouped kernel"
    return _np(out)


def _mask_forms(jx, N, mask_form):
    dims, win, sh = SHAPES[N]
    mask = {"none": None, "additive": jx.swin.shift_attn_mask(dims, win, sh),
            "lanes": jx.swin.shift_region_lanes(dims, win, sh)}[mask_form]
    ids = None if mask is None else torch.from_numpy(pswin._shift_region_ids(dims, win, sh))
    return mask, ids


@pytest.mark.parametrize("route", ["forward", "grouped"])
@pytest.mark.parametrize("mask_form", ["none", "additive", "lanes"])
@pytest.mark.parametrize("C,nH", [(64, 2), (128, 4)])
@pytest.mark.parametrize("N", [98, 392])
def test_attn_block_plain_matches_pallas(N, C, nH, mask_form, route, jx, monkeypatch):
    """The plain version against _forward (interpret mode; it runs its own
    kernel, not the grouped one nor the XLA reference) and _forward_grouped
    on one sample's windows."""
    monkeypatch.setattr(jx.ab, "_FORCE_PALLAS", True)
    if route == "forward":
        monkeypatch.setattr(jx.ab, "_forward_grouped",
                            lambda *a, **k: pytest.fail("_forward took the grouped kernel"))
        monkeypatch.setattr(jx.ab, "_xla_reference",
                            lambda *a, **k: pytest.fail("_forward took the XLA reference"))
    dims, win, _ = SHAPES[N]
    nW = int(np.prod([d // w for d, w in zip(dims, win)]))
    a = _block_args(np.random.default_rng(N + C), nW, N, C, nH)
    mask, ids = _mask_forms(jx, N, mask_form)
    np.testing.assert_allclose(_port(a, ids, nH), _jax(jx, a, mask, route=route), **TOL)


def test_attn_block_plain_matches_the_static_shift_kernel(jx, monkeypatch):
    """The JAX eval kernel subtracts a static 30 (130 with region lanes)
    instead of the row max; on bounded logits that is the same softmax."""
    monkeypatch.setattr(jx.ab, "_FORCE_PALLAS", True)
    a = _block_args(np.random.default_rng(20), 8, 392, 128, 4)
    mask, ids = _mask_forms(jx, 392, "lanes")
    np.testing.assert_allclose(_port(a, ids, 4), _jax(jx, a, mask, no_max=True), **TOL)


@pytest.mark.parametrize("route", ["forward", "grouped"])
def test_attn_block_row_scale_matches_pallas(route, jx, monkeypatch):
    """The per-window row scale (DropPath's keep / keep_prob) scales the
    branch, not the residual: a window of scale 0 passes x through."""
    monkeypatch.setattr(jx.ab, "_FORCE_PALLAS", True)
    a = _block_args(np.random.default_rng(21), 8, 98, 64, 2)
    rs = np.array([1.25, 0.0, 1.25, 1.25, 0.0, 1.25, 1.25, 1.25], np.float32)
    mask, ids = _mask_forms(jx, 98, "additive")
    got = _port(a, ids, 2, rs)
    np.testing.assert_allclose(got, _jax(jx, a, mask, rs, route=route), **TOL)
    np.testing.assert_array_equal(got[1], a[0][1])


@pytest.mark.parametrize("masked", [False, True])
def test_attn_block_plain_chunks_are_exact(masked, monkeypatch):
    """The plain version walks the windows in chunks (a multiple of nW, so
    the mask rows line up); small chunks give the same values as one."""
    rng = np.random.default_rng(22)
    dims, win, sh = SHAPES[98]
    a = _block_args(rng, 3 * 4, 98, 64, 2)
    ids = torch.from_numpy(pswin._shift_region_ids(dims, win, sh)) if masked else None
    rs = rng.random(12).astype(np.float32)
    whole = _port(a, ids, 2, rs)
    monkeypatch.setattr(pab, "_PLAIN_LOGITS", 1)        # one nW-group (or window) per chunk
    np.testing.assert_array_equal(_port(a, ids, 2, rs), whole)


def test_plain_chunk_keeps_the_logits_in_budget():
    """Stage 0 of the 32-frame eval at B=32: 4096 windows of 392 tokens,
    nH=4, nW=128: chunks of whole samples under the logits budget."""
    per = pab._window_chunk(4096, 128, 4, 392)
    assert per % 128 == 0 and 4096 % per == 0
    assert per * 4 * 392 * 392 <= pab._PLAIN_LOGITS


def _tiny_block(fused_attn, shifted, C=64, nH=2):
    block = pswin.SwinBlock3D(C, nH, (8, 7, 7), (4, 3, 3) if shifted else (0, 0, 0),
                              fused_attn=fused_attn)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + (1.0 if p.ndim == 1 else 0.0))
    return block.eval()


def _tokens(dims, C=64, seed=4):
    L = int(np.prod(dims))
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(2, L, C)).astype(np.float32))


@pytest.mark.parametrize("shifted", [False, True])
def test_block_fused_on_equals_off(shifted):
    """The block with fused_attn='on' (LN1 + attention + proj + residual in
    one call) equals the same block with 'off', same parameters."""
    dims = (16, 14, 14)
    x = _tokens(dims)
    on, off = _tiny_block("on", shifted), _tiny_block("off", shifted)
    off.load_state_dict(on.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(on(x, dims).numpy(), off(x, dims).numpy(), **TOL)


@pytest.mark.parametrize("dims,fused", [((16, 14, 14), True), ((4, 14, 14), False)])
def test_auto_takes_the_fused_branch_from_384_tokens(dims, fused, monkeypatch):
    """'auto' runs the half-block at the 8x7x7 window (N=392) and the
    unfused path at 4x7x7 (N=196); shown by which plain version the eval
    block's op reaches on the CPU (the K6 op's, or the K1 op's), as launch
    counts stay 0 there."""
    calls = []
    real, real_k1 = pswin.window_attn_block_plain, pwa.window_attention_plain
    monkeypatch.setattr(pab, "window_attn_block_plain",
                        lambda *a, **k: calls.append("fused") or real(*a, **k))
    monkeypatch.setattr(pwa, "window_attention_plain",
                        lambda *a: calls.append("unfused") or real_k1(*a))
    block = _tiny_block("auto", shifted=True)
    with torch.no_grad():
        block(_tokens(dims), dims)
    assert calls == ["fused" if fused else "unfused"]


def test_fused_branch_refuses_training(monkeypatch):
    """In train() mode the fused branch runs (the 32-frame train step, see
    test_torch_train32.py) but, with DropPath active, refuses to run without
    an explicit generator; it does not fall back to the unfused path."""
    dims = (16, 14, 14)
    monkeypatch.setattr(pswin.WindowAttentionFn, "apply",
                        lambda *a: pytest.fail("the fused branch took the unfused path"))
    block = pswin.SwinBlock3D(64, 2, (8, 7, 7), (0, 0, 0), drop_path=0.1).train()
    with pytest.raises(ValueError, match="Generator"):
        block(_tokens(dims), dims)
    out = block(_tokens(dims), dims, generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 16 * 14 * 14, 64) and out.requires_grad


def test_fused_attn_config_is_checked():
    with pytest.raises(ValueError):
        pswin.SwinConfig(fused_attn="1")
    assert dataclasses.replace(pswin.SwinConfig(), fused_attn="off").fused_attn == "off"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_block(dtype):
    """On the CPU the wrapper returns its plain version's values and
    launches nothing, in fp32 and in bf16 (whose products the CPU takes in
    fp32: it has no mixed-dtype mm)."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(23)
    a = [torch.from_numpy(v) for v in _block_args(rng, 4, 98, 64, 2)]
    x, ls, lb, wqkv, bqkv, bias, wp, bp = a
    args = (x.reshape(-1, 64).to(dtype), ls, lb, wqkv.T, bqkv, bias, None, wp.T, bp, 0.2, 2, 98)
    got = ops.fused_window_attn_block(*args)
    assert got.dtype == dtype
    assert torch.equal(got, ops.window_attn_block_plain(*args))
    assert ops.fused_window_attn_block.launches == 0


@pytest.mark.parametrize("captions", ["one_per_video", "varied"])
def test_metrics_copy_matches_jax(captions, jx):
    """The port's copy of the retrieval metrics gives every key of
    clover_tpu.evaluation.metrics, exactly, on the same embeddings."""
    from clover_tpu_torch.evaluation import metrics as pmetrics

    rng = np.random.default_rng(24)
    v = rng.normal(size=(40, 16)).astype(np.float32)
    if captions == "one_per_video":
        t = v + rng.normal(size=v.shape).astype(np.float32)
        t[3] = 0.0                                       # a zero row keeps itself
        assert pmetrics.retrieval_recall(v, t) == jx.metrics.retrieval_recall(v, t)
        scores = rng.normal(size=(40, 40))
        assert (pmetrics.retrieval_recall(input_scores=scores)
                == jx.metrics.retrieval_recall(input_scores=scores))
    else:
        ids = [list(range(n)) for n in rng.integers(1, 4, size=40)]
        t = np.concatenate([v[i] + rng.normal(size=(len(c), 16)) for i, c in enumerate(ids)])
        assert (pmetrics.retrieval_recall_varied(v, t, ids)
                == jx.metrics.retrieval_recall_varied(v, t, ids))


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def card_args(rng, Bn, N, C, dev):
    """bf16 x (Bn*N, C) and fp32 parameters in torch layout, on the card."""
    nH = C // 32
    a = [torch.from_numpy(v) for v in _block_args(rng, Bn, N, C, nH)]
    x, ls, lb, wqkv, bqkv, bias, wp, bp = a
    return (x.reshape(-1, C).to(dev, torch.bfloat16), ls.to(dev), lb.to(dev),
            wqkv.T.contiguous().to(dev), bqkv.to(dev), bias.to(dev), wp.T.contiguous().to(dev),
            bp.to(dev))


# Swin-B at 32 frames: (C, token dims, window, shift) of each stage
STAGES = [(128, (16, 56, 56), (3, 3)), (256, (16, 28, 28), (3, 3)), (512, (16, 14, 14), (3, 3)),
          (1024, (16, 7, 7), (0, 0))]


def _close_on_card(got, ref, what):
    """chip_smoke.py's K6 limit: max|got - ref| <= 2e-2 + 1e-2 max|ref|."""
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 + 1e-2 * ref.float().abs().max().item(), (what, err)


@pytest.mark.gpu
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_attn_block_kernel_on_card(cuda, stage, shifted):
    """K6 against its plain version at a stage shape of the 32-frame eval
    (two samples' windows): bf16 limits as chip_smoke.py's K6. At stages 0
    and 3 each pass also against its plain step on the same inputs: LN1 +
    qkv, K11's attention (its plain version, the online softmax), proj +
    residual with a row scale."""
    C, dims, hw_shift = STAGES[stage]
    win = (8, 7, 7)
    win, sh = pswin.effective_window(dims, win, (4,) + hw_shift)
    nW = int(np.prod([d // w for d, w in zip(dims, win)]))
    Bn = 2 * nW if stage >= 2 else nW // 4
    rng = np.random.default_rng(30 + stage)
    x, ls, lb, wqkv, bqkv, bias, wp, bp = card_args(rng, Bn, 392, C, cuda)
    ids = (torch.from_numpy(pswin._shift_region_ids(dims, win, sh)[:Bn if Bn < nW else nW])
           .to(cuda) if shifted else None)
    args = (x, ls, lb, wqkv, bqkv, bias, ids, wp, bp, 32 ** -0.5, C // 32, 392)
    before = ops.fused_window_attn_block.launches
    got = ops.fused_window_attn_block(*args)
    torch.cuda.synchronize()
    assert ops.fused_window_attn_block.launches == before + 1
    _close_on_card(got, ops.window_attn_block_plain(*args), "K6")
    if stage in (1, 2):
        return
    qkv = pab.ln_qkv_pass(x, ls, lb, wqkv, bqkv)
    _close_on_card(qkv, pab.ln_qkv_plain(x, ls, lb, wqkv, bqkv), "LN1 + qkv")
    o = pab.attention_pass(qkv, bias, ids, 32 ** -0.5, C // 32, 392)
    _close_on_card(o, ops.window_attention_flat_flash_plain(qkv, bias, ids, 32 ** -0.5, C // 32,
                                                             392), "attention")
    rs = torch.from_numpy((rng.random(Bn) < 0.75).astype(np.float32) / 0.75).to(cuda)
    y = pab.proj_pass(o, x, wp, bp, rs, 392)
    torch.cuda.synchronize()
    _close_on_card(y, pab.proj_residual_plain(o, x, wp, bp, rs, 392), "proj + residual")


@pytest.mark.gpu
@pytest.mark.parametrize("stage,groups", [(2, 2), (3, 1)])
def test_attn_block_kernel_in_chunks_on_card(cuda, stage, groups, monkeypatch):
    """A call cut into chunks of ``groups`` nW-groups (the plan's cap set
    low; 5 nW-groups of a shifted 32-frame stage, with a row scale: at stage
    3, nW=2, the chunks' row-scale slices start 8 bytes apart) gives the
    bits of the one-chunk call (each row's LN, products and window are the
    same arithmetic wherever the chunk starts) and stays within the K6
    limit of the plain version; one launch counted a call."""
    C, dims, hw_shift = STAGES[stage]
    win, sh = pswin.effective_window(dims, (8, 7, 7), (4,) + hw_shift)
    ids = torch.from_numpy(pswin._shift_region_ids(dims, win, sh)).to(cuda)
    nW, N = ids.shape[0], 392
    rng = np.random.default_rng(42 + stage)
    x, ls, lb, wqkv, bqkv, bias, wp, bp = card_args(rng, 5 * nW, N, C, cuda)
    rs = torch.from_numpy((rng.random(5 * nW) < 0.75).astype(np.float32) / 0.75).to(cuda)
    args = (x, ls, lb, wqkv, bqkv, bias, ids, wp, bp, 32 ** -0.5, C // 32, N, 1e-5, rs)
    whole = ops.fused_window_attn_block(*args)
    monkeypatch.setattr(pab, "_K6_CHUNK_BYTES", groups * nW * 10 * N * C)
    assert len(pab.k6_plan(5 * nW, N, C, nW)) == -(-5 // groups)
    before = ops.fused_window_attn_block.launches
    got = ops.fused_window_attn_block(*args)
    torch.cuda.synchronize()
    assert ops.fused_window_attn_block.launches == before + 1
    assert torch.equal(got, whole)
    _close_on_card(got, ops.window_attn_block_plain(*args), "K6 in chunks")


@pytest.mark.gpu
def test_attn_block_kernel_row_scale_and_n196_on_card(cuda):
    """The optional row scale, and the 13-key-tile instance (N=196)."""
    rng = np.random.default_rng(40)
    x, ls, lb, wqkv, bqkv, bias, wp, bp = card_args(rng, 16, 196, 256, cuda)
    rs = torch.from_numpy((rng.random(16) < 0.8).astype(np.float32) / 0.8).to(cuda)
    args = (x, ls, lb, wqkv, bqkv, bias, None, wp, bp, 32 ** -0.5, 8, 196, 1e-5, rs)
    got, ref = ops.fused_window_attn_block(*args), ops.window_attn_block_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 + 1e-2 * ref.float().abs().max().item(), err
    dropped = (rs == 0).nonzero().flatten().tolist()
    for w in dropped:
        assert torch.equal(got.view(16, 196, 256)[w], x.view(16, 196, 256)[w])


@pytest.mark.gpu
def test_attn_block_kernel_rejects_what_it_cannot_run(cuda):
    rng = np.random.default_rng(41)
    x, ls, lb, wqkv, bqkv, bias, wp, bp = card_args(rng, 2, 392, 128, cuda)
    with pytest.raises(ValueError):    # fp32 activations: the kernel takes bf16
        ops.fused_window_attn_block(x.float(), ls, lb, wqkv, bqkv, bias, None, wp, bp, 0.2, 4,
                                    392)
    with pytest.raises(ValueError):    # head dim 64
        ops.fused_window_attn_block(x, ls, lb, wqkv, bqkv, bias[:2], None, wp, bp, 0.2, 2, 392)


def k6_digest(dev, stage, shifted):
    """sha256 of K6's output (raw bytes) at a stage shape of the 32-frame
    eval (attn_block_sweep's eval32 calls, every window of the stage), on
    inputs drawn from a seeded CPU generator."""
    from clover_tpu_torch.ops.attn_block_sweep import call_shapes

    _, _, Bn, N, C, nH, ids, _, _ = next(
        c for c in call_shapes() if c[0] == "eval32" and c[1] == stage
        and (c[6] is not None) == shifted)
    g = torch.Generator().manual_seed(100 + 2 * stage + shifted)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    x = randn(Bn * N, C).bfloat16()
    ln_w, ln_b = 1 + randn(C, std=0.1), randn(C, std=0.1)
    wqkv, bqkv = randn(3 * C, C, std=C ** -0.5), randn(3 * C, std=0.1)
    wp, bp = randn(C, C, std=C ** -0.5), randn(C, std=0.1)
    bias = randn(nH, N, N)
    rid = None if ids is None else torch.from_numpy(ids).to(dev)
    out = ops.fused_window_attn_block(x, ln_w, ln_b, wqkv, bqkv, bias, rid, wp, bp,
                                      32 ** -0.5, nH, N)
    return hashlib.sha256(out.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


# k6_digest at each stage shape of the 32-frame eval, unshifted and shifted,
# taken on an NVIDIA H100 80GB HBM3 before the MLP halves' passes moved onto
# the GEMM core (csrc/gemm.cuh) that K6 shares
K6_DIGESTS = {
    (0, False): "c2b2a8d676f72c24430ab9454ac9bec42b513477853d93b9a24ce0ff0d75b278",
    (0, True): "d0ea2b980518331bf534a5360727b9fe87aeed2e2ec4daf8bba948c6e42f8208",
    (1, False): "7c6915d73eb5e99c26de720adef1d2594448a3033d52347204b7612a54c558f8",
    (1, True): "9f3eaaba1154a99839413f763e36fc665ff86a58181e581d5d58e17d906fa306",
    (2, False): "fc3441cf9645832df42c3e03a8b1240f418fc8614d6a70205343146721ea81ab",
    (2, True): "618711e57e8af586ec053826dd74738925e88037bb2d0ab2f978b72c48a548b2",
    (3, False): "a650dc6b201abd76a087712c4cb3a286d9a1220030a638e1ba8375024831afed",
    (3, True): "420d74e1cae412709760e274018f5d51c828150c51fdd0fde8e3e56425508004",
}


@pytest.mark.gpu
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_k6_outputs_keep_their_bits_on_card(cuda, stage, shifted):
    """K6's output at each 32-frame eval stage shape is bitwise the one
    saved in K6_DIGESTS: the GEMM core it shares with K2, K3 and K7 changed
    no bit."""
    assert k6_digest(cuda, stage, shifted) == K6_DIGESTS[stage, shifted]


@pytest.mark.gpu
@pytest.mark.parametrize("stage,shifted", [(0, False), (0, True), (2, True), (3, False)])
def test_fused_block_spatial_path_on_card(cuda, stage, shifted):
    """A Swin-B block under attention_impl='fused_block' at a stage of the
    8-frame eval, on the window-resident layout (two clips): K6 at N=196
    (a shifted block on the permuted windows with the region ids), then K2;
    against the same block with
    kernels=False on the same weights within the sum of K6's and K2's bf16
    limits (chip_smoke.py's TOL), one launch of each."""
    from clover_tpu_torch.models.layers import init_params

    C, side = 128 << stage, 56 >> stage
    dims = (4, side, side)
    shift = (4, 3, 3) if shifted else (0, 0, 0)
    blocks = [pswin.SwinBlock3D(C, C // 32, (8, 7, 7), shift, kernels=k,
                                attention_impl="fused_block").to(cuda).eval() for k in (True, False)]
    init_params(blocks[0], torch.Generator().manual_seed(stage))
    blocks[1].load_state_dict(blocks[0].state_dict())
    g = torch.Generator().manual_seed(50 + stage)
    x = torch.randn(2, *dims, C, generator=g).to(cuda, torch.bfloat16)
    x = pswin.window_partition(x, (4, 7, 7)).reshape(2, -1, C)
    before = (ops.fused_window_attn_block.launches, ops.fused_ln_mlp_residual.launches)
    with torch.no_grad():
        got, ref = (blk(x, dims) for blk in blocks)
    torch.cuda.synchronize()
    assert (ops.fused_window_attn_block.launches, ops.fused_ln_mlp_residual.launches) == (
        before[0] + 1, before[1] + 1)
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert err <= (2e-2 + 1e-2 * scale) + (2e-2 + 2e-2 * scale), err
