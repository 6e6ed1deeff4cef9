"""The port's 32-frame retrieval-finetune train step held against the JAX
package on the CPU.

At 32 frames every Swin block of the finetune step runs the 8x7x7 window
(N=392) through the fused attention half-block in training:
``FusedAttnBlockFn`` (K6 forward with DropPath's per-window row scale; a
backward that recomputes LN1, qkv, ``WindowAttentionFn`` -- K1 and K5 at 25
key tiles -- and proj). On the CPU every wrapper runs its plain version;
these tests feed the same seeded numpy inputs to it and to the JAX function,
in fp32:

- the plain attention and its backward against ``_forward_flat_grouped`` /
  ``_backward_flat_grouped`` (Pallas interpret mode), the head-group kernels
  the TPU runs at N=392, and the chunked plain versions against one chunk;
- ``FusedAttnBlockFn`` against ``jax.vjp`` of
  ``attn_block.fused_window_attn_block`` (interpret mode through
  ``_FORCE_PALLAS``);
- the tiny 32-frame train step (test_torch_bridge's configuration on clips of
  32 x 56^2: token dims (16, 14, 14), the fused half-block in stages 0-1)
  against the JAX ``make_retrieval_train_step`` with
  ``attention_impl='pallas_flat'``;
- the block's routing in train and eval mode, DropPath's per-window scale,
  and ``CloverFinetune``'s device argument.

The ``gpu`` tests launch K1 and K5 at N=392 and K6 with a row scale, and
skip without a card: ``python -m pytest tests/test_torch_train32.py -m gpu
--noconftest`` (JAX is imported inside the tests that compare with it).
"""

import inspect
import types

import numpy as np
import pytest
import torch

from clover_tpu_torch import ops
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.models.layers import init_params
from clover_tpu_torch.ops import attn_block as pab
from clover_tpu_torch.ops import window_attention as pwa

TOL = dict(atol=2e-5, rtol=2e-5)
SCALE = 32 ** -0.5
# a shifted block of the 32-frame window: token dims (16, 14, 14), window
# 8x7x7, shift (4, 3, 3): N = 392, nW = 8
DIMS, WIN, SHIFT = (16, 14, 14), (8, 7, 7), (4, 3, 3)
N392, NW = 392, 8


@pytest.fixture
def jx():
    """The JAX package's modules under test."""
    jnp = pytest.importorskip("jax.numpy")
    import jax

    import clover_tpu.models.swin3d as swin
    import clover_tpu.ops.attn_block as ab
    import clover_tpu.ops.window_attention as wa

    return types.SimpleNamespace(jax=jax, jnp=jnp, swin=swin, ab=ab, wa=wa)


def _np(t):
    return np.asarray(t, np.float32)


def _attn_inputs(rng, nH, Bn=NW, N=N392):
    C = nH * 32
    qkv = rng.normal(size=(Bn * N, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(nH, N, N)).astype(np.float32)
    g = rng.normal(size=(Bn * N, C)).astype(np.float32)
    return qkv, bias, g


def _mask(jx, masked):
    """(JAX additive mask (nW, N, N), the port's region ids (nW, N)) or Nones."""
    if not masked:
        return None, None
    return (jx.jnp.asarray(jx.swin.shift_attn_mask(DIMS, WIN, SHIFT)),
            torch.from_numpy(pswin._shift_region_ids(DIMS, WIN, SHIFT)))


# ------------------------------------------- (a), (b): the head-group kernels

@pytest.mark.parametrize("nH", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_attention_matches_forward_flat_grouped(masked, nH, jx):
    """window_attention_plain against the interpret-mode
    ``_forward_flat_grouped`` (row #6) at N=392, one sample's 8 windows.
    Tolerance 2e-5 absolute and relative (fp32 summation order)."""
    qkv, bias, _ = _attn_inputs(np.random.default_rng(60 + nH), nH)
    jm, ids = _mask(jx, masked)
    jnp = jx.jnp
    want = jx.wa._forward_flat_grouped(jnp.asarray(qkv).reshape(NW, N392, -1),
                                       jnp.asarray(bias), jm, SCALE, nH)
    assert want is not None, "no (W, G) fits the grouped kernel"
    got = ops.window_attention_plain(torch.from_numpy(qkv), torch.from_numpy(bias), ids, SCALE,
                                     nH, N392)
    np.testing.assert_allclose(got.numpy(), _np(want).reshape(got.shape), **TOL)


@pytest.mark.parametrize("nH", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_attention_bwd_matches_backward_flat_grouped(masked, nH, jx):
    """window_attention_bwd_plain against the interpret-mode
    ``_backward_flat_grouped`` (row #15) at N=392: dqkv and dbias (summed over
    8 windows). Tolerance 2e-5 absolute and relative."""
    qkv, bias, g = _attn_inputs(np.random.default_rng(62 + nH), nH)
    jm, ids = _mask(jx, masked)
    jnp = jx.jnp
    want = jx.wa._backward_flat_grouped(jnp.asarray(qkv).reshape(NW, N392, -1),
                                        jnp.asarray(bias), jm, SCALE, nH,
                                        jnp.asarray(g).reshape(NW, N392, -1), no_max=False)
    assert want is not None, "no (W, G) fits the grouped backward"
    dqkv, dbias = ops.window_attention_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(bias),
                                                 ids, torch.from_numpy(g), SCALE, nH, N392)
    np.testing.assert_allclose(dqkv.numpy(), _np(want[0]).reshape(dqkv.shape), **TOL)
    np.testing.assert_allclose(dbias.numpy(), _np(want[1]), **TOL)


# -------------------------------------------------- (c): the chunked versions

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_plain_chunks_match_one_chunk(direction, masked, monkeypatch):
    """The plain attention and its backward walk the windows in chunks of
    whole nW-groups; one group per chunk gives the unchunked values: out and
    dqkv bitwise, dbias (summed over chunks in fp32, another order) within
    1e-6 of its largest value (observed 3e-7)."""
    rng = np.random.default_rng(64)
    nH, Bn = 2, 3 * NW
    qkv, bias, g = (torch.from_numpy(a) for a in _attn_inputs(rng, nH, Bn))
    ids = torch.from_numpy(pswin._shift_region_ids(DIMS, WIN, SHIFT)) if masked else None
    args = (qkv, bias, ids) if direction == "forward" else (qkv, bias, ids, g)
    fn = ops.window_attention_plain if direction == "forward" else ops.window_attention_bwd_plain
    whole = fn(*args, SCALE, nH, N392)
    monkeypatch.setattr(pwa, "_PLAIN_LOGITS", 1)
    assert pwa.window_chunk(Bn, NW, nH, N392) == NW
    chunked = fn(*args, SCALE, nH, N392)
    if direction == "forward":
        assert torch.equal(chunked, whole)
    else:
        assert torch.equal(chunked[0], whole[0])
        err = (chunked[1] - whole[1]).abs().max().item()
        assert err <= 1e-6 * whole[1].abs().max().item(), err


def test_plain_chunk_at_the_32_frame_train_shapes():
    """Stage 0 of the 32-frame train step at B=16 (2048 windows, nW=128,
    nH=4) and stage 2 (128 windows, nW=8, nH=16): chunks of whole samples,
    dividing the windows, logits under the budget."""
    for Bn, nW, nH in ((2048, 128, 4), (128, 8, 16)):
        per = pwa.window_chunk(Bn, nW, nH, N392)
        assert per % nW == 0 and Bn % per == 0 and per < Bn
        assert per * nH * N392 * N392 <= pwa._PLAIN_LOGITS
    assert pwa.window_chunk(16, 8, 2, 6) == 16          # small windows: one chunk


# ------------------------------------------------------ (d): the autograd form

def _block_args(rng, Bn, N, C, nH):
    """JAX-layout arguments of fused_window_attn_block, mask aside (as
    test_torch_attn_block)."""
    f = np.float32
    return [rng.normal(size=(Bn, N, C)).astype(f),
            (1 + 0.1 * rng.normal(size=C)).astype(f), (0.1 * rng.normal(size=C)).astype(f),
            (rng.normal(size=(C, 3 * C)) / np.sqrt(C)).astype(f),
            (0.1 * rng.normal(size=3 * C)).astype(f),
            (0.5 * rng.normal(size=(nH, N, N))).astype(f),
            (rng.normal(size=(C, C)) / np.sqrt(C)).astype(f), (0.1 * rng.normal(size=C)).astype(f)]


# (token dims, window, shift) per N: a shifted block of the tiny 4-frame
# stage (N=98, nW=4) and of the 32-frame window (N=392, nW=8)
SHAPES = {98: ((2, 14, 14), (2, 7, 7), (0, 3, 3)), 392: (DIMS, WIN, SHIFT)}


@pytest.mark.parametrize("row_scale", [False, True])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("N", [98, 392])
def test_fused_attn_block_fn_matches_jax_vjp(N, shifted, row_scale, jx, monkeypatch):
    """FusedAttnBlockFn (plain forward, plain recompute) against jax.vjp of
    ``fused_window_attn_block`` (its Pallas forward in interpret mode, its
    custom vjp recomputing ``_composed_reference`` through the Pallas flat
    attention backward): the output and the gradients to x, LN1 scale and
    bias, wqkv, bqkv, the bias, wproj and bproj, each within 2e-5 of its
    largest value. A window of row scale 0 passes x and g through."""
    monkeypatch.setattr(jx.ab, "_FORCE_PALLAS", True)
    jnp = jx.jnp
    dims, win, sh = SHAPES[N]
    nW = int(np.prod([d // w for d, w in zip(dims, win)]))
    C, nH, Bn = 64, 2, 2 * nW
    rng = np.random.default_rng(N + 2 * shifted + row_scale)
    a = _block_args(rng, Bn, N, C, nH)
    g = rng.normal(size=(Bn, N, C)).astype(np.float32)
    rs = (np.where(np.arange(Bn) % 3 == 1, 0.0, 1 / 0.9).astype(np.float32)
          if row_scale else None)
    mask = jnp.asarray(jx.swin.shift_attn_mask(dims, win, sh)) if shifted else None
    ids = torch.from_numpy(pswin._shift_region_ids(dims, win, sh)) if shifted else None

    x, ls, lb, wqkv, bqkv, bias, wp, bp = (jnp.asarray(v) for v in a)

    def f(x, ls, lb, wqkv, bqkv, bias, wp, bp):
        return jx.ab.fused_window_attn_block(x, ls, lb, wqkv, bqkv, bias, mask, wp, bp,
                                             None if rs is None else jnp.asarray(rs),
                                             SCALE, 1e-5)

    want_out, vjp = jx.jax.vjp(f, x, ls, lb, wqkv, bqkv, bias, wp, bp)
    want = [_np(t) for t in vjp(jnp.asarray(g))]

    tx, tls, tlb, twq, tbq, tbias, twp, tbp = (torch.from_numpy(v) for v in a)
    leaves = [tx.reshape(-1, C), tls, tlb, twq.T.contiguous(), tbq, tbias, twp.T.contiguous(),
              tbp]
    leaves = [t.clone().requires_grad_() for t in leaves]
    out = ops.FusedAttnBlockFn.apply(*leaves[:6], ids, *leaves[6:],
                                     None if rs is None else torch.from_numpy(rs),
                                     SCALE, nH, N, 1e-5, False)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).reshape(-1, C))
    got = [t.numpy() for t in got]
    got[0] = got[0].reshape(Bn, N, C)
    got[3], got[6] = got[3].T, got[6].T                  # torch Linear layout -> JAX kernels
    pairs = [("out", out.detach().numpy().reshape(Bn, N, C), _np(want_out))]
    pairs += list(zip(("dx", "dln_w", "dln_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj"),
                      got, want))
    for name, p, w in pairs:
        err = float(np.abs(p - w).max())
        assert err <= 2e-5 * float(np.abs(w).max()), f"{name}: {err} vs max {np.abs(w).max()}"
    if row_scale:
        dropped = np.flatnonzero(rs == 0)
        np.testing.assert_array_equal(pairs[0][1][dropped], a[0][dropped])
        np.testing.assert_array_equal(got[0][dropped], g[dropped])


# ------------------------------------------- (e): the tiny 32-frame train step

LR, TOTAL, WARMUP, CLIP = 1e-3, 20, 2, 1.0   # as test_torch_train
B32, T32, S32, L32 = 2, 32, 56, 8


def _batch32(seed):
    from clover_tpu_torch.ops.preprocess import space_to_depth_host

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(B32, T32, S32, S32, 3), dtype=np.uint8)
    tok = rng.integers(1000, 30522, size=(B32, L32)).astype(np.int32)
    mask = np.ones((B32, L32), np.int32)
    mask[1, 5:] = 0
    return {"imgs": np.ascontiguousarray(space_to_depth_host(frames)[:, None]),
            "token_ids": tok, "input_mask": mask}


def _tiny_port_model(params=None):
    """The tiny port model on the CPU, no dropout, with the JAX weights."""
    from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig, SwinConfig,
                                         load_jax_params)
    from test_torch_bridge import BERT, SWIN

    pm = CloverFinetune(FinetuneConfig(
        swin=SwinConfig(drop_path_rate=0.0, **SWIN),
        text_bert=BertConfig(hidden_dropout=0.0, attention_dropout=0.0, **BERT)),
        device="cpu")
    if params is not None:
        load_jax_params(pm, params)
    return pm


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def train32():
    """The JAX reference at 32 frames: weights, batch 0's loss and gradients
    (jax.value_and_grad of the retrieval loss) and 2 steps of
    make_retrieval_train_step, with the fused half-block's Pallas kernel in
    interpret mode; every call counted at (Bn, N, C)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import clover_tpu.ops.attn_block as AB
    from clover_tpu.engine import TrainState as JTrainState
    from clover_tpu.engine import make_optimizer as jmake_optimizer
    from clover_tpu.engine.steps import make_retrieval_train_step as jmake_step
    from clover_tpu.losses.objectives import retrieval_loss as jretrieval_loss
    from clover_tpu.models import BertConfig as JBertConfig
    from clover_tpu.models import CloverFinetune as JCloverFinetune
    from clover_tpu.models import FinetuneConfig as JFinetuneConfig
    from clover_tpu.models import SwinConfig as JSwinConfig
    from test_torch_bridge import BERT, SWIN, random_jax_params

    jm = JCloverFinetune(JFinetuneConfig(
        swin=JSwinConfig(embed_impl="host_s2d", attention_impl="pallas_flat",
                         drop_path_rate=0.0, **SWIN),
        text_bert=JBertConfig(hidden_dropout=0.0, attention_dropout=0.0, **BERT),
        task="retrieval"), dtype=jnp.float32)
    batches = [_batch32(s) for s in range(2)]
    b0 = batches[0]
    params = random_jax_params(jm, b0["imgs"], b0["token_ids"], b0["input_mask"])["params"]
    mp = pytest.MonkeyPatch()
    mp.setattr(AB, "_FORCE_PALLAS", True)
    calls = []
    real = AB._forward
    mp.setattr(AB, "_forward", lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    key = jax.random.PRNGKey(0)
    try:
        def loss_fn(p, batch):
            v, t = jm.apply({"params": p}, batch, train=True, rngs={"dropout": key})
            return jretrieval_loss(v, t, temperature=0.05, cos_sim=True)["retrieval_nce_loss"]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, b0)
        tx, _ = jmake_optimizer(params, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
        state = JTrainState.create(params, tx)
        step = jax.jit(jmake_step(jm, jit=False, grad_clip_norm=CLIP))
        history = []
        for b in batches:
            state, metrics = step(state, b, key)
            history.append(jax.device_get((metrics, state.params)))
    finally:
        mp.undo()
    return dict(params=jax.device_get(params), batches=batches, loss=float(loss),
                grads=jax.device_get(grads), history=history, jax_fused_calls=calls)


def test_train32_one_step_gradients_match_jax(train32, monkeypatch):
    """forward_train + the retrieval loss + backward in train() mode at 32
    frames against jax.value_and_grad (the JAX reference itself took the
    fused half-block in stages 0-1): loss and global gradient norm within
    1e-5 relative, each parameter's gradient within 2e-4 * max|its JAX
    gradient| + 1e-7, test_torch_train's tolerances. The port's stage 0-1
    blocks go through FusedAttnBlockFn."""
    from clover_tpu_torch.losses import retrieval_loss, total_loss
    from clover_tpu_torch.models import state_from_jax

    assert sorted({tuple(s[1:]) for s in train32["jax_fused_calls"]}) == [(392, 64), (392, 128)]
    n = []
    real = pswin.FusedAttnBlockFn.apply
    monkeypatch.setattr(pswin.FusedAttnBlockFn, "apply",
                        lambda *a: n.append(a[12]) or real(*a))
    pm = _tiny_port_model(train32["params"]).train()
    v, t = pm.forward_train(_torch_batch(train32["batches"][0]), torch.Generator())
    loss = total_loss(retrieval_loss(v, t, temperature=0.05, cos_sim=True))
    loss.backward()
    assert n == [392] * 4
    assert loss.item() == pytest.approx(train32["loss"], rel=1e-5)
    want = state_from_jax(train32["grads"])
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want.values()))
    got_norm = np.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in pm.parameters()))
    assert got_norm == pytest.approx(gnorm, rel=1e-5)
    for name, p in pm.named_parameters():
        w = want[name]
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 2e-4 * np.abs(w).max() + 1e-7, f"{name}: {err} vs max {np.abs(w).max()}"


def test_train32_steps_match_jax(train32):
    """2 steps of make_retrieval_train_step (AdamW, warmup, clip at 1.0) at
    32 frames against the JAX step: per step loss and grad_norm within 1e-4
    relative, the parameters after step 1 within 1e-5 absolute (the
    attention key biases within 3 lr), as test_torch_train; after step 2,
    whose gradients are taken at parameters that already differ, within
    2e-5, 2% of the largest single update (observed 1.24e-5)."""
    from clover_tpu_torch.engine import TrainState, make_optimizer, make_retrieval_train_step
    from test_torch_train import _assert_params_close

    pm = _tiny_port_model(train32["params"])
    optimizer, schedule = make_optimizer(pm, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
    state = TrainState.create(pm, optimizer, schedule)
    step = make_retrieval_train_step(pm, grad_clip_norm=CLIP)
    for i, (b, (want, params)) in enumerate(zip(train32["batches"], train32["history"])):
        state, metrics = step(state, _torch_batch(b), torch.Generator().manual_seed(0))
        for k in ("retrieval_nce_loss", "loss", "grad_norm"):
            assert metrics[k].item() == pytest.approx(float(want[k]), rel=1e-4), k
        _assert_params_close(pm, params, 1e-5 * (i + 1), f"after step {i + 1}")
    assert state.step == 2


# ------------------------------------------------ (f), (g): routing, DropPath

def _tiny_block(shifted, drop_path=0.0, C=64, nH=2):
    block = pswin.SwinBlock3D(C, nH, WIN, SHIFT if shifted else (0, 0, 0), drop_path=drop_path)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + (1.0 if p.ndim == 1 else 0.0))
    return block


def _tokens(B=2, C=64, seed=4):
    L = int(np.prod(DIMS))
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(B, L, C)).astype(np.float32))


def test_train_mode_routes_through_the_fused_fn_and_eval_through_one_k6_call(monkeypatch):
    """train(): the fused branch calls FusedAttnBlockFn once per block in the
    forward and WindowAttentionFn once in its backward (the recompute); no
    K6 wrapper call carries autograd. eval(): one call of the K6 op (its
    registered form, ``library.k6_window_attn_block``), no FusedAttnBlockFn,
    no WindowAttentionFn, and an output without a graph."""
    calls = []

    def counting(key, fn):
        def wrapped(*a, **k):
            calls.append(key)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(pswin.FusedAttnBlockFn, "apply",
                        counting("fused_fn", pswin.FusedAttnBlockFn.apply))
    monkeypatch.setattr(pab.WindowAttentionFn, "apply",
                        counting("attn_fn", pab.WindowAttentionFn.apply))
    monkeypatch.setattr(pab, "fused_window_attn_block", counting("K6", pab.fused_window_attn_block))
    monkeypatch.setattr(pswin.library, "k6_window_attn_block",
                        counting("K6 op", pswin.library.k6_window_attn_block))
    block = _tiny_block(shifted=True).train()
    x = _tokens().requires_grad_()
    out = block(x, DIMS, generator=torch.Generator().manual_seed(0))
    assert calls == ["fused_fn", "K6"]
    out.square().sum().backward()
    assert calls == ["fused_fn", "K6", "attn_fn"]
    assert block.attn.relative_position_bias_table.grad.abs().sum() > 0
    assert block.norm1.weight.grad is not None and x.grad is not None
    calls.clear()
    block.eval()
    with torch.no_grad():
        out = block(_tokens(), DIMS)
    assert calls == ["K6 op"] and not out.requires_grad


def test_drop_path_row_scale_is_one_draw_per_sample(monkeypatch):
    """In training the fused half's DropPath is a per-window row scale: the
    (B,) per-sample draw from the generator (the same draw as
    DropPath.sample_scale) repeated over each sample's windows, each factor
    0 or 1/keep; the same generator seed gives the same draw."""
    seen = []
    real = pswin.FusedAttnBlockFn.apply
    monkeypatch.setattr(pswin.FusedAttnBlockFn, "apply",
                        lambda *a: seen.append(a[9]) or real(*a))
    block = _tiny_block(shifted=False, drop_path=0.5).train()
    B, nW = 8, 8
    x = _tokens(B)
    with torch.no_grad():
        block(x, DIMS, generator=torch.Generator().manual_seed(7))
        block(x, DIMS, generator=torch.Generator().manual_seed(7))
    rs = seen[0]
    assert rs.shape == (B * nW,) and rs.dtype == torch.float32
    assert torch.equal(rs, seen[1])
    per_sample = rs.view(B, nW)
    assert torch.all(per_sample == per_sample[:, :1])
    assert set(per_sample[:, 0].tolist()) == {0.0, 2.0}
    draw = block.drop_path.sample_scale(B, torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(per_sample[:, 0], draw)


# ----------------------------------------------------- (h): the device default

def test_finetune_builds_on_the_device_asked_for():
    """device='cpu' builds every parameter on the CPU; the default asks for
    the card."""
    from clover_tpu_torch.models import CloverFinetune

    pm = _tiny_port_model()
    assert {p.device.type for p in pm.parameters()} == {"cpu"}
    assert inspect.signature(CloverFinetune).parameters["device"].default == "cuda"


def test_default_device_without_a_card_raises(monkeypatch):
    """With no card the default construction raises and names the way out;
    it does not build on the CPU in silence."""
    from clover_tpu_torch.models import CloverFinetune, FinetuneConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CloverFinetune(FinetuneConfig())


def test_init_params_draws_on_the_generator_device():
    """init_params draws every value on the generator's device and copies
    it to the parameter: the same seed gives the same weights (another seed
    other weights), with the initializers' ranges; the card's half of the
    claim is test_init_params_same_on_card_and_cpu."""
    a, b = _tiny_port_model(), _tiny_port_model()
    init_params(a, torch.Generator().manual_seed(5))
    init_params(b, torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    table = a.backbone.stage_0_block_0.attn.relative_position_bias_table
    assert 0 < table.abs().max() <= 0.04                    # trunc normal, 2 std
    init_params(b, torch.Generator().manual_seed(6))
    assert not torch.equal(b.backbone.stage_0_block_0.attn.qkv.weight,
                           a.backbone.stage_0_block_0.attn.qkv.weight)


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


def _card_attn(rng, nH, dev, masked, samples=2):
    qkv, bias, g = _attn_inputs(rng, nH, samples * NW)
    ids = torch.from_numpy(pswin._shift_region_ids(DIMS, WIN, SHIFT)).to(dev) if masked else None
    return (torch.from_numpy(qkv).to(dev, torch.bfloat16), torch.from_numpy(bias).to(dev),
            torch.from_numpy(g).to(dev, torch.bfloat16), ids)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_kernel_at_392_on_card(cuda, masked):
    """K1 at 25 key tiles against its plain version (chip_smoke.py's K1
    limits)."""
    qkv, bias, _, ids = _card_attn(np.random.default_rng(70), 16, cuda, masked)
    before = ops.flat2_window_attention.launches
    got = ops.flat2_window_attention(qkv, bias, ids, SCALE, 16, N392)
    torch.cuda.synchronize()
    assert ops.flat2_window_attention.launches == before + 1
    _close(got, ops.window_attention_plain(qkv, bias, ids, SCALE, 16, N392), 2e-2, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_bwd_kernel_at_392_on_card(cuda, masked):
    """K5 at 25 key tiles against its plain version: dqkv (bf16 limits) and
    dbias (fp32, rtol 1e-5), dbias bitwise equal over two runs."""
    qkv, bias, g, ids = _card_attn(np.random.default_rng(71), 16, cuda, masked)
    dqkv, dbias = ops.flat2_window_attention_bwd(qkv, bias, ids, g, SCALE, 16, N392)
    dqkv2, dbias2 = ops.flat2_window_attention_bwd(qkv, bias, ids, g, SCALE, 16, N392)
    torch.cuda.synchronize()
    want_dqkv, want_dbias = ops.window_attention_bwd_plain(qkv, bias, ids, g, SCALE, 16, N392)
    _close(dqkv, want_dqkv, 2e-2, 2e-2)
    _close(dbias, want_dbias, 0.0, 1e-5)
    assert torch.equal(dbias, dbias2) and torch.equal(dqkv, dqkv2)


@pytest.mark.gpu
def test_attn_block_kernel_row_scale_at_392_on_card(cuda):
    """K6 at N=392 with a row scale (windows of 0 and 1/0.9) against its
    plain version; a dropped window passes x through."""
    rng = np.random.default_rng(72)
    C, nH, Bn = 256, 8, 2 * NW
    a = [torch.from_numpy(v) for v in _block_args(rng, Bn, N392, C, nH)]
    x, ls, lb, wqkv, bqkv, bias, wp, bp = a
    ids = torch.from_numpy(pswin._shift_region_ids(DIMS, WIN, SHIFT)).to(cuda)
    rs = torch.from_numpy(np.where(np.arange(Bn) % 3 == 1, 0.0, 1 / 0.9).astype(np.float32))
    args = (x.reshape(-1, C).to(cuda, torch.bfloat16), ls.to(cuda), lb.to(cuda),
            wqkv.T.contiguous().to(cuda), bqkv.to(cuda), bias.to(cuda), ids,
            wp.T.contiguous().to(cuda), bp.to(cuda), SCALE, nH, N392, 1e-5, rs.to(cuda))
    got, ref = ops.fused_window_attn_block(*args), ops.window_attn_block_plain(*args)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, 1e-2)
    for w in np.flatnonzero(rs.numpy() == 0):
        assert torch.equal(got.view(Bn, N392, C)[w], args[0].view(Bn, N392, C)[w])


@pytest.mark.gpu
def test_init_params_same_on_card_and_cpu(cuda):
    """The same seed gives the same weights on the card as on the CPU."""
    from clover_tpu_torch.models import CloverFinetune, FinetuneConfig

    cpu = CloverFinetune(FinetuneConfig(), device="cpu")
    card = CloverFinetune(FinetuneConfig())
    assert {p.device.type for p in card.parameters()} == {"cuda"}
    init_params(cpu, torch.Generator().manual_seed(0))
    init_params(card, torch.Generator().manual_seed(0))
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        assert torch.equal(p, q.cpu()), name
