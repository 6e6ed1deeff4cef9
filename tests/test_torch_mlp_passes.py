"""K2 (the Swin LN2 + MLP + residual half) and K3 / K3M (the BERT post-LN
FFN) as their passes, on the CPU and, marked ``gpu``, on the card.

On the card the MLP halves run as passes over chunks of rows
(``mlp_block.k2_plan``): K2 as LN rows, the fc1 GEMM (GELU, in the stash
form also z) and the fc2 GEMM (b2, the row scale, the residual); K3 / K3M
as the fc1 GEMM on x, the fc2 GEMM into an fp32 partial, and the finish
(LayerNorm, K3M's mask). ``ln_mlp_residual_passes``
and ``mlp_postln_passes`` walk the chunks and run each pass's plain step on
CPU tensors, so these tests hold the chunking, the slices and the steps'
order on the CPU: against the public functions' plain versions
(``ln_mlp_residual_plain``, ``mlp_postln_plain``, ``mlp_postln_mask_plain``)
in fp32 within 1e-5, chunk counts against each other bitwise, and against
the JAX kernels in Pallas interpret mode (``_FORCE_PALLAS``, as
``tests/test_torch_ops.py`` runs them) and the JAX ``_xla_reference``
within the 5e-5 / 2e-5 used there.

The ``gpu`` tests launch the passes and skip without a card; JAX is
imported only in the tests that compare with it, so on a machine without
JAX they run: ``python -m pytest tests/test_torch_mlp_passes.py -m gpu -q
--noconftest``.
"""

import numpy as np
import pytest
import torch

from clover_tpu_torch import ops
from clover_tpu_torch.ops import mlp_block as mb
from clover_tpu_torch.ops.mlp_sweep import call_shapes

FP32 = dict(atol=1e-5, rtol=1e-5)


def _weights(rng, C, H):
    """Torch-layout fp32 parameters: LN scale / bias, W1 (H, C), b1, W2 (C,
    H), b2."""
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32) * f + o) for s, f, o in
            [(C, 0.1, 1.0), (C, 0.1, 0.0), ((H, C), C ** -0.5, 0.0), (H, 0.1, 0.0),
             ((C, H), H ** -0.5, 0.0), (C, 0.1, 0.0)]]


def _case(seed, rows, C, H, with_rs=False, with_mask=False):
    """fp32 x (rows, C), the parameters, a DropPath row scale (keep 0.8) and
    a {0, 1/0.9} hidden-dropout mask, each None when not asked for."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(rows, C)).astype(np.float32))
    w = _weights(rng, C, H)
    rs = torch.from_numpy((rng.random(rows) < 0.8).astype(np.float32) / 0.8) if with_rs else None
    mask = (torch.from_numpy((rng.random((rows, C)) < 0.9).astype(np.float32) / 0.9)
            if with_mask else None)
    return x, w, rs, mask


def _cap_for(rows, C, H, chunks):
    """A chunk cap that cuts ``rows`` into ``chunks`` chunks of whole tiles."""
    per = -(-(-(-rows // chunks)) // mb._K2_TILE) * mb._K2_TILE
    return per * 2 * (C + H)


def _chunks(monkeypatch, rows, C, H, chunks):
    """Set the plan's caps so that a K2 or K3 call of ``rows`` rows runs in
    ``chunks`` chunks (K2's hidden bound lifted to the whole call's h)."""
    monkeypatch.setattr(mb, "_K2_HIDDEN_OVER_X", H // C)
    monkeypatch.setattr(mb, "_K2_CHUNK_BYTES", _cap_for(rows, C, H, chunks))
    assert len(mb.k2_plan(rows, C, H, mb._K2_HIDDEN_OVER_X)) == chunks


@pytest.mark.parametrize("call", call_shapes(), ids=lambda c: f"{c[1]}-{c[0]}-{c[2]}")
def test_plan_takes_every_row_once_under_the_cap(call):
    """Chunks in order covering the rows once, each but the last a whole
    number of tiles, each under the cap (its y and h, 2 (C + H) bytes a
    row) and, for K2's forms, its h under _K2_HIDDEN_OVER_X times the
    call's x; as few as the caps allow, each but the last the fewest whole
    tiles that keep that count."""
    _, form, _, rows, C, H, _, _ = call
    bound = mb._K2_HIDDEN_OVER_X if form.startswith("K2") else None
    plan = mb.k2_plan(rows, C, H, bound)
    starts, sizes = [r0 for r0, _ in plan], [n for _, n in plan]
    assert starts == list(np.cumsum([0] + sizes[:-1])) and sum(sizes) == rows
    assert all(n % mb._K2_TILE == 0 for n in sizes[:-1]) and min(sizes) > 0
    assert all(2 * (C + H) * n <= mb._K2_CHUNK_BYTES for n in sizes)
    per = mb._K2_CHUNK_BYTES // (2 * (C + H))
    if bound is not None:
        assert all(n * H <= bound * rows * C for n in sizes)
        per = min(per, bound * rows * C // H)
    T = mb._K2_TILE
    assert len(plan) == (1 if per >= rows else -(-rows // max(T, per // T * T)))
    assert all(n == sizes[0] for n in sizes[:-1]) and sizes[-1] <= sizes[0]
    assert sizes[0] == min(rows, -(-(-(-rows // len(plan))) // T) * T)


@pytest.mark.parametrize("want_stash", [False, True])
@pytest.mark.parametrize("with_rs", [False, True])
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_k2_passes_compose_to_the_plain_half(gelu, with_rs, want_stash, monkeypatch):
    """LN rows, fc1 and fc2 over three chunks give ln_mlp_residual_plain's
    out and, in the stash form, its z, mean and rstd, in fp32 within 1e-5."""
    rows, C, H = 700, 64, 256
    x, w, rs, _ = _case(1, rows, C, H, with_rs)
    _chunks(monkeypatch, rows, C, H, 3)
    got = mb.ln_mlp_residual_passes(x, *w, 1e-5, gelu, rs, want_stash)
    want = mb.ln_mlp_residual_plain(x, *w, 1e-5, gelu, rs, want_stash)
    if not want_stash:
        got, want = (got, ()), (want, ())
    torch.testing.assert_close(got[0], want[0], **FP32)
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, **FP32)


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("with_mask", [False, True])
def test_k3_passes_compose_to_the_plain_ffn(with_mask, chunks, monkeypatch):
    """fc1 on x, fc2 into an fp32 partial and the finish over 1, 2 or 3
    chunks give mlp_postln_plain (K3) and mlp_postln_mask_plain (K3M), fp32
    within 1e-5."""
    rows, C, H = 300, 128, 512
    x, w, _, mask = _case(2, rows, C, H, with_mask=with_mask)
    _chunks(monkeypatch, rows, C, H, chunks)
    got = mb.mlp_postln_passes(x, *w, mask, 1e-12)
    want = (mb.mlp_postln_mask_plain(x, *w, mask, 1e-12) if with_mask
            else mb.mlp_postln_plain(x, *w, 1e-12))
    torch.testing.assert_close(got, want, **FP32)


@pytest.mark.parametrize("chunks", [2, 3, 5])
@pytest.mark.parametrize("form", ["K2S", "K3M"])
def test_a_call_in_chunks_keeps_its_bits(form, chunks, monkeypatch):
    """A call cut into 2, 3 or 5 chunks gives the bits of the one-chunk
    call: a row's LN, products and finish do not depend on its chunk."""
    rows = 1100
    C, H = (64, 256) if form == "K2S" else (128, 512)
    x, w, rs, mask = _case(3, rows, C, H, form == "K2S", form == "K3M")
    x = x.bfloat16()

    def run():
        if form == "K2S":
            out, stash = mb.ln_mlp_residual_passes(x, *w, 1e-5, "tanh", rs, True)
            return (out, *stash)
        return (mb.mlp_postln_passes(x, *w, mask, 1e-12),)

    _chunks(monkeypatch, rows, C, H, 1)
    whole = run()
    _chunks(monkeypatch, rows, C, H, chunks)
    assert all(torch.equal(a, b) for a, b in zip(run(), whole))


@pytest.fixture
def jx():
    """The JAX package's MLP module and jax.numpy."""
    jnp = pytest.importorskip("jax.numpy")
    import clover_tpu.ops.mlp_block as mlp

    return jnp, mlp


def _jax_args(jnp, x, w):
    """x and the parameters in the JAX layout (kernels (C, H) / (H, C))."""
    s, b, w1, b1, w2, b2 = (t.numpy() for t in w)
    return [jnp.asarray(a) for a in (x.numpy(), s, b, w1.T, b1, w2.T, b2)]


@pytest.mark.parametrize("with_rs", [False, True])
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_k2_passes_match_pallas(gelu, with_rs, jx, monkeypatch):
    """The passes in two chunks against the JAX _forward's Pallas kernel in
    interpret mode, in the stash form (out, z, mean, rstd), within 5e-5 (the
    JAX kernel's rational erf feeds a product); out also against the JAX
    fused_ln_mlp_residual without a stash."""
    jnp, jmlp = jx
    monkeypatch.setattr(jmlp, "_FORCE_PALLAS", True)
    rows, C, H = 300, 64, 256
    x, w, rs, _ = _case(4, rows, C, H, with_rs)
    _chunks(monkeypatch, rows, C, H, 2)
    a = _jax_args(jnp, x, w)
    jrs = None if rs is None else jnp.asarray(rs.numpy())
    ref, (z, mean, rstd) = jmlp._forward(*a, jrs, 1e-5, gelu, want_stash=True)
    out, stash = mb.ln_mlp_residual_passes(x, *w, 1e-5, gelu, rs, True)
    tol = dict(atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    for got, want in zip(stash, (z, mean, rstd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape), **tol)
    if rs is None:
        plain = jmlp.fused_ln_mlp_residual(*a, None, 1e-5, gelu)
        np.testing.assert_allclose(mb.ln_mlp_residual_passes(x, *w, 1e-5, gelu).numpy(),
                                   np.asarray(plain), **tol)


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_k2_passes_match_the_xla_reference(gelu, jx):
    """The stash form's passes with a row scale against the JAX
    _xla_reference (the function the Pallas kernel computes), within 2e-5."""
    jnp, jmlp = jx
    x, w, rs, _ = _case(5, 200, 64, 256, True)
    ref, (z, mean, rstd) = jmlp._xla_reference(*_jax_args(jnp, x, w), jnp.asarray(rs.numpy()),
                                               1e-5, gelu, want_stash=True)
    out, stash = mb.ln_mlp_residual_passes(x, *w, 1e-5, gelu, rs, True)
    tol = dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    for got, want in zip(stash, (z, mean, rstd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape), **tol)


@pytest.mark.parametrize("with_mask", [False, True])
def test_k3_passes_match_pallas(with_mask, jx, monkeypatch):
    """K3's passes against the JAX _forward_postln (K3M's against
    _forward_postln_mask) in Pallas interpret mode, within 5e-5."""
    jnp, jmlp = jx
    monkeypatch.setattr(jmlp, "_FORCE_PALLAS", True)
    x, w, _, mask = _case(6, 40, 64, 256, with_mask=with_mask)
    a = _jax_args(jnp, x, w)
    if with_mask:
        ref = jmlp._forward_postln_mask(*a, jnp.asarray(mask.numpy()), 1e-12)
    else:
        ref = jmlp._forward_postln(*a, 1e-12)
    got = mb.mlp_postln_passes(x, *w, mask, 1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _on_card(dev, seed, rows, C, H, with_rs=False, with_mask=False):
    x, w, rs, mask = _case(seed, rows, C, H, with_rs, with_mask)
    return (x.to(dev, torch.bfloat16), [t.to(dev) for t in w],
            None if rs is None else rs.to(dev), None if mask is None else mask.to(dev))


def _close(got, ref, what, tol=(2e-2, 2e-2)):
    """chip_smoke.py's K2 / K3 limit: max|got - ref| <= atol + rtol max|ref|."""
    err = (got.float() - ref.float()).abs().max().item()
    assert bool(torch.isfinite(got).all()), what
    assert err <= tol[0] + tol[1] * ref.float().abs().max().item(), (what, err)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [128, 256, 512, 1024])
def test_k2_passes_on_card(cuda, C, monkeypatch):
    """Each pass at a Swin-B width, the stash form's call in one chunk,
    against its plain step: the LN statistics, h (the workspace) and z
    against fc1 on the plain LN rows, out against fc2 on the kernel's h with
    a row scale, with chip_smoke.py's limits (the mean and rstd at rtol
    1e-5 / 2e-6); the public call against its plain version."""
    rows, H = 2 * 128 * 8 + 77, 4 * C
    x, w, rs, _ = _on_card(cuda, 10 + C, rows, C, H, True)
    ln_w, ln_b, w1, b1, w2, b2 = w
    _chunks(monkeypatch, rows, C, H, 1)
    h = x.new_empty((rows, H))
    out, (z, mean, rstd) = mb.ln_mlp_residual_passes(x, *w, 1e-5, "tanh", rs, True, hidden=h)
    torch.cuda.synchronize()
    y, want_mean, want_rstd = mb._k2_ln_rows_plain(x, ln_w, ln_b, 1e-5)
    _close(mean, want_mean, "mean", (0.0, 1e-5))
    _close(rstd, want_rstd, "rstd", (0.0, 2e-6))
    want_h, want_z = mb._k2_fc1_plain(y, w1, b1, "tanh")
    _close(h, want_h, "h")
    _close(z, want_z, "z")
    _close(out, mb._k2_fc2_plain(h, w2, b2, x, rs), "out")
    before = ops.fused_ln_mlp_residual_stash.launches
    got, stash = ops.fused_ln_mlp_residual_stash(x, *w, 1e-5, "tanh", rs)
    assert ops.fused_ln_mlp_residual_stash.launches == before + 1
    ref, rstash = ops.ln_mlp_residual_plain(x, *w, 1e-5, "tanh", rs, want_stash=True)
    _close(got, ref, "K2S out")
    _close(stash[0], rstash[0], "K2S z")


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["K2", "K2T", "K2S", "K3M"])
def test_a_call_in_chunks_keeps_its_bits_on_card(cuda, form, monkeypatch):
    """A call in the plan's chunks, in 3 or 5 (the caps set low, the last
    chunk ragged) gives the bits of the one-chunk call; two calls are
    bitwise equal."""
    rows = 5 * 1000 + 77
    C, H = (256, 1024) if form.startswith("K2") else (768, 3072)
    x, w, rs, mask = _on_card(cuda, 20, rows, C, H, form != "K2", form == "K3M")
    fn = {"K2": lambda: ops.fused_ln_mlp_residual(x, *w, 1e-5, "erf"),
          "K2T": lambda: ops.fused_ln_mlp_residual_train(x, *w, 1e-5, "tanh", rs),
          "K2S": lambda: ops.fused_ln_mlp_residual_stash(x, *w, 1e-5, "tanh", rs),
          "K3M": lambda: ops.fused_mlp_postln_dropout(x, *w, mask, 1e-12)}[form]

    def flat(r):
        return (r[0], *r[1]) if isinstance(r, tuple) else (r,)

    planned, again = flat(fn()), flat(fn())
    assert all(torch.equal(a, b) for a, b in zip(planned, again))
    _chunks(monkeypatch, rows, C, H, 1)
    whole = flat(fn())
    assert all(torch.equal(a, b) for a, b in zip(planned, whole))
    for chunks in (3, 5):
        _chunks(monkeypatch, rows, C, H, chunks)
        got = flat(fn())
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, whole)), chunks


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [960, 3616, 13024])
def test_k3_passes_on_card(cuda, rows):
    """K3 and K3M at BERT-base's width and the eval's and the fusion
    tower's rows against their plain versions with chip_smoke.py's limits;
    the fc1 pass (the workspace h) and the fc2 pass's fp32 partial against
    their plain steps."""
    C, H = 768, 3072
    x, w, _, mask = _on_card(cuda, 30, rows, C, H, with_mask=True)
    _close(ops.fused_mlp_postln(x, *w, 1e-12), ops.mlp_postln_plain(x, *w, 1e-12), "K3")
    _close(ops.fused_mlp_postln_dropout(x, *w, mask, 1e-12),
           ops.mlp_postln_mask_plain(x, *w, mask, 1e-12), "K3M")
    assert len(mb.k2_plan(rows, C, H)) == 1
    h, part = x.new_empty((rows, H)), torch.empty((rows, C), device=cuda)
    mb.mlp_postln_passes(x, *w, None, 1e-12, hidden=h, partial=part)
    torch.cuda.synchronize()
    _close(h, mb._k2_fc1_plain(x, w[2], w[3], "erf")[0], "K3 fc1")
    want = mb._k3_fc2_plain(h, w[4])
    assert (part - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_mlp_passes_reject_what_they_cannot_run(cuda):
    x, w, _, _ = _on_card(cuda, 40, 256, 192, 768)
    with pytest.raises(ValueError):    # C not a multiple of 128
        ops.fused_ln_mlp_residual(x, *w, 1e-5, "tanh")
    x, w, _, _ = _on_card(cuda, 41, 256, 128, 512)
    with pytest.raises(ValueError):    # fp32 activations: the passes take bf16
        ops.fused_ln_mlp_residual(x.float(), *w, 1e-5, "tanh")
