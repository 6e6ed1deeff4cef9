"""K7's split into passes, on the CPU.

K7, the recompute backward of the Swin MLP half (the JAX
``_backward_onepass``), runs on the card as the passes of
``csrc/mlp_block_bwd_passes.cu``: LN rows, pass A (z, u, GELU, dz, s h and
the drs / db1 partials), pass B (dy), the LN backward, pass D (dW1, dW2 and
db1 per row group) and the ordered sums of the slots. Their plain forms
(``ops.mlp_block._k7_*_plain``, composed by ``ln_mlp_residual_bwd_passes``,
K7's CPU route) are held here against ``ln_mlp_residual_bwd_recompute`` at
every Swin width, and against the interpret-mode ``_backward_onepass``;
``k7_plan``, which sizes the launches and the slots, is held at the call
shapes of the 32-frame remat pretrain step (P32) and of the 12- and 8-frame
train steps. The ``gpu`` tests launch K7 where pass D splits its rows and
where the rows go in two, three or seven chunks, and skip without a card: ``python -m pytest tests/test_torch_mlp_bwd_split.py -m gpu
--noconftest``.
"""

import hashlib

import numpy as np
import pytest
import torch

from clover_tpu_torch import ops
from clover_tpu_torch.ops import mlp_block as mb
from clover_tpu_torch.ops.mlp_bwd_sweep import step_calls

SMS = 132   # the H100's SMs
NAMES = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2", "drs")


def _case(seed, rows, C, with_rs):
    """x, torch-layout fp32 params (LN scale / bias, w1 (4C, C), b1, w2 (C,
    4C), b2), a DropPath row scale or None, a cotangent."""
    rng = np.random.default_rng(seed)
    H = 4 * C

    def f(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale)

    x, g = f(rows, C, scale=1.5) + 0.3, f(rows, C)
    w = [1 + f(C, scale=0.1), f(C, scale=0.1), f(H, C, scale=C ** -0.5), f(H, scale=0.1),
         f(C, H, scale=H ** -0.5), f(C, scale=0.1)]
    rs = (torch.from_numpy(((rng.random(rows) > 0.3) / 0.7).astype(np.float32)) if with_rs
          else None)
    return x, w, rs, g


def _assert_close(got, want, rel):
    """Each output within rel of its own max, absolute and relative; drs
    None exactly when the reference's is."""
    for name, a, w in zip(NAMES, got, want):
        if w is None:
            assert a is None, name
            continue
        assert a.shape == w.shape and a.dtype == w.dtype, name
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=rel,
                                   atol=rel * w.abs().max().item(), err_msg=name)


@pytest.mark.parametrize("with_rs", [False, True])
@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("C", [128, 256, 512, 1024])
def test_passes_compose_to_the_recompute(C, gelu, with_rs):
    """The passes composed (``ln_mlp_residual_bwd_passes``) against the
    plain recompute in fp32 at each Swin width, 300 rows (a ragged third
    row tile of 44): within 1e-5 of each output's max. The passes apply the
    row scale to u = g W2 and to h, where the recompute scales g, and take
    drs as sum_j h u + g . b2 rather than g . (h W2^T + b2): the same sums
    re-associated."""
    x, w, rs, g = _case(C + int(with_rs), 300, C, with_rs)
    want = ops.ln_mlp_residual_bwd_recompute(x, *w, rs, 1e-5, gelu, g)
    got = ops.ln_mlp_residual_bwd_passes(x, *w, rs, 1e-5, gelu, g)
    _assert_close(got, want, 1e-5)


def _chunk_cap(rows, H, chunks):
    """A hidden-bytes cap that makes k7_plan split ``rows`` into ``chunks``."""
    return 4 * H * -(-rows // chunks)


@pytest.mark.parametrize("with_rs", [False, True])
@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
def test_passes_in_chunks(chunks, with_rs):
    """1000 rows in one to four chunks (the plan's hidden-bytes cap set low;
    the last chunk ragged): the same outputs within 1e-5 of each max."""
    rows, C = 1000, 128
    x, w, rs, g = _case(7 + chunks, rows, C, with_rs)
    plan = mb.k7_plan(rows, C, 4 * C, SMS, _chunk_cap(rows, 4 * C, chunks))
    assert plan.chunks == chunks
    want = ops.ln_mlp_residual_bwd_recompute(x, *w, rs, 1e-5, "tanh", g)
    _assert_close(ops.ln_mlp_residual_bwd_passes(x, *w, rs, 1e-5, "tanh", g, plan), want, 1e-5)


def test_wrapper_takes_the_passes_on_the_cpu():
    """K7's wrapper on CPU tensors is the passes' plain forms, bitwise, and
    counts no launch."""
    x, w, rs, g = _case(3, 200, 256, True)
    ops.reset_launch_counts()
    got = ops.ln_mlp_residual_bwd_onepass(x, *w, rs, 1e-5, "erf", g)
    want = ops.ln_mlp_residual_bwd_passes(x, *w, rs, 1e-5, "erf", g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.ln_mlp_residual_bwd_onepass.launches == 0


@pytest.mark.parametrize("with_rs,gelu", [(False, "tanh"), (True, "tanh"), (True, "erf")])
def test_passes_match_pallas_onepass(with_rs, gelu, monkeypatch):
    """The passes against the one-pass Pallas kernel in interpret mode (16-row
    blocks, as tests/test_torch_remat.py runs it) at C=128, H=512 and 172 rows
    (a ragged second row tile of 44 and a masked last Pallas block): within
    2e-4 absolute and relative (the kernel rounds y and the hidden to x's
    dtype where the passes do not, identities here in fp32)."""
    jnp = pytest.importorskip("jax.numpy")
    import clover_tpu.ops.mlp_block as jmlp

    monkeypatch.setattr(jmlp, "_FORCE_PALLAS", True)
    monkeypatch.setattr(jmlp, "_BWD_ONEPASS", "auto")
    monkeypatch.setattr(jmlp, "_pick_rows_onepass", lambda rows, C, H, i: 16)
    x, w, rs, g = _case(11, 172, 128, with_rs)
    jw = [w[0], w[1], w[2].T.contiguous(), w[3], w[4].T.contiguous(), w[5]]
    want = jmlp._backward_onepass(*(jnp.asarray(t.numpy()) for t in (x, *jw)),
                                  None if rs is None else jnp.asarray(rs.numpy()), 1e-5, gelu,
                                  jnp.asarray(g.numpy()))
    assert want is not None
    got = ops.ln_mlp_residual_bwd_passes(x, *w, rs, 1e-5, gelu, g)
    for name, a, ref in zip(NAMES, got, want):
        if ref is None:
            assert a is None, name
            continue
        ref = np.asarray(ref, np.float32)
        if name in ("dw1", "dw2"):
            ref = ref.T
        np.testing.assert_allclose(a.numpy(), ref.reshape(a.shape), atol=2e-4, rtol=2e-4,
                                   err_msg=name)


# K7's call shapes (rows, C) of the train paths: P32 (2 x 8 clips of 32
# frames), the finetune at 12 frames (16 clips), the pretrain at 8 (2 x 8)
_TOKENS = {"P32": 16 * 16 * 56 * 56, "12f": 16 * 6 * 56 * 56, "8f": 16 * 4 * 56 * 56}
_SHAPES = [(path, tokens // 4 ** i, 128 * 2 ** i) for path, tokens in _TOKENS.items()
           for i in range(4)]


@pytest.mark.parametrize("path,rows,C", _SHAPES)
def test_plan_fills_the_card_and_sums_every_row_once(path, rows, C):
    """At each call shape: the chunks cover the rows once; pass D's row groups
    are whole 128-row tiles that cover each chunk once and fill the card's
    SMs at least once; pass A launches at least two blocks an SM, pass B one;
    the LN blocks walk every row once; the slots the plan counts are the ones
    the kernel fills; and the workspace holds every buffer the wrapper
    allocates, under 1 GiB (the per-block dW slices it replaced took up to
    4 GiB)."""
    H = 4 * C
    plan = mb.k7_plan(rows, C, H, SMS)
    T = mb._K7_TILE
    assert plan.chunk_rows % T == 0 and plan.split_rows % T == 0
    chunks = [(r0, min(plan.chunk_rows, rows - r0)) for r0 in range(0, rows, plan.chunk_rows)]
    assert len(chunks) == plan.chunks and sum(n for _, n in chunks) == rows
    assert 4 * plan.chunk_rows * H <= mb._K7_HIDDEN_BYTES or plan.chunk_rows == T
    dw_slots = ln_slots = 0
    for _, n in chunks:
        groups = [(k0, min(plan.split_rows, n - k0)) for k0 in range(0, n, plan.split_rows)]
        covered = np.zeros(n, dtype=int)
        for k0, k in groups:
            covered[k0:k0 + k] += 1
        assert (covered == 1).all()
        dw_slots += len(groups)
        blocks = min(plan.ln_blocks, -(-n // 8))
        walked = np.zeros(n, dtype=int)
        for b in range(blocks):
            for w in range(8):
                walked[b * 8 + w::8 * blocks] += 1
        assert (walked == 1).all()
        ln_slots += blocks
    assert (dw_slots, ln_slots) == (plan.dw_slots, plan.ln_slots)
    tiles = 2 * (H // T) * (C // T)
    n = chunks[0][1]
    assert plan.d_blocks == tiles * -(-n // plan.split_rows) >= SMS
    assert plan.a_blocks == (H // T) * -(-n // T) >= 2 * SMS
    assert plan.b_blocks == (C // T) * -(-n // T) >= SMS
    assert plan.buf_rows == n
    allocated = (2 * 2 * H * C + 2 * n * C + 2 * 2 * n * H + 4 * n * C + 4 * n * H // T
                 + 4 * -(-n // T) * H + 4 * plan.dw_slots * (2 * H * C + H)
                 + 4 * plan.ln_slots * 3 * C + 4 * (2 * H * C + H + 3 * C))
    assert allocated <= plan.workspace_bytes <= allocated + 10 * 256
    assert plan.workspace_bytes < 1 << 30


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _on_card(dev, rows, C, seed, with_rs=True):
    x, w, rs, g = _case(seed, rows, C, with_rs)
    to = dict(device=dev)
    return (x.to(dev, torch.bfloat16), [t.bfloat16().float().to(**to) for t in w],
            None if rs is None else rs.to(**to), g.to(dev, torch.bfloat16))


def k7_digest(dev, rows, C, with_rs):
    """sha256 of K7's outputs (NAMES' order, raw bytes) on _on_card's inputs."""
    x, w, rs, g = _on_card(dev, rows, C, rows % 97 + C, with_rs)
    h = hashlib.sha256()
    for t in ops.ln_mlp_residual_bwd_onepass(x, *w, rs, 1e-5, "tanh", g):
        if t is not None:
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


# k7_digest at each call shape of the 32-frame remat pretrain step
# (mlp_bwd_sweep.step_calls), taken on an NVIDIA H100 80GB HBM3 before the
# GEMM core moved from csrc/mlp_block_bwd_passes.cu into csrc/gemm.cuh
K7_DIGESTS = {
    (802816, 128, False): "92e209b69edf407fec75cfea9b65cb128787bb6332665e221dc43acdaf087754",
    (802816, 128, True): "59058994f15f90f540da7542454262d3703cc54a644456b013304cdf07b01ee5",
    (200704, 256, True): "e06b741a7da8a06b3d3af7770b24dbec64c89a0037585b626d1cf19aee22b439",
    (50176, 512, True): "f338b2db7306bdd1a8e6b8ce1c99bf3f3818f337e27a6873d76b7a03ceb5b055",
    (12544, 1024, True): "4f0788bbc5b057e1b37deb8ad97779d9ca434c47dda25c0143cf6a9e8d5fd1d9",
}


@pytest.mark.gpu
@pytest.mark.parametrize("rows,C", [(2 * 128 * SMS + 77, 128), (2 * 128 * SMS + 77, 256),
                                    (2 * 128 * SMS + 77, 512), (2 * 128 * SMS + 77, 1024),
                                    (300001, 128)])
def test_k7_split_rows_on_card(cuda, rows, C):
    """K7 at each Swin width with at least 2 x 128 x 132 rows, so that pass D
    splits them into row groups (and at 300001 rows of C=128 into two
    chunks), against the plain recompute with chip_smoke.py's limits
    (tests/test_torch_remat.py's _check_against_plain); two calls bitwise
    equal; one launch counted for each."""
    from test_torch_remat import _check_against_plain

    x, w, rs, g = _on_card(cuda, rows, C, rows % 97 + C)
    plan = mb.k7_plan(rows, C, 4 * C, mb._build.sms(cuda))
    assert plan.dw_slots > plan.chunks or C == 1024
    before = ops.ln_mlp_residual_bwd_onepass.launches
    got = ops.ln_mlp_residual_bwd_onepass(x, *w, rs, 1e-5, "tanh", g)
    again = ops.ln_mlp_residual_bwd_onepass(x, *w, rs, 1e-5, "tanh", g)
    torch.cuda.synchronize()
    assert ops.ln_mlp_residual_bwd_onepass.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _check_against_plain(got, x, w, rs, "tanh", g)


@pytest.mark.gpu
@pytest.mark.parametrize("chunks", [2, 3, 7])
def test_k7_chunks_on_card(cuda, chunks, monkeypatch):
    """K7 with 33869 rows of C=256 in two, three or seven chunks (the plan's
    hidden-bytes cap set low, the last chunk ragged) against the plain
    recompute with chip_smoke.py's limits, and within 1e-5 of each max of
    the one-chunk call, as the chunked passes on the CPU (the chunks move
    pass D's row groups, so each fp32 slot sums other rows)."""
    from test_torch_remat import _check_against_plain

    rows, C = 2 * 128 * SMS + 77, 256
    x, w, rs, g = _on_card(cuda, rows, C, 5)
    args = (x, *w, rs, 1e-5, "erf", g)
    want = ops.ln_mlp_residual_bwd_onepass(*args)
    plan = mb.k7_plan
    cap = _chunk_cap(rows, 4 * C, chunks)
    assert plan(rows, C, 4 * C, mb._build.sms(cuda), cap).chunks == chunks
    monkeypatch.setattr(mb, "k7_plan", lambda *a: plan(*a, cap))
    got = ops.ln_mlp_residual_bwd_onepass(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=1e-5 * b.float().abs().max().item())
    _check_against_plain(got, x, w, rs, "erf", g)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,C,with_rs", [c[:3] for c in step_calls()])
def test_k7_outputs_keep_their_bits_on_card(cuda, rows, C, with_rs):
    """K7's outputs at each P32 call shape are bitwise those saved in
    K7_DIGESTS: the GEMM core it shares with K6 changed no bit."""
    assert k7_digest(cuda, rows, C, with_rs) == K7_DIGESTS[rows, C, with_rs]
