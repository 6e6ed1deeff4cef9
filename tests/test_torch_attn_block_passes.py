"""K6's passes, on the CPU.

On the card K6 (``fused_window_attn_block``) runs as three passes over
chunks of whole windows (``attn_block.k6_plan``): LN1 + the qkv product,
K11's attention on the flat qkv, the proj product + residual.
``attn_block_passes`` walks the chunks; on CPU tensors it runs each pass's
plain step (the attention as K11's online softmax, ``_flash_plain``), so
these tests hold the chunking, the row-scale slices and the steps' order
on the CPU: against ``window_attn_block_plain`` on the whole input (K1's
softmax, the sums in another order: 2e-5 absolute and relative, fp32), and
against the JAX ``fused_window_attn_block`` kernel in Pallas interpret mode
(``tests/test_torch_attn_block.py``'s tolerance). ``k6_plan`` is held at
every K6 call shape of the 32-frame eval, finetune and pretrain steps. The
card tests of the passes are in ``tests/test_torch_attn_block.py``.
"""

import numpy as np
import pytest
import torch
from test_torch_attn_block import TOL, _block_args, _jax, jx  # noqa: F401  (jx: a fixture)

from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.ops import attn_block as pab
from clover_tpu_torch.ops.attn_block_sweep import call_shapes

# (token dims, window, shift) of a shifted block at N=98 (nW=4), 196 (4) and
# 392 (2: the 32-frame stage 3, whose block shifts along time only)
SHAPES = {98: ((2, 14, 14), (2, 7, 7), (0, 3, 3)), 196: ((4, 14, 14), (4, 7, 7), (2, 3, 3)),
          392: ((16, 7, 7), (8, 7, 7), (4, 0, 0))}
GROUPS = 5          # nW-groups of windows in a case
# chunks -> nW-groups a chunk may hold: 5 groups in one, 3 + 2, 2 + 2 + 1
CAP_GROUPS = {1: GROUPS, 2: 3, 3: 2}


def _shape_id(c):
    path, stage, _, _, _, _, ids, _, _ = c
    return f"{path}-stage{stage}-{'shifted' if ids is not None else 'unshifted'}"


@pytest.mark.parametrize("call", call_shapes(), ids=_shape_id)
def test_plan_covers_each_window_once_under_the_cap(call):
    """Chunks of whole nW-groups, in order, covering the Bn windows once,
    each under the cap, as few as the cap allows and at most one group
    apart in size."""
    _, _, Bn, N, C, _, ids, _, _ = call
    nW = 1 if ids is None else ids.shape[0]
    plan = pab.k6_plan(Bn, N, C, nW)
    starts = [w0 for w0, _ in plan]
    sizes = [n for _, n in plan]
    assert starts == list(np.cumsum([0] + sizes[:-1])) and sum(sizes) == Bn
    assert all(n % nW == 0 and n > 0 for n in sizes)
    assert all(10 * N * C * n <= pab._K6_CHUNK_BYTES for n in sizes)
    per_cap = pab._K6_CHUNK_BYTES // (10 * N * C * nW)
    assert len(plan) == -(-(Bn // nW) // per_cap)
    assert max(sizes) - min(sizes) <= nW


def _case(N, C, nH, shifted, with_rs, seed):
    """Torch-layout fp32 arguments of the half-block on GROUPS nW-groups of
    windows, and the number of windows in a group."""
    rng = np.random.default_rng(seed)
    dims, win, sh = SHAPES[N]
    nW = int(np.prod([d // w for d, w in zip(dims, win)]))
    x, ls, lb, wqkv, bqkv, bias, wp, bp = (torch.from_numpy(v) for v in
                                            _block_args(rng, GROUPS * nW, N, C, nH))
    ids = torch.from_numpy(pswin._shift_region_ids(dims, win, sh)) if shifted else None
    rs = (torch.from_numpy(np.where(rng.random(GROUPS * nW) < 0.25, 0.0, 1.25).astype(np.float32))
          if with_rs else None)
    args = (x.reshape(-1, C), ls, lb, wqkv.T.contiguous(), bqkv, bias, ids, wp.T.contiguous(), bp,
            32 ** -0.5, nH, N, 1e-5, rs)
    return args, nW


def _cap(monkeypatch, N, C, nW, chunks):
    monkeypatch.setattr(pab, "_K6_CHUNK_BYTES", CAP_GROUPS[chunks] * 10 * N * C * nW)


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("with_rs", [False, True], ids=["no_scale", "row_scale"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("C,nH", [(64, 2), (128, 4)])
@pytest.mark.parametrize("N", [98, 196, 392])
def test_passes_match_the_plain_block(N, C, nH, shifted, with_rs, chunks, monkeypatch):
    """The chunk loop on CPU tensors against window_attn_block_plain on the
    whole input; the chunks are whole nW-groups (an unshifted block's
    group is one window, so its chunks hold as many windows as the shifted
    block's), the row scale is sliced per chunk."""
    args, nW = _case(N, C, nH, shifted, with_rs, N + C + 2 * shifted + with_rs)
    Bn = GROUPS * nW
    _cap(monkeypatch, N, C, nW, chunks)
    plan = pab.k6_plan(Bn, N, C, nW if shifted else 1)
    assert len(plan) == chunks
    got = pab.attn_block_passes(*args)
    want = pab.window_attn_block_plain(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    if with_rs:
        x, rs = args[0].view(Bn, N, C), args[-1]
        for b in (rs == 0).nonzero().flatten().tolist():
            assert torch.equal(got.view(Bn, N, C)[b], x[b])


@pytest.mark.parametrize("with_rs", [False, True], ids=["no_scale", "row_scale"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("C,nH", [(64, 2), (128, 4)])
@pytest.mark.parametrize("N", [98, 392])
def test_passes_match_pallas(N, C, nH, shifted, with_rs, jx, monkeypatch):
    """The chunk loop in three chunks against the JAX kernel (``_forward``
    in interpret mode) on the same windows, its mask the additive form of
    the same shift."""
    monkeypatch.setattr(jx.ab, "_FORCE_PALLAS", True)
    args, nW = _case(N, C, nH, shifted, with_rs, 7 * N + C + shifted)
    Bn = GROUPS * nW
    _cap(monkeypatch, N, C, nW, 3)
    got = pab.attn_block_passes(*args)
    x, ls, lb, wqkv, bqkv, bias, _, wp, bp, scale, _, _, _, rs = args
    a = [x.view(Bn, N, C).numpy(), ls.numpy(), lb.numpy(), wqkv.T.numpy(), bqkv.numpy(),
         bias.numpy(), wp.T.numpy(), bp.numpy()]
    mask = jx.swin.shift_attn_mask(*SHAPES[N]) if shifted else None
    want = _jax(jx, a, mask, None if rs is None else rs.numpy(), scale=scale)
    np.testing.assert_allclose(got.view(Bn, N, C).numpy(), want, **TOL)
