"""K5's split into a row pass, a key pass and a finish, on the CPU.

The plain forms of the two passes (``window_attention_bwd_rows_plain`` ->
dq and the row statistics, ``window_attention_bwd_keys_plain`` -> dk, dv
and dbias from them) composed against the one-pass plain backward and the
JAX package's interpret-mode ``_backward_flat2``; ``_bwd_grid`` at every
K5 call shape of the five train paths; and the key pass's dbias layout: a
dense tensor packed as the key pass stores its shares and summed as the
finish reads them comes back exactly. The kernels themselves run on the
card (``test_window_attention_bwd_kernel_on_card`` in
``tests/test_torch_train_ops.py``).
"""

import numpy as np
import pytest
import torch

from clover_tpu_torch import ops
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.ops import bwd_sweep
from clover_tpu_torch.ops import window_attention as wa

SMS, SMEM = 132, 232448   # the H100's SMs; the shared memory a block may use


def _split(qkv, bias, ids, g, scale, nH, N):
    dq, stats = ops.window_attention_bwd_rows_plain(qkv, bias, ids, g, scale, nH, N)
    dk, dv, dbias = ops.window_attention_bwd_keys_plain(qkv, bias, ids, g, stats, scale, nH, N)
    return torch.cat([dq, dk, dv], dim=1), dbias


# (token dims, window, shift): 2 windows of each N in a batch of 2 samples
_WINDOWS = {98: ((2, 7, 14), (2, 7, 7), (1, 3, 3)), 196: ((4, 7, 14), (4, 7, 7), (2, 3, 3)),
            294: ((6, 7, 14), (6, 7, 7), (3, 3, 3)), 392: ((8, 7, 14), (8, 7, 7), (4, 3, 3))}


def _inputs(rng, N, nH, masked, B=2, windows=None):
    dims, win, shift = windows or _WINDOWS[N]
    ids = pswin._shift_region_ids(dims, win, shift) if masked else None
    Bn = B * int(np.prod([d // w for d, w in zip(dims, win)]))
    C = nH * 32
    qkv = rng.normal(size=(Bn * N, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(nH, N, N)).astype(np.float32)
    g = rng.normal(size=(Bn * N, C)).astype(np.float32)
    return qkv, bias, g, None if ids is None else torch.from_numpy(ids)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N", [98, 196, 294, 392])
def test_split_passes_compose_to_the_plain_backward(N, masked):
    """Row pass then key pass equal the one-pass plain backward in fp32:
    the same products, P from the logsumexp instead of softmax's max and
    sum. Tolerance 1e-5 absolute and relative."""
    qkv, bias, g, ids = _inputs(np.random.default_rng(N), N, 2, masked)
    args = (torch.from_numpy(qkv), torch.from_numpy(bias), ids, torch.from_numpy(g), 32 ** -0.5,
            2, N)
    got_dqkv, got_dbias = _split(*args)
    want_dqkv, want_dbias = ops.window_attention_bwd_plain(*args)
    np.testing.assert_allclose(got_dqkv.numpy(), want_dqkv.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_dbias.numpy(), want_dbias.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_split_passes_match_pallas(masked):
    """The composed passes against the interpret-mode ``_backward_flat2``
    at N=98 with the true row max, within test_torch_train_ops.py's 5e-5,
    on that file's shifted block (token dims (2, 14, 14), nW = 4: 8 windows,
    what the flat2 kernel's window batching takes)."""
    jnp = pytest.importorskip("jax.numpy")
    import clover_tpu.models.swin3d as jswin
    import clover_tpu.ops.window_attention as jwa

    N, nH = 98, 2
    dims, win, shift = (2, 14, 14), (2, 7, 7), (0, 3, 3)
    qkv, bias, g, ids = _inputs(np.random.default_rng(7), N, nH, masked,
                                windows=(dims, win, shift))
    jm = jnp.asarray(jswin.shift_attn_mask(dims, win, shift)) if masked else None
    ref = jwa._backward_flat2(jnp.asarray(qkv), jnp.asarray(bias), jm, 32 ** -0.5, nH, N,
                              jnp.asarray(g), no_max=False)
    assert ref is not None, "the Pallas backward refused the shape"
    got_dqkv, got_dbias = _split(torch.from_numpy(qkv), torch.from_numpy(bias), ids,
                                 torch.from_numpy(g), 32 ** -0.5, nH, N)
    np.testing.assert_allclose(got_dqkv.numpy(), np.asarray(ref[0]).reshape(qkv.shape),
                               atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(got_dbias.numpy(), np.asarray(ref[1]), atol=5e-5, rtol=5e-5)


def _old_workspace(Bn, nH, N, sms=SMS):
    """The one-pass kernel's dbias workspace, chunks x nH x Np^2 fp32, its
    chunks about two blocks an SM in all, a divisor of Bn where one fits."""
    target = max(1, 2 * sms // nH)
    chunks = next((c for c in range(min(Bn, target), 0, -1) if Bn % c == 0 and 2 * c > target),
                  min(Bn, target))
    return chunks * nH * (16 * wa.key_tiles(N)) ** 2 * 4


# K5's call shapes of the five train paths, (Bn, nH, N) by stage: the
# finetune at 12 and 32 frames and the pretrain at 8 (B=16 clips; the
# pretrain's clean and masked passes make 2 x 8); P32 is the pretrain at
# 32 frames (2 x 8 clips: the 32-frame finetune's shapes), P8E the 8-frame
# pretrain with every stage rematerialised (the pretrain's)
_PATH_FRAMES = {"12f": 12, "32f": 32, "pretrain": 8, "P32": 32, "P8E": 8}
_CALLS = [(path, stage, Bn, nH, N)
          for path, frames in _PATH_FRAMES.items()
          for stage, Bn, N, nH, ids, _ in bwd_sweep.step_shapes(frames) if ids is None]


@pytest.mark.parametrize("path,stage,Bn,nH,N", _CALLS)
def test_bwd_grid_fills_the_card(path, stage, Bn, nH, N):
    """At each call shape: the key pass's chunks cover the windows, each
    pass launches at least as many blocks as fit on 132 SMs at once (row
    pass three an SM, key pass one), the shared memory fits (the row pass's
    three times), the C entry point's group counts hold, and the workspace
    is no larger than the one-pass kernel's."""
    grid = wa._bwd_grid(Bn, nH, N, SMS)
    strips = -(-N // 16)
    walked = sorted(b for c in range(grid.chunks) for b in range(c, Bn, grid.chunks))
    assert walked == list(range(Bn))
    assert grid.row_blocks >= 3 * SMS and grid.key_blocks >= SMS
    assert grid.key_blocks == nH * grid.key_groups * grid.chunks
    assert 3 * grid.row_smem <= SMEM and grid.key_smem <= SMEM
    assert -(-strips // grid.row_groups) <= 8 and grid.key_groups == -(-strips // 2)
    assert grid.workspace_bytes <= _old_workspace(Bn, nH, N)
    assert grid.stats_bytes == Bn * nH * 16 * wa.key_tiles(N) * 8


def _pack_shares(dense, key_tiles):
    """(chunks, nH, N, N) [c, h, q, k] -> the key pass's workspace (chunks,
    nH, 16 strips, Np) as its warps store it: warp (key tile kt, strip s)
    writes n-tile u, lane 4 g + t, element e = 2 half + col for key
    16 kt + 8 half + g and query 16 s + 8 u + 2 t + col; entries of padded
    keys or queries are left NaN."""
    chunks, nH, N, _ = dense.shape
    strips, Np = -(-N // 16), 16 * key_tiles
    part = torch.full((chunks, nH, 16 * strips * Np), float("nan"))
    kt, s, u, lane, e = torch.meshgrid(torch.arange(strips), torch.arange(strips),
                                       torch.arange(2), torch.arange(32), torch.arange(4),
                                       indexing="ij")
    k = kt * 16 + 8 * (e // 2) + lane // 4
    q = s * 16 + 8 * u + 2 * (lane % 4) + e % 2
    idx = (((kt * key_tiles + s) * 2 + u) * 32 + lane) * 4 + e
    ok = (k < N) & (q < N)
    part[:, :, idx[ok]] = dense[:, :, q[ok], k[ok]]
    return part.view(chunks, nH, 16 * strips, Np)


def _finish(part, N, key_tiles):
    """The finish's read of the shares: dbias[h, q, k] summed over the
    chunks in chunk order."""
    chunks, nH = part.shape[:2]
    strips = -(-N // 16)
    h, q, k = torch.meshgrid(torch.arange(nH), torch.arange(N), torch.arange(N), indexing="ij")
    frag = (((((h * strips + k // 16) * key_tiles + q // 16) * 2 + (q // 8) % 2) * 32
             + (k % 8) * 4 + (q // 2) % 4) * 4 + ((k // 8) % 2) * 2 + q % 2)
    flat = part.reshape(chunks, -1)
    acc = torch.zeros((nH, N, N))
    for c in range(chunks):
        acc = acc + flat[c][frag]
    return acc


@pytest.mark.parametrize("key_tiles", wa.KEY_TILES)
def test_dbias_share_layout_round_trips(key_tiles):
    """A dense (chunks, nH, N, N) tensor packed as the key pass stores its
    shares comes back from the finish's read exactly, the chunks summed in
    order, and no padded entry is read (they are NaN)."""
    N = 16 * key_tiles - 5
    dense = torch.from_numpy(np.random.default_rng(key_tiles).normal(
        size=(3, 2, N, N)).astype(np.float32))
    got = _finish(_pack_shares(dense, key_tiles), N, key_tiles)
    want = dense[0] + dense[1] + dense[2]
    assert torch.equal(got, want)
