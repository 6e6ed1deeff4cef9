"""K11's launch shape and term reads, held on the CPU.

K11 (``csrc/window_attention_flash.cu``) runs a block of 5 warps per
(window, 80-row query tile, head), a 16-row query strip a warp, and walks
the keys in 64-key tiles up to 16 * ceil(N / 16): whole tiles, then the
last tile's 16-key steps. ``flash_grid`` mirrors that shape and the
wrappers check their launch against it. These tests hold the mirror at the
32-frame eval's stage shapes (E32L) and at N from 17 to 520: every query
strip taken by one warp, the key steps summing to ceil(N / 16) with none
wholly past N, the plain version's 64-key online-softmax steps, shared
memory within the 48 KB a block takes without the opt-in. They then read
the terms of the logits as the kernel does (the bf16 bias the wrapper lays
out with ``fragment_bias`` at ceil(N / 16) steps, one 8-byte entry per lane
and 8-key n-tile at the kernel's offsets, a key tile at a time; the key
tile's region ids as staged, 0 past N) and compare them exactly with the
bias + region mask, also past K1's 400 keys. The kernel itself runs only on
a card (``tests/test_torch_spatial.py::test_flash_kernels_on_card``).
"""

import numpy as np
import pytest
import torch

from clover_tpu_torch.ops import window_attention as pwa

E32L = [(4096, 4, 392), (1024, 8, 392), (256, 16, 392), (64, 32, 392)]   # Bn, nH, N
OTHER_N = [17, 33, 64, 72, 128, 150, 384, 392, 400, 520]


@pytest.mark.parametrize("Bn,nH,N", E32L + [(8, 2, n) for n in OTHER_N])
def test_flash_grid_covers_every_strip_and_key_step_once(Bn, nH, N):
    grid = pwa.flash_grid(Bn, nH, N)
    strips, warps = -(-N // 16), grid.rows // 16
    assert grid.rows == 80 and grid.grid == (Bn * grid.query_tiles, nH)
    # warp w of query tile i takes strip 5i + w; a strip wholly past N only stages
    taken = [i * warps + w for i in range(grid.query_tiles) for w in range(warps)
             if (i * warps + w) * 16 < N]
    assert taken == list(range(strips))
    assert grid.query_tiles * grid.rows - N < grid.rows       # no block wholly past N
    steps = grid.key_steps
    assert sum(steps) == strips and 16 * sum(steps) - N < 16  # no step wholly past N
    assert all(s == 4 for s in steps[:-1]) and 1 <= steps[-1] <= 4
    assert len(steps) == len(range(0, N, pwa.FLASH_KEYS))     # _flash_plain's tiles
    assert grid.smem <= 48 * 1024


def test_flash_grid_at_the_e32l_window():
    """N=392: 5 query tiles of 5 strips, no warp idle; 25 key steps (400
    keys, not 448); 27 KB of shared memory."""
    grid = pwa.flash_grid(4096, 4, 392)
    assert grid.query_tiles == 5 and grid.grid == (20480, 4)
    assert grid.query_tiles * grid.rows // 16 == 25
    assert grid.key_steps == (4, 4, 4, 4, 4, 4, 1)
    assert grid.smem == 80 * 40 * 2 + 2 * 2 * 64 * 40 * 2 + 2 * 64 * 4 == 27392


def _kernel_terms(bias_f, ids, N, nH):
    """What K11 adds to the scaled logits of one window, read as the kernel
    reads it: (nH, Np, Np) fp32, Np = 16 ceil(N / 16). Warp strip s, lane
    4g + t (rows q0 = 16s + g, q1 = q0 + 8), key tile j of ``key_steps[j]``
    16-key steps from key k0, n-tile nt of the tile: the 8-byte entry
    ((h KT + s) 2 KT + 8j + nt) 32 + lane of the bias, rows (q0, q1) x keys
    k0 + 8nt + 2t + (0, 1); -100 where the staged id of the key (0 past N)
    is not the row's (0 for a row past N)."""
    KT = -(-N // 16)
    entries = bias_f.float().reshape(-1, 4)   # one uint2 of 4 bf16 each
    out = torch.full((nH, 16 * KT, 16 * KT), float("nan"))
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    row_id = np.zeros(16 * KT, np.int64) if ids is None else np.pad(ids, (0, 16 * KT - N))
    for h in range(nH):
        for s in range(KT):
            q0, q1 = 16 * s + g, 16 * s + g + 8
            k0 = 0
            for j, steps in enumerate(pwa.flash_grid(1, nH, N).key_steps):
                staged = row_id[k0:k0 + 16 * steps]
                for nt in range(2 * steps):
                    e = entries[((h * KT + s) * 2 * KT + 8 * j + nt) * 32 + lane]
                    c = nt * 8 + 2 * t
                    for i, (rows, col) in enumerate([(q0, c), (q0, c + 1), (q1, c), (q1, c + 1)]):
                        val = e[:, i].clone()
                        if ids is not None:
                            val[torch.from_numpy(staged[col] != row_id[rows])] -= 100.0
                        out[h, rows, k0 + col] = val
                k0 += 16 * steps
    return out


@pytest.mark.parametrize("N,masked", [(72, True), (392, True), (401, False), (520, True)])
def test_kernel_term_reads_give_bias_and_region_mask(N, masked):
    """At every real (row, key) the bf16 bias plus the -100 region term,
    exactly; -inf at every padded key of every real row."""
    rng = np.random.default_rng(N)
    nH = 2
    bias = torch.from_numpy(rng.normal(size=(nH, N, N)).astype(np.float32) * 5)
    ids = rng.integers(0, 4, size=N).astype(np.int32) if masked else None
    bias_f, nW = pwa._flash_kernel_args(bias, None if ids is None else torch.from_numpy(ids[None]),
                                        2, nH, N, torch.device("cpu"))
    assert nW == 1
    got = _kernel_terms(bias_f, ids, N, nH)
    want = bias.to(torch.bfloat16).float()
    if masked:
        want = want + pwa.region_mask(torch.from_numpy(ids[None]), torch.float32)[0]
    assert not bool(got.isnan().any())
    assert torch.equal(got[:, :N, :N], want)
    assert bool((got[:, :N, N:] == float("-inf")).all())


@pytest.mark.parametrize("N", [392, 520])
def test_flash_kernel_args_lay_out_the_bias_at_ceil_n_16(N):
    nH, KT = 4, -(-N // 16)
    bias = torch.from_numpy(np.random.default_rng(7).normal(size=(nH, N, N)).astype(np.float32))
    ids = torch.zeros(2, N, dtype=torch.int32)
    bias_f, nW = pwa._flash_kernel_args(bias, ids, 6, nH, N, torch.device("cpu"))
    assert nW == 2 and bias_f.dtype == torch.bfloat16 and bias_f.is_contiguous()
    assert bias_f.shape == (nH, KT, 2 * KT, 8, 4, 2, 2)
    assert torch.equal(bias_f, pwa.fragment_bias(bias, N, KT))


@pytest.mark.parametrize("Bn,nH", [(1 << 30, 4),      # past 2^31 - 1 blocks along x
                                   (8, 70000)])       # more heads than grid y takes
def test_flash_kernel_args_refuse_a_grid_past_the_card(Bn, nH):
    with pytest.raises(ValueError, match="grid"):
        pwa._flash_kernel_args(torch.zeros(1, 392, 392), None, Bn, nH, 392, torch.device("cpu"))
