"""K9 and K10's terms in accumulator order, held against what they encode.

The kernels read the fp32 bias and the fp32 additive mask as
``fragment_terms`` lays them out (``bias_terms``, ``mask_terms``): [x][16-row
strip][8-key tile][lane] x 4, lane 4g + t holding rows g and g+8 of the
strip at keys 2t and 2t+1 of the tile. These tests unpack that layout in
the kernels' read order and compare it exactly, in fp32, with the (X, N, N)
terms at every N the Swin-B windows give the kernels (98, 147, 196, 392 at
7, 13, 13, 25 key tiles) and past K1's 400 keys, where K11 alone goes
(401, 448, 520 at ceil(N / 16)); check the padding (-inf in the bias's
padded keys, 0 in the rest); check that the mask terms the Swin model caches are, tile
for tile, the (gd, gh, gw, N, N) mask grid K10's windows take, one tensor
per (dims, window, shift, device); read logits from the fragment form with
plain PyTorch, exactly equal to ``_heads_logits``; and check the wrappers'
windows per block and their refusal of terms of the wrong shape.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops import window_attention as pwa

# N, key tiles: K9 / K10's; then K11's ceil(N / 16) past K1's 400 keys
SHAPES = [(98, 7), (147, 13), (196, 13), (392, 25), (401, 26), (448, 28), (520, 33)]
PADS = {"bias": float("-inf"), "mask": 0.0}


def _unpack(frag):
    """(X, strips, tiles, 8, 4, 2, 2) -> (X, Np, Np), each entry put where
    the kernel adds it: lane 4g + t of strip s and n-tile nt, float i, is row
    s*16 + g + 8*(i // 2), key nt*8 + 2t + i % 2."""
    X, KT = frag.shape[0], frag.shape[1]
    lanes = frag.reshape(X, KT, 2 * KT, 32, 4)
    out = torch.full((X, 16 * KT, 16 * KT), float("nan"), dtype=frag.dtype)
    s, nt, lane = np.meshgrid(np.arange(KT), np.arange(2 * KT), np.arange(32), indexing="ij")
    row, key = s * 16 + lane // 4, nt * 8 + (lane % 4) * 2
    for i in range(4):
        out[:, row + 8 * (i // 2), key + i % 2] = lanes[..., i]
    return out


def _terms(kind, X, N, key_tiles, seed):
    """Random fp32 terms: a bias, or a mask of arbitrary values (not 0 /
    -100); -> (terms, their fragment form as the wrappers lay it out: K9 /
    K10's up to N = 400, past it at ``key_tiles``, as K11 lays out its
    bias)."""
    t = torch.from_numpy(np.random.default_rng(seed).normal(size=(X, N, N)).astype(np.float32))
    t = t if kind == "bias" else t * 50
    if N > 16 * pwa.KEY_TILES[-1]:
        assert key_tiles == -(-N // 16)
        return t, pwa.fragment_terms(t, N, key_tiles, PADS[kind])
    assert pwa.key_tiles(N) == key_tiles
    return t, (pwa.bias_terms if kind == "bias" else pwa.mask_terms)(t, N)


@pytest.mark.parametrize("kind", ["bias", "mask"])
@pytest.mark.parametrize("N,key_tiles", SHAPES)
def test_fragment_terms_give_back_the_terms(N, key_tiles, kind):
    t, frag = _terms(kind, 3, N, key_tiles, seed=N)
    assert frag.dtype == torch.float32 and frag.is_contiguous()
    assert frag.shape == (3, key_tiles, 2 * key_tiles, 8, 4, 2, 2)
    assert torch.equal(_unpack(frag)[:, :N, :N], t)


@pytest.mark.parametrize("kind", ["bias", "mask"])
@pytest.mark.parametrize("N,key_tiles", SHAPES)
def test_fragment_terms_padding(N, key_tiles, kind):
    """Padded keys: -inf in the bias (out of the softmax), 0 in the mask, in
    every row; padded rows 0 at the real keys (never stored)."""
    _, frag = _terms(kind, 2, N, key_tiles, seed=N + 1)
    full = _unpack(frag)
    assert bool((full[:, :, N:] == PADS[kind]).all())
    assert bool((full[:, N:, :N] == 0).all())


@pytest.mark.parametrize("padded,window,shift", [
    ((4, 56, 56), (4, 7, 7), (0, 3, 3)),      # 8-frame stage 0 at 224^2, 8 x 8 windows
    ((4, 70, 70), (4, 7, 7), (0, 3, 3)),      # the 256^2 clip's stage 0, padded to 70
    ((16, 14, 14), (8, 7, 7), (4, 3, 3)),     # 32 frames, 8 x 7 x 7 windows
])
def test_cached_mask_terms_are_the_grid_windows_masks(padded, window, shift):
    """The Swin model hands K10 its cached mask terms beside the (gd, gh,
    gw, N, N) mask grid the plain version takes: tile w, which K10 reads for
    the window at grid position (i, j, k), w = (i * gh + j) * gw + k, is
    mask_grid[i, j, k], row for row."""
    N = int(np.prod(window))
    cpu = torch.device("cpu")
    terms = pswin._device_constant("mask_terms", padded, window, shift, cpu)
    grid = pswin._device_constant("mask", padded, window, shift, cpu).view(
        *(p // w for p, w in zip(padded, window)), N, N)
    full = _unpack(terms)
    gd, gh, gw = grid.shape[:3]
    for i, j, k in np.ndindex(gd, gh, gw):
        assert torch.equal(full[(i * gh + j) * gw + k, :N, :N], grid[i, j, k])
    assert bool((full[:, :, N:] == 0).all()) and bool((full[:, N:] == 0).all())


def test_mask_terms_are_cached_per_shape():
    """One tensor per (dims, window, shift, device); a new one for a new
    shift; none for an unshifted block."""
    cpu = torch.device("cpu")
    dims, window = (4, 14, 14), (4, 7, 7)
    first = pswin._device_constant("mask_terms", dims, window, (0, 3, 3), cpu)
    assert pswin._device_constant("mask_terms", dims, window, (0, 3, 3), cpu) is first
    other = pswin._device_constant("mask_terms", dims, window, (0, 2, 2), cpu)
    assert other is not first and not torch.equal(other, first)
    assert pswin._device_constant("mask_terms", dims, window, (0, 0, 0), cpu) is None


def _fragment_logits(q, k, bias, mask, scale, key_tiles):
    """A plain reader of the kernels' terms: the scaled products laid out in
    accumulator order, the bias tile of the head and the mask tile of window
    b % nW added entry by entry as the kernels add them, and read back."""
    Bn, nH, N, _ = q.shape
    bias_f = pwa.bias_terms(bias, N)
    mask_f = None if mask is None else pwa.mask_terms(mask, N)
    prod = torch.matmul(q, k.transpose(-1, -2)) * scale
    frag = pwa.fragment_terms(prod.reshape(Bn * nH, N, N), N, key_tiles, 0.0)
    frag = frag.view(Bn, nH, *frag.shape[1:]) + bias_f[None]
    if mask_f is not None:
        nW = mask_f.shape[0]
        frag = (frag.view(Bn // nW, nW, *frag.shape[1:]) + mask_f[None, :, None]).view(frag.shape)
    return _unpack(frag.reshape(Bn * nH, *frag.shape[2:])).view(Bn, nH, 16 * key_tiles,
                                                               16 * key_tiles)[..., :N, :N]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N,key_tiles", [(98, 7), (196, 13)])
def test_fragment_logits_equal_heads_logits(N, key_tiles, masked):
    rng = np.random.default_rng(N + masked)
    Bn, nH, nW = 8, 2, 4
    q, k = (torch.from_numpy(rng.normal(size=(Bn, nH, N, 32)).astype(np.float32))
            for _ in range(2))
    bias = torch.from_numpy(rng.normal(size=(nH, N, N)).astype(np.float32) * 10)
    mask = (torch.from_numpy(rng.normal(size=(nW, N, N)).astype(np.float32) * 30)
            if masked else None)
    scale = 32 ** -0.5
    want = pwa._heads_logits(q, k, bias, mask, scale, torch.float32)
    assert torch.equal(_fragment_logits(q, k, bias, mask, scale, key_tiles), want)


@pytest.mark.parametrize("windows,heads,per", [
    (2048, 4, 7),      # the 8-frame eval's stage 0 (B=32)
    (128, 16, 1),      # its stage 2
    (16, 32, 1),       # the padded 256^2 eval's stage 3 (B=4)
    (1 << 20, 4, 16),  # at most 16
])
def test_windows_per_block(windows, heads, per):
    """Four blocks or more for each of the card's two block slots an SM."""
    got = pwa.windows_per_block(windows, heads, 132)
    assert got == per
    assert -(-windows // got) * heads >= min(windows * heads, 4 * 2 * 132)


def test_kernel_terms_refused_when_they_do_not_fit():
    bias, mask = torch.zeros(2, 98, 98), torch.zeros(4, 98, 98)
    terms = (pwa.bias_terms(bias, 98), pwa.mask_terms(mask, 98))
    assert pwa._kernel_terms(terms, bias, mask, 98) == terms
    with pytest.raises(ValueError):                  # three heads' bias for two
        pwa._kernel_terms((pwa.bias_terms(torch.zeros(3, 98, 98), 98), None), bias, mask, 98)
    with pytest.raises(ValueError):                  # two windows' mask for four
        pwa._kernel_terms((None, terms[1][:2]), bias, mask, 98)
    with pytest.raises(ValueError):                  # terms of 13 key tiles at N=98
        pwa._kernel_terms((pwa.bias_terms(torch.zeros(2, 196, 196), 196), None), bias, None, 98)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_c_entry_points_take_the_bound_arguments(name):
    """Each C entry point's parameters, read from its source, are the
    ctypes argument types ``_build`` binds it with: a count or a type
    that differs would reach the kernel as garbage or be refused."""
    sources = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    found = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", sources)
    assert found, name
    params = [" ".join(p.split()[:-1]).replace(" *", "*") for p in found.group(1).split(",")]
    assert [_C_TYPES[p] for p in params] == list(_build._SIGNATURES[name])
