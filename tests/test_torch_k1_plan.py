"""K1's launch plan and its bias terms (``ops.window_attention.k1_grid``,
``models.swin3d.k1_terms_from_table``), held on the CPU without the card.

- The terms gathered from the relative-position table are bitwise
  ``fragment_bias`` of the bias ``bias_from_table`` gives, and the
  permutation gather K5 takes its column form with is bitwise
  ``fragment_bias`` of the transpose, at each Swin effective window and a
  ragged one.
- ``k1_grid`` at every K1 call shape of the eval, finetune and pretrain
  paths (and shapes that reach each branch of the plan): with the kernel's
  index map mirrored here,
  every (window, head, query strip) is taken exactly once, the windows a
  block takes share a mask row, the blocks an SM the plan counts on fit its
  shared memory, and the grid has a block for each SM.
- A tiny Swin train step and eval forward hand K1 and K5 the terms the
  wrappers would lay out (the wrappers spied on the CPU, where they run
  their plain versions), and give the same loss and table gradients with
  the terms as without (within the CPU's run-to-run summation order).

The ``gpu`` tests launch K1 (every key-tile instance, each plan branch,
shifted and unshifted) and skip without a card:
``python -m pytest tests/test_torch_k1_plan.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from clover_tpu_torch.models import SwinConfig, init_params
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.ops import window_attention as wa
from clover_tpu_torch.ops.preprocess import space_to_depth_host

SMS = 132                      # the H100's SMs
SMEM = 232448                  # shared memory a block may use on it
HEADS, WINDOW = (4, 8, 16, 32), (8, 7, 7)


# ------------------------------------------------------------- the terms

@pytest.mark.parametrize("eff", [(2, 7, 7), (4, 7, 7), (6, 7, 7), (8, 7, 7), (3, 5, 7)])
def test_table_terms_are_the_wrapper_layout(eff):
    """N = 98, 196, 294, 392 and a ragged 105 (7 key tiles, 7 of them
    padded keys), 3 heads, a table with values bf16 rounds."""
    g = torch.Generator().manual_seed(sum(eff))
    L = int(np.prod([2 * w - 1 for w in WINDOW]))
    table = torch.randn(L, 3, generator=g, requires_grad=True) * 3
    N = int(np.prod(eff))
    terms = pswin.k1_terms_from_table(table, WINDOW, eff, pswin.table_ext(table))
    bias = pswin.bias_from_table(table, WINDOW, eff, 3)
    assert terms.dtype == torch.bfloat16 and not terms.requires_grad
    assert torch.equal(terms, wa.fragment_bias(bias, N, wa.key_tiles(N)))
    assert torch.equal(wa.transposed_terms(terms, N),
                       wa.fragment_bias(bias.transpose(1, 2), N, wa.key_tiles(N)))
    # a kept buffer takes the table as it is at each call
    ext = pswin.table_ext(table)
    assert torch.equal(pswin.k1_terms_from_table(table, WINDOW, eff, ext), terms)
    table = table.detach() - 1
    bias = pswin.bias_from_table(table, WINDOW, eff, 3)
    assert torch.equal(pswin.k1_terms_from_table(table, WINDOW, eff, ext),
                       wa.fragment_bias(bias, N, wa.key_tiles(N)))


@pytest.mark.parametrize("N", [16, 64, 100, 256, 400])
def test_transposed_terms_are_the_layout_of_the_transpose(N):
    """The permutation gather at windows with no padding (N = 16 kt) and
    with it, against the wrapper's layout of the transposed bias."""
    bias = torch.randn(2, N, N, generator=torch.Generator().manual_seed(N)) * 3
    kt = wa.key_tiles(N)
    assert torch.equal(wa.transposed_terms(wa.fragment_bias(bias, N, kt), N),
                       wa.fragment_bias(bias.transpose(1, 2), N, kt))


def test_k1_refuses_terms_of_another_shape():
    bias = torch.zeros(2, 98, 98)
    good = wa.fragment_bias(bias, 98, 7)
    assert wa._k1_bias_terms(good, bias, 98, 7) is good
    with pytest.raises(ValueError):                      # 13 key tiles at N=98
        wa._k1_bias_terms(wa.fragment_bias(torch.zeros(2, 196, 196), 196, 13), bias, 98, 7)
    with pytest.raises(ValueError):                      # fp32 terms (K9's)
        wa._k1_bias_terms(wa.bias_terms(bias, 98), bias, 98, 7)


# -------------------------------------------------------------- the plan

def _call_shapes(clips, frames):
    """K1's (Bn, N, nH, nW) calls of one forward of ``clips`` clips of
    ``frames`` x 224^2 (Swin-B, unshifted and shifted blocks)."""
    dims = (frames // 2, 56, 56)
    shift = tuple(w // 2 for w in WINDOW)
    out = []
    for nH in HEADS:
        window, sh = pswin.effective_window(dims, WINDOW, shift)
        N = int(np.prod(window))
        Bn = clips * int(np.prod(dims)) // N
        out.append((Bn, N, nH, 1))
        ids = pswin._shift_region_ids(dims, window, sh)
        if ids is not None:
            out.append((Bn, N, nH, ids.shape[0]))
        dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
    return out


# eval8 (B=32 x 8 frames); pretrain / P8E (2 x 8 clips of 8 frames); the
# 12-frame finetune (B=16); the 32-frame finetune and P32 (K6's recompute)
PATHS = {"eval8": (32, 8), "pretrain": (16, 8), "finetune12": (16, 12), "finetune32": (16, 32)}
SHAPES = [(path, *shape) for path, (clips, frames) in PATHS.items()
          for shape in _call_shapes(clips, frames)]


def _coverage(grid, Bn, N, nH, nW):
    """How often each (window, head, strip) is taken under ``grid``, as the
    kernel's blocks read blockIdx (csrc/window_attention.cu: block x takes
    head x % nH and clips [c0, c0 + per) of mask row w, e = x / nH = w *
    chunks + c0 / per), and whether every block's windows share a mask
    row."""
    strips = -(-N // 16)
    seen = np.zeros((Bn, nH, strips), np.int64)
    one_row = True
    clips = Bn // nW
    chunks = -(-clips // grid.per)
    assert grid.blocks == nH * nW * chunks
    for x in range(grid.blocks):
        h, e = x % nH, x // nH
        w, c0 = e // chunks, (e % chunks) * grid.per
        b = np.arange(c0, min(c0 + grid.per, clips)) * nW + w
        one_row &= bool(np.all(b % nW == w))
        seen[b, h, :] += 1
    return seen, one_row


def _check_plan(grid, Bn, N, nH, nW):
    seen, one_row = _coverage(grid, Bn, N, nH, nW)
    assert seen.min() == seen.max() == 1
    assert one_row
    # two blocks an SM fit its shared memory, three where the registers are capped for three
    assert grid.smem <= SMEM and grid.smem * max(2, grid.min_blocks) <= wa._K1_SMEM_SM
    assert grid.blocks >= SMS


@pytest.mark.parametrize("path,Bn,N,nH,nW", SHAPES)
def test_k1_grid_takes_every_strip_once(path, Bn, N, nH, nW):
    _check_plan(wa.k1_grid(Bn, nH, N, SMS, nW), Bn, N, nH, nW)


@pytest.mark.parametrize("Bn,N,nH,nW,plan", [
    (520, 196, 2, 4, (4, 1)),      # a walk of 4 on two buffers, the last chunk of a row ragged
    (24, 50, 2, 4, (1, 1)),        # too few pairs for a wave: one window a block
    (800, 98, 2, 4, (1, 3)),       # four waves: one window a block, the registers capped
    (520, 294, 2, 4, (1, 1)),      # one buffer at 19 tiles: no walk
    (800, 392, 2, 1, (1, 3)),      # q read per warp at 25 tiles, capped
])
def test_k1_grid_variants_take_every_strip_once(Bn, N, nH, nW, plan):
    """The shapes ``test_k1_plans_on_card`` runs, one for each branch of the
    plan: (clips a block, blocks an SM the registers are capped for)."""
    grid = wa.k1_grid(Bn, nH, N, SMS, nW)
    assert (grid.per, grid.min_blocks) == plan
    seen, one_row = _coverage(grid, Bn, N, nH, nW)
    assert seen.min() == seen.max() == 1 and one_row


def test_k1_grid_fills_a_wave_and_walks_what_is_left():
    """A large call (four waves of one-window blocks at three an SM) takes
    one window a block, its registers capped for three an SM; a smaller one
    at 13 key tiles the most clips a block that still give a full wave at
    two an SM, on two buffers (2 at P8E's stage 3, 512 pairs); at 19 and
    25 tiles one window a block, q staged at 19 and not at 25."""
    assert wa.k1_grid(2048, 4, 196, SMS)[:2] == (1, 3)
    small = wa.k1_grid(16, 32, 196, SMS)
    assert small[:2] == (2, 1) and small.blocks == 256 >= 0.95 * 2 * SMS
    assert small.smem == wa._k1_smem(13, 3, 2) <= wa._K1_STAGE_LIMIT
    assert wa.k1_grid(32, 32, 196, SMS)[:2] == (4, 1)
    assert wa.k1_grid(1024, 4, 294, SMS)[:2] == (1, 3)
    assert wa.k1_grid(16, 32, 294, SMS)[:2] == (1, 1)
    assert wa.k1_grid(2048, 4, 392, SMS)[:2] == (1, 3)
    assert [wa._k1_tiles(kt) for kt in wa.KEY_TILES] == [3, 3, 3, 3, 3, 2]
    assert [wa._k1_stages(kt, 2) for kt in wa.KEY_TILES] == [2, 2, 2, 1, 1, 1]


# ---------------------------------------------------- the model's terms

def _tiny_swin(**kw):
    cfg = SwinConfig(embed_dim=64, depths=(2, 2), num_heads=(2, 4), drop_path_rate=0.0,
                     fold_normalize=True, **kw)
    model = pswin.SwinTransformer3D(cfg, kernels=True)
    init_params(model, torch.Generator().manual_seed(0))
    with torch.no_grad():   # tables far from zero, so a dropped term would show
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0, 1.0, generator=torch.Generator().manual_seed(len(name)))
    return model


def _clip(frames=4, size=56):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(2, frames, size, size, 3), dtype=np.uint8)
    return torch.from_numpy(space_to_depth_host(x).astype(np.float32))


def _spy(monkeypatch, seen):
    """Record (bias, terms) at each K1 and K5 wrapper call and each K1 op
    call (the eval route), then run it."""
    fwd, bwd, op = wa.flat2_window_attention, wa.flat2_window_attention_bwd, \
        pswin.library.k1_window_attention

    def k1(qkv2, bias, region_ids, scale, num_heads, N, terms=None):
        seen.append(("K1", bias, terms))
        return fwd(qkv2, bias, region_ids, scale, num_heads, N, terms)

    def k1_op(qkv2, bias, region_ids, scale, num_heads, N, terms):
        seen.append(("K1", bias, terms))
        return op(qkv2, bias, region_ids, scale, num_heads, N, terms)

    def k5(qkv2, bias, region_ids, g2, scale, num_heads, N, terms=None):
        seen.append(("K5", bias, terms))
        return bwd(qkv2, bias, region_ids, g2, scale, num_heads, N, terms)

    monkeypatch.setattr(wa, "flat2_window_attention", k1)
    monkeypatch.setattr(wa, "flat2_window_attention_bwd", k5)
    monkeypatch.setattr(pswin.library, "k1_window_attention", k1_op)


def _step(model, x):
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(x, generator=torch.Generator().manual_seed(1))
    loss = (out.float() * torch.linspace(-1, 1, out.shape[-1])).square().mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if n.endswith("relative_position_bias_table")}
    return loss.detach(), grads


@pytest.mark.parametrize("fused_attn", ["off", "on"])
def test_train_step_hands_k1_and_k5_the_wrapper_layout(fused_attn, monkeypatch):
    """Every K1 call (the forward; with fused_attn 'on' the recompute in
    K6's backward) and every K5 call gets the table-gathered terms, bitwise
    the wrappers' own layout of the bias they are given; the loss is
    bitwise that of the same step with the terms left to the wrappers,
    every table gradient within 1e-6 of its max (the CPU sums the table's
    index backward in a thread-dependent order: ~1e-12 of ~5e-5 between two
    runs of one step)."""
    model, x = _tiny_swin(fused_attn=fused_attn), _clip()
    seen = []
    _spy(monkeypatch, seen)
    loss, grads = _step(model, x)
    assert [k for k, *_ in seen].count("K1") == 4 and [k for k, *_ in seen].count("K5") == 4
    for kind, bias, terms in seen:
        N = bias.shape[-1]
        assert terms is not None
        assert torch.equal(terms, wa.fragment_bias(bias, N, wa.key_tiles(N)))
    monkeypatch.setattr(pswin.WindowAttention3D, "k1_terms", lambda *a: None)
    seen.clear()
    loss0, grads0 = _step(model, x)
    assert all(terms is None for *_, terms in seen)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys() and len(grads) == 4
    for name in grads:   # the table's index backward sums in a thread-dependent order
        tol = 1e-6 * grads[name].abs().max().item()
        torch.testing.assert_close(grads[name], grads0[name], rtol=0, atol=tol, msg=name)


def test_eval_keeps_k1_terms_with_the_cached_bias(monkeypatch):
    """In eval with the bias cache, K1 gets the layout the cache carries
    (``swin_bias_cache`` lays each K1 block's bias out once, under its name
    + TERMS): that tensor itself in every forward, equal to
    ``fragment_bias`` of the cached bias; a new cache gives its own."""
    model, x = _tiny_swin(), _clip()
    model.eval()
    seen = []
    _spy(monkeypatch, seen)
    cache = pswin.swin_bias_cache(model, model.cfg, (2, 14, 14))
    names = [k for k in cache if not k.endswith(pswin.TERMS)]
    assert len(names) == 4 and all(n + pswin.TERMS in cache for n in names)
    with torch.inference_mode():
        model(x, bias_cache=cache)
        model(x, bias_cache=cache)
        fresh_cache = {k: v.clone() for k, v in cache.items()}
        model(x, bias_cache=fresh_cache)
    assert len(seen) == 12
    for name, first, again, fresh in zip(names, seen[:4], seen[4:8], seen[8:]):
        N = first[1].shape[-1]
        assert first[2] is cache[name + pswin.TERMS] and again[2] is first[2]
        assert fresh[2] is fresh_cache[name + pswin.TERMS]
        assert torch.equal(first[2], wa.fragment_bias(cache[name], N, wa.key_tiles(N)))


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_case(dev, Bn, N, nH, shifted, seed):
    """qkv (Bn N, 3C) bf16, an fp32 bias of magnitude ~3 and, shifted,
    region ids of 4 mask rows in 3 regions, on the card."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(Bn * N, 3 * nH * 32)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(nH, N, N)).astype(np.float32) * 3)
    ids = None
    if shifted:
        ids = torch.from_numpy(rng.integers(0, 3, size=(4, N)).astype(np.int32)).to(dev)
    return qkv.to(dev, torch.bfloat16), bias.to(dev), ids


# Bn of each plan branch (nH=2, at most 4 mask rows): too few pairs for a
# wave (one window a block), a walk on two buffers where they fit (13 key
# tiles and fewer; the last chunk of a row ragged), four waves (one window
# a block, the registers capped for three blocks an SM)
CARD_BN = (24, 520, 800)


@pytest.mark.gpu
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("N", [50, 98, 196, 256, 294, 392])
def test_k1_plans_on_card(cuda, N, shifted):
    """K1 at each key-tile instance (4, 7, 13, 16, 19, 25) at call shapes
    that reach each branch of its plan (``CARD_BN``): within TOL["K1"]
    (2e-2 + 1e-2 max|plain|) of the plain version, and a smaller call
    bitwise the first windows of a larger one (a strip runs the same code
    whatever block walks it); two calls bitwise equal; the wrapper on given
    terms bitwise the wrapper's own layout."""
    nH = 2
    nW = 4 if shifted else 1
    qkv, bias, ids = _card_case(cuda, CARD_BN[-1], N, nH, shifted, N)
    scale = 32 ** -0.5
    bias_c = bias.to(torch.bfloat16)
    terms = wa.fragment_bias(bias_c, N, wa.key_tiles(N))
    ref = wa.window_attention_plain(qkv, bias, ids, scale, nH, N)
    plans, outs = set(), []
    for Bn in CARD_BN:
        part = qkv[:Bn * N]
        grid = wa.k1_grid(Bn, nH, N, SMS, nW)
        plans.add((grid.per > 1, grid.min_blocks))
        got = wa.flat2_window_attention(part, bias_c, ids, scale, nH, N)
        again = wa.flat2_window_attention(part, bias_c, ids, scale, nH, N, terms)
        torch.cuda.synchronize()
        assert torch.equal(got, again), Bn
        outs.append(got)
    want = {(False, 1), (False, 3)} | ({(True, 1)} if wa.key_tiles(N) <= 13 else set())
    assert plans == want
    err = (outs[-1].float() - ref.float()).abs().max().item()
    assert err <= 2e-2 + 1e-2 * ref.float().abs().max().item(), err
    for Bn, got in zip(CARD_BN, outs):
        assert torch.equal(got, outs[-1][:Bn * N]), Bn


@pytest.mark.gpu
def test_k1_and_k5_on_gathered_terms_keep_their_bits_on_card(cuda):
    """At the 8-frame stage-2 window (N=196, 16 heads, shifted), K1 and K5
    on the terms gathered from the table (K5's transposed form gathered from
    them) give bitwise the outputs of the wrappers' own layout of the
    table's bias."""
    Bn, N, nH = 64, 196, 16
    qkv, _, ids = _card_case(cuda, Bn, N, nH, True, 7)
    L = int(np.prod([2 * w - 1 for w in WINDOW]))
    table = torch.randn(L, nH, generator=torch.Generator().manual_seed(3)).to(cuda)
    bias = pswin.bias_from_table(table, WINDOW, (4, 7, 7), nH).to(torch.bfloat16)
    terms = pswin.k1_terms_from_table(table, WINDOW, (4, 7, 7), pswin.table_ext(table))
    g = torch.randn(Bn * N, nH * 32, generator=torch.Generator().manual_seed(4)).to(
        cuda, torch.bfloat16)
    scale = 32 ** -0.5
    assert torch.equal(wa.flat2_window_attention(qkv, bias, ids, scale, nH, N, terms),
                       wa.flat2_window_attention(qkv, bias, ids, scale, nH, N))
    got = wa.flat2_window_attention_bwd(qkv, bias, ids, g, scale, nH, N, terms)
    want = wa.flat2_window_attention_bwd(qkv, bias, ids, g, scale, nH, N)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
