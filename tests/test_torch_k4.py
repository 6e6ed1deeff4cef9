"""K4, the LayerNorm kernel (``ops.layer_norm``): its launch plan and its
plain version, held on the CPU without the card.

- ``k4_plan`` at every K4 call shape of the 8-frame, 32-frame and E32L eval
  forwards and at ragged row counts: with the kernel's index map mirrored
  here (``csrc/layer_norm.cu``: warp w of the grid walks steps w, w + W,
  ...; step s takes rows s R + j G + g), every row is taken exactly once,
  every column once, and a warp walks at most ``_K4_STEPS`` steps.
- ``ln_sweep``'s call shapes are ``chip_smoke.py``'s at 8 and 32 frames.
- ``k4_plan`` picks the instance the C source builds for each path width,
  the generic path for an even C without one, and raises on odd C.
- ``layer_norm_plain`` against the JAX kernel in Pallas interpret mode
  (``_FORCE_PALLAS``) in fp32: 2e-5 absolute and relative, fp32
  summation-order noise.

The ``gpu`` tests launch K4 and skip without a card: the kernel against
its plain version at every path width and at ragged rows within
``chip_smoke.py``'s K4 limit (1e-2 absolute + 1e-2 of max |plain|), every
plan the C entry takes bitwise equal, one launch a call, the refusals:
``python -m pytest tests/test_torch_k4.py -m gpu --noconftest``.
"""

import importlib.util
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from clover_tpu_torch import ops
from clover_tpu_torch.ops import _build
from clover_tpu_torch.ops import layer_norm as pln
from clover_tpu_torch.ops.ln_sweep import ROUTES, k4_shapes

SMS = 132   # the H100's SMs

PATH_SHAPES = sorted({shape for route in ("eval8", "eval32", "E32L", "E8P")
                      for shape, _ in k4_shapes(*ROUTES[route])})


def _ragged(C):
    """1 row, a block's step of rows and one more or one fewer."""
    block_rows = pln.k4_plan(1, C, SMS).block_rows
    return [(1, C), (block_rows - 1, C), (block_rows, C), (block_rows + 1, C)]


# at C=128 a lane group takes two rows a step: 4 k + 1 rows leaves the
# last step one row, so its warp's second row (and its second group) empty
RAGGED = sorted({s for C in pln._K4_INSTANCES for s in _ragged(C)} | {(4 * 997 + 1, 128)})


@pytest.fixture
def jx():
    jnp = pytest.importorskip("jax.numpy")
    import clover_tpu.ops.layer_norm as ln

    return types.SimpleNamespace(jnp=jnp, ln=ln)


# ------------------------------------------------------------------ the plan

def _walk(plan, rows, C):
    """How often the kernel takes each row and each column under ``plan``,
    and the most steps a warp walks."""
    T, V, RPT = plan.threads, plan.vectors, plan.rows_per_group
    G = 32 // T
    R = G * RPT
    steps = -(-rows // R)
    W = plan.blocks * pln._K4_WARPS
    walks = [np.arange(w, steps, W) for w in range(min(W, steps))]
    taken = np.concatenate(walks)
    row_ids = (taken[:, None, None] * R + np.arange(RPT)[None, :, None] * G
               + np.arange(G)[None, None, :]).ravel()
    seen = np.bincount(row_ids[row_ids < rows], minlength=rows)
    cols = np.bincount((8 * (np.arange(T)[:, None] + T * np.arange(V)[None, :])[..., None]
                        + np.arange(8)).ravel(), minlength=C)
    return seen, cols, max(len(w) for w in walks)


@pytest.mark.parametrize("rows,C", PATH_SHAPES + RAGGED)
def test_k4_plan_takes_every_row_and_column_once(rows, C):
    plan = pln.k4_plan(rows, C, SMS)
    assert plan.block_rows == pln._K4_WARPS * 32 // plan.threads * plan.rows_per_group
    need = -(-rows // plan.block_rows)
    assert min(need, SMS) <= plan.blocks <= need
    seen, cols, longest = _walk(plan, rows, C)
    assert (seen == 1).all()
    assert (cols == 1).all() and len(cols) == C
    assert longest <= pln._K4_STEPS


@pytest.mark.parametrize("frames,route", [(8, "eval8"), (32, "eval32")])
def test_sweep_shapes_are_the_smoke_runs(frames, route):
    """``ln_sweep``'s K4 calls a forward are those ``chip_smoke.py`` checks
    and counts (42 at 8 frames, 18 at 32)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from clover_tpu_torch.models import BertConfig, FinetuneConfig, SwinConfig

    cfg = FinetuneConfig(swin=SwinConfig.base(fold_normalize=True), text_bert=BertConfig())
    calls = {}
    for shape, count in smoke.path_shapes(cfg, frames)["K4"]:
        calls[shape] = calls.get(shape, 0) + count
    assert calls == dict(k4_shapes(*ROUTES[route]))
    assert sum(calls.values()) == {8: 42, 32: 18}[frames]


@pytest.mark.parametrize("C", sorted(pln._K4_INSTANCES))
def test_k4_plan_takes_the_instance_of_each_path_width(C):
    """The instance the plan names is one ``csrc/layer_norm.cu`` builds
    (its ``CLOVER_K4(C, threads, vectors, rows_per_group)`` lines) and
    covers the width in 16-byte vectors."""
    built = {tuple(map(int, m)) for m in re.findall(
        r"CLOVER_K4\((\d+), (\d+), (\d+), (\d+)\)",
        (_build.CSRC / "layer_norm.cu").read_text())}
    assert {(c, *inst) for c, inst in pln._K4_INSTANCES.items()} == built
    plan = pln.k4_plan(25088, C, SMS)
    assert (C, plan.threads, plan.vectors, plan.rows_per_group) in built
    assert 8 * plan.threads * plan.vectors == C and 32 % plan.threads == 0
    assert C in {C for _, C in PATH_SHAPES}


@pytest.mark.parametrize("C", [2, 6, 100, 770])
def test_k4_plan_takes_the_generic_path_for_other_even_widths(C):
    plan = pln.k4_plan(1001, C, SMS)
    assert plan == pln.K4Plan(32, 0, 1, pln._K4_WARPS, -(-1001 // pln._K4_WARPS))


@pytest.mark.parametrize("C", [0, 1, 127, 769])
def test_k4_plan_refuses_odd_widths(C):
    with pytest.raises(ValueError):
        pln.k4_plan(100, C, SMS)


# ------------------------------------------------------ against the JAX kernel

@pytest.mark.parametrize("C", [128, 512, 1024, 2048])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_plain_matches_pallas(C, eps, jx, monkeypatch):
    """37 rows: the JAX kernel's row block covers them with a ragged edge."""
    monkeypatch.setattr(jx.ln, "_FORCE_PALLAS", True)
    rng = np.random.default_rng(C)
    x = rng.normal(size=(37, C)).astype(np.float32) * 2 + 0.5
    w = rng.normal(size=C).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32) * 0.1
    ref = jx.ln.fused_layer_norm(jx.jnp.asarray(x), jx.jnp.asarray(w), jx.jnp.asarray(b), eps)
    got = pln.layer_norm_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(rows, C, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (2 * torch.randn(rows, C, generator=g, device=dev) + 0.5).bfloat16()
    w = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
    b = 0.1 * torch.randn(C, generator=g, device=dev)
    return x, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("C", sorted(pln._K4_INSTANCES) + [6, 100])
def test_k4_matches_plain_on_card(cuda, C):
    """Every path width and two generic ones, at ragged row counts, a
    mid-sized call and one that walks (more steps than a wave of warps)."""
    for rows in sorted({r for r, c in _ragged(C if C in pln._K4_INSTANCES else 128)}
                       | {4 * 997 + 1, 25088, 200_003}):
        x, w, b = _inputs(rows, C, cuda, rows)
        got = ops.fused_layer_norm(x, w, b, 1e-5)
        ref = ops.layer_norm_plain(x, w, b, 1e-5).float()
        err = (got.float() - ref).abs().max().item()
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert err <= 1e-2 + 1e-2 * ref.abs().max().item(), (rows, C, err)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,C", [(25088, 512), (6272, 2048), (960, 768), (401408, 128)])
def test_k4_plans_give_the_same_bits(cuda, rows, C):
    """Two public calls, and the kernel under any grid the C entry takes (a
    block, a block an SM, a block a step), are bitwise equal."""
    x, w, b = _inputs(rows, C, cuda)
    first, again = ops.fused_layer_norm(x, w, b), ops.fused_layer_norm(x, w, b)
    plan = pln.k4_plan(rows, C, _build.sms(cuda))
    for blocks in (1, _build.sms(cuda), -(-rows // plan.block_rows)):
        out = torch.full_like(x, float("nan"))
        _build.launch("clover_layer_norm", x, w, b, out, rows, C, plan.threads, plan.vectors,
                      plan.rows_per_group, blocks, 1e-5, _build.stream(cuda))
        torch.cuda.synchronize()
        assert torch.equal(out, first), blocks
    assert torch.equal(first, again)


@pytest.mark.gpu
def test_k4_launches_once_a_call(cuda):
    x, w, b = _inputs(960, 768, cuda)
    before = ops.fused_layer_norm.launches
    out = ops.fused_layer_norm(x.view(32, 30, 768), w, b, 1e-12)
    assert ops.fused_layer_norm.launches == before + 1 and out.shape == (32, 30, 768)
    # a permuted x that reshape copies: the output keeps x's shape
    xt = x.view(30, 32, 768).transpose(0, 1)
    got, ref = ops.fused_layer_norm(xt, w, b), ops.layer_norm_plain(xt, w, b).float()
    assert got.shape == xt.shape and ops.fused_layer_norm.launches == before + 2
    assert (got.float() - ref).abs().max().item() <= 1e-2 + 1e-2 * ref.abs().max().item()
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        assert _build.stream(cuda) == side.cuda_stream
    assert side.cuda_stream != torch.cuda.default_stream(cuda).cuda_stream
    assert _build.stream(cuda) == torch.cuda.current_stream(cuda).cuda_stream


@pytest.mark.gpu
def test_k4_refuses_what_it_cannot_run(cuda):
    x, w, b = _inputs(64, 256, cuda)
    wide = torch.zeros(64, 512, device=cuda, dtype=torch.bfloat16)
    bad = {
        "fp32 x": (x.float(), w, b),
        "bf16 weight": (x, w.bfloat16(), b),
        "misaligned x": (x.view(-1)[1:1 + 63 * 256].view(63, 256), w, b),
        "non-contiguous x": (wide[:, :256], w, b),
        "odd C": (torch.zeros(64, 255, device=cuda, dtype=torch.bfloat16), w[:255], b[:255]),
        "weight of another width": (x, w[:128], b),
        "weight on the CPU": (x, w.cpu(), b),
    }
    for what, args in bad.items():
        with pytest.raises(ValueError):
            ops.fused_layer_norm(*args)
            pytest.fail(what)
    plan = pln.k4_plan(64, 256, _build.sms(cuda))
    out = torch.empty_like(x)
    for wrong in ((16, 2, 1, plan.blocks), (plan.threads, plan.vectors, plan.rows_per_group, 0),
                  (plan.threads, plan.vectors, plan.rows_per_group, plan.blocks + 1)):
        with pytest.raises(RuntimeError):
            _build.launch("clover_layer_norm", x, w, b, out, 64, 256, *wrong, 1e-5,
                          _build.stream(cuda))
