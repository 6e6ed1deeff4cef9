"""The eval kernels as registered torch ops (``clover_tpu_torch/ops/library.py``).

For each op (K1, K2, K3, K4, K6, K9, K10, K11 head-major and flat), on
seeded inputs at shapes the kernels take (head dim 32, C and H multiples of
128), with and without the region mask where the op has one:

- its CPU implementation is its plain version, bitwise, and counts one call;
- its fake implementation (under ``FakeTensorMode``) gives the real
  output's shape and dtype and reads no data;
- ``torch.library.opcheck`` passes (schema, autograd registration, fake
  tensor, AOT dispatch);
- on the card (``gpu``, skipped here) the op equals the direct call of its
  wrapper bitwise and counts one launch in the wrapper; it raises where its
  kernel refuses the call; and a wrapper traced by ``torch.export`` without
  its op raises (no plain version in its place):
  ``python -m pytest tests/test_torch_ops_library.py -m gpu --noconftest``.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from clover_tpu_torch import ops
from clover_tpu_torch.ops import library
from clover_tpu_torch.ops import window_attention as wa

HD = 32


def _case(name, dev, dtype, masked):
    """(op, args, plain version or wrapper's args) for one op on ``dev``:
    activations in ``dtype``, parameters fp32."""
    g = torch.Generator().manual_seed(sum(map(ord, name)) + masked)

    def t(*shape, std=1.0, dt=None):
        return (torch.randn(*shape, generator=g) * std).to(dev, dt or dtype)

    def f32(*shape, std=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=g) * std).to(dev)

    def ids(nW, N):
        return torch.randint(0, 3, (nW, N), generator=g, dtype=torch.int32).to(dev)

    scale = HD ** -0.5
    if name == "k1":
        nH, N, Bn = 2, 49, 4
        bias = f32(nH, N, N).to(dtype)
        terms = wa.fragment_bias(bias, N, wa.key_tiles(N))
        rid = ids(2, N) if masked else None
        return (library.k1_window_attention, (t(Bn * N, 3 * nH * HD), bias, rid, scale, nH, N,
                                              terms), wa.flat2_window_attention)
    if name == "k2":
        C, H = 128, 512
        return (library.k2_ln_mlp_residual, (t(64, C), f32(C, mean=1.0, std=0.1), f32(C, std=0.1),
                                             f32(H, C, std=0.05), f32(H, std=0.1),
                                             f32(C, H, std=0.05), f32(C, std=0.1), 1e-5, "tanh"),
                ops.fused_ln_mlp_residual)
    if name == "k3":
        C, H = 128, 256
        return (library.k3_mlp_postln, (t(64, C), f32(C, mean=1.0, std=0.1), f32(C, std=0.1),
                                        f32(H, C, std=0.05), f32(H, std=0.1), f32(C, H, std=0.05),
                                        f32(C, std=0.1), 1e-12), ops.fused_mlp_postln)
    if name == "k4":
        C = 128
        return (library.k4_layer_norm, (t(64, C), f32(C, mean=1.0, std=0.1), f32(C, std=0.1),
                                        1e-5), ops.fused_layer_norm)
    if name == "k6":
        nH, N, Bn = 4, 49, 4
        C = nH * HD
        return (library.k6_window_attn_block,
                (t(Bn * N, C), f32(C, mean=1.0, std=0.1), f32(C, std=0.1),
                 f32(3 * C, C, std=0.05), f32(3 * C, std=0.1), f32(nH, N, N),
                 ids(2, N) if masked else None, f32(C, C, std=0.05), f32(C, std=0.1), scale, nH,
                 N, 1e-5), ops.fused_window_attn_block)
    if name == "k9":
        nH, N, Bn = 2, 49, 4
        bias = f32(nH, N, N)
        mask = (f32(2, N, N) < 0).float() * -100.0 if masked else None
        mt = None if mask is None else wa.mask_terms(mask, N)
        return (library.k9_window_attention_heads,
                (t(Bn, nH, N, HD), t(Bn, nH, N, HD), t(Bn, nH, N, HD), bias, mask, scale,
                 wa.bias_terms(bias, N), mt), ops.fused_window_attention)
    if name == "k10":
        nH, window, grid = 2, [2, 7, 7], (1, 2, 2)
        N = 98
        bias = f32(nH, N, N)
        mask = (f32(*grid, N, N) < 0).float() * -100.0 if masked else None
        mt = None if mask is None else wa.mask_terms(mask.view(-1, N, N), N)
        return (library.k10_window_attention_grid,
                (t(1, 2, 14, 14, 3, nH, HD), bias, mask, window, scale, wa.bias_terms(bias, N),
                 mt), ops.spatial_window_attention)
    nH, N, Bn = 2, 100, 4
    bias = f32(nH, N, N).to(dtype)
    rid = ids(2, N) if masked else None
    if name == "k11h":
        return (library.k11_flash_attention_heads,
                (t(Bn, nH, N, HD), t(Bn, nH, N, HD), t(Bn, nH, N, HD), bias, rid, scale),
                ops.flash_window_attention)
    return (library.k11_flash_attention_flat, (t(Bn * N, 3 * nH * HD), bias, rid, scale, nH, N),
            ops.flat_flash_window_attention)


PLAIN = {"k1": lambda a: wa.window_attention_plain(*a[:6]),
         "k2": lambda a: ops.ln_mlp_residual_plain(*a),
         "k3": lambda a: ops.mlp_postln_plain(*a),
         "k4": lambda a: ops.layer_norm_plain(*a),
         "k6": lambda a: ops.window_attn_block_plain(*a),
         "k9": lambda a: wa.window_attention_heads_plain(*a[:6]),
         "k10": lambda a: wa.spatial_window_attention_plain(*a[:3], tuple(a[3]), a[4]),
         "k11h": lambda a: wa.window_attention_long_plain(*a),
         "k11f": lambda a: wa.window_attention_flat_flash_plain(*a)}
MASKED = {"k1", "k6", "k9", "k10", "k11h", "k11f"}
CASES = [(name, masked) for name in PLAIN for masked in ((False, True) if name in MASKED
                                                         else (False,))]


def _wrapper_args(name, args):
    """The op's arguments as its wrapper takes them (K9 / K10 take their
    terms as one pair, K10 its window as a tuple)."""
    if name == "k9":
        return (*args[:6], (args[6], args[7]))
    if name == "k10":
        return (*args[:3], tuple(args[3]), args[4], (args[5], args[6]))
    return args


def test_every_op_is_registered_once_in_the_clover_namespace():
    names = {op._opoverload._schema.name for op in library.OPS}
    assert len(library.OPS) == len(names) == 9 and all(n.startswith("clover::") for n in names)
    assert set(library.calls) == {n.split("::")[1] for n in names}


@pytest.mark.parametrize("name,masked", CASES)
def test_cpu_implementation_is_the_plain_version(name, masked):
    op, args, _ = _case(name, "cpu", torch.float32, masked)
    library.reset_call_counts()
    got = op(*args)
    assert torch.equal(got, PLAIN[name](args))
    assert library.call_counts()[op._opoverload._schema.name.split("::")[1]] == 1
    assert sum(library.call_counts().values()) == 1


@pytest.mark.parametrize("name,masked", CASES)
def test_fake_implementation_gives_the_output_shape_and_dtype(name, masked):
    op, args, _ = _case(name, "cpu", torch.float32, masked)
    real = op(*args)
    library.reset_call_counts()
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = op(*fake_args)
    assert fake.shape == real.shape and fake.dtype == real.dtype
    assert not any(library.call_counts().values())


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_opcheck(name):
    op, args, _ = _case(name, "cpu", torch.float32, name in MASKED)
    torch.library.opcheck(op, args)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name,masked", CASES)
def test_op_equals_the_direct_launch_on_card(cuda, name, masked):
    op, args, wrapper = _case(name, cuda, torch.bfloat16, masked)
    with torch.inference_mode():
        want = wrapper(*_wrapper_args(name, args))
        before = wrapper.launches
        got = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_op_raises_where_its_kernel_refuses_on_card(cuda):
    """The CUDA implementation launches or raises: no plain fallback (K1
    takes head dim 32 only)."""
    x = torch.zeros(49 * 2, 3 * 2 * 16, dtype=torch.bfloat16, device=cuda)
    bias = torch.zeros(2, 49, 49, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim 32"):
        library.k1_window_attention(x, bias, None, 0.25, 2, 49, None)


@pytest.mark.gpu
def test_tracing_a_wrapper_without_its_op_raises_on_card(cuda):
    """On the card a wrapper traced without its op reads a data pointer the
    traced tensor has not: the export raises, it does not fall back; the
    same call through the op exports as one op node."""

    class Direct(torch.nn.Module):
        def forward(self, x, w, b):
            return ops.fused_layer_norm(x, w, b)

    class Op(torch.nn.Module):
        def forward(self, x, w, b):
            return library.k4_layer_norm(x, w, b, 1e-5)

    args = (torch.zeros((4, 128), dtype=torch.bfloat16, device=cuda),
            torch.ones(128, device=cuda), torch.zeros(128, device=cuda))
    with pytest.raises(Exception):
        torch.export.export(Direct(), args, strict=False)
    ep = torch.export.export(Op(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets == ["clover.k4_layer_norm.default"]
