"""The port's Swin under ``attention_impl``, ``window_resident`` and
``long_attn`` held against the JAX package on the CPU, in fp32.

- (c) a tiny backbone (embed dim 64, head dim 32, depths 2/2/2) on clips of
  4 x 72^2 -- token dims (2, 18, 18), (2, 9, 9), (2, 5, 5): the first two
  stages pad (to 21 and 14), every stage has a shifted block, the last is
  window-resident where the config allows it -- through bridged JAX
  weights, for each attention route x ``window_resident``; and one stage
  at the 32-frame window (N=392) under ``long_attn`` 'v6' / 'v7' against
  the JAX flat route sent to ``_forward_long_from_flat`` /
  ``_forward_flat_flash`` (``CLOVER_WA_LONG``). The JAX Pallas kernels run
  in interpret mode. Tolerance 1e-4, fp32 summation order.

The slice and the train steps under these options are in
test_torch_spatial_slice.py.
"""

import types

import numpy as np
import pytest
import torch

from clover_tpu_torch.models import SwinConfig, load_jax_params
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.ops import window_attention as pwa
from clover_tpu_torch.ops.preprocess import space_to_depth_host

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(embed_dim=64, depths=(2, 2, 2), num_heads=(2, 4, 8), fold_normalize=True,
            drop_path_rate=0.0)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules under test."""
    jnp = pytest.importorskip("jax.numpy")
    import jax

    import clover_tpu.models.swin3d as swin
    import clover_tpu.ops.window_attention as wa

    return types.SimpleNamespace(jax=jax, jnp=jnp, swin=swin, wa=wa)


def _clips(frames, size, seed=0, batch=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(batch, frames, size, size, 3), dtype=np.uint8)
    return space_to_depth_host(x).astype(np.float32)


def _fill(jx, shapes, seed=0):
    """The parameter tree's shapes filled with seeded values (as
    test_torch_bridge.random_jax_params): LN scales near 1, Dense kernels
    at 1/sqrt(fan-in), tables at 0.5, other leaves at 0.1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.normal(size=shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name == "kernel":
            z = z / np.sqrt(shape[0])
        else:
            z = (0.5 if name == "relative_position_bias_table" else 0.1) * z
        return z.astype(np.float32)

    return jx.jax.tree_util.tree_map_with_path(fill, shapes)


def _backbones(jx, x, port_only=None, **fields):
    """(JAX output, port output, port backbone) of one tiny Swin config
    (``fields``; ``port_only``: the port's fields the JAX config lacks) on
    the clips x, the port loaded with the JAX weights."""
    jm = jx.swin.SwinTransformer3D(jx.swin.SwinConfig(embed_impl="host_s2d", **fields))
    xj = jx.jnp.asarray(x)
    params = _fill(jx, jx.jax.eval_shape(lambda: jm.init(jx.jax.random.PRNGKey(0), xj)))
    ref = np.asarray(jx.jax.jit(jm.apply)(params, xj))
    pm = pswin.SwinTransformer3D(SwinConfig(**fields, **(port_only or {})))
    load_jax_params(pm, params)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x)).numpy()
    return ref, got, pm


def _counting(monkeypatch, module, name, calls):
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(name) or real(*a, **k))


# ------------------------------------------------------- (c) the backbone

@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "pallas_fused", "xla_headloop", "xla"])
def test_backbone_matches_jax(impl, resident, jx, monkeypatch):
    """Every attention route with and without window-resident stages; the
    port's routes counted: K9's wrapper in every block under 'pallas', K10's
    under 'pallas_fused' (every stage spatial), neither under the plain
    routes; the padded stages always spatial."""
    calls = []
    for name in ("fused_window_attention", "spatial_window_attention"):
        _counting(monkeypatch, pwa, name, calls)
    _counting(monkeypatch, pswin.SwinBlock3D, "_spatial_call", calls)
    ref, got, _ = _backbones(jx, _clips(4, 72), attention_impl=impl, window_resident=resident,
                             **TINY)
    assert got.shape == ref.shape == (1, 2, 5, 5, 256)
    np.testing.assert_allclose(got, ref, **TOL)
    spatial = 6 if impl == "pallas_fused" or not resident else 4
    kernel = {"pallas": "fused_window_attention",
              "pallas_fused": "spatial_window_attention"}.get(impl)
    assert calls.count("_spatial_call") == spatial
    assert calls.count("fused_window_attention") == (6 if kernel == "fused_window_attention"
                                                     else 0)
    assert calls.count("spatial_window_attention") == (6 if kernel == "spatial_window_attention"
                                                       else 0)


@pytest.mark.parametrize("route", ["v6", "v7"])
def test_long_attn_backbone_matches_jax(route, jx, monkeypatch):
    """One stage (C=64, 2 heads) at token dims (16, 14, 14), the 8x7x7
    window (N=392), an unshifted and a shifted block, on the flat route:
    the port's long_attn against the JAX flat attention with
    CLOVER_WA_LONG=route, its all-heads and head-group blocks refused at
    N=392 (where the TPU's VMEM refuses them), the fused half-block off and
    the shift mask in its additive form (the long kernels take no lanes)."""
    wa, swin = jx.wa, jx.swin
    jcalls, pcalls = [], []
    monkeypatch.setattr(swin, "_FUSED_ATTN_MODE", "0")
    monkeypatch.setattr(wa, "_LONG_IMPL", route)
    monkeypatch.setattr(wa, "_MASK_LANES", False)
    monkeypatch.setattr(wa, "_pick_window_block_flat", lambda *a, **k: 0)
    monkeypatch.setattr(wa, "_forward_flat_grouped", lambda *a, **k: None)
    jname = "_forward_long_from_flat" if route == "v6" else "_forward_flat_flash"
    _counting(monkeypatch, wa, jname, jcalls)
    pname = "long_window_attention_from_flat" if route == "v6" else "flat_flash_window_attention"
    _counting(monkeypatch, pwa, pname, pcalls)
    ref, got, _ = _backbones(jx, _clips(32, 56), attention_impl="pallas_flat", embed_dim=64,
                             depths=(2,), num_heads=(2,), fold_normalize=True,
                             drop_path_rate=0.0, port_only=dict(fused_attn="off",
                                                                long_attn=route))
    np.testing.assert_allclose(got, ref, **TOL)
    assert jcalls and len(pcalls) == 2     # JAX traces the forward in init and in apply
