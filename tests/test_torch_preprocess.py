"""The port's input ops (``clover_tpu_torch/ops/preprocess.py``) held against
the JAX package's ``clover_tpu/ops/preprocess.py`` on the CPU.

- the numpy parameter draws: bitwise, over many seeds, the crop fallback
  included;
- ``preprocess_clips`` against the jitted JAX one over fractional,
  edge-touching, up- and down-scaling boxes, with flips and both
  ``normalize`` settings: fp32 within 1e-4 of the output's scale (max of 1
  and max|JAX|; observed 1.9e-5 normalized and 1.1e-3 at pixel scale, where
  the JAX side's own CPU sum is 4.3e-4 from a float64 reference and the
  port's 2.4e-5), bf16 within one bf16 ulp of each value (or the fp32
  limit, for values within fp32 noise of 0);
- ``eval_preprocess`` (both branches), ``three_crop_preprocess`` and the
  colour jitter likewise;
- ``canonical_host_resize`` (torch's bilinear resize) against the JAX one
  (OpenCV's ``INTER_LINEAR``, fixed-point weights): within one uint8 level;
- ``to_model_batch`` against ``tools/train.py``'s recipe on the JAX side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clover_tpu.ops import preprocess as jpp
from clover_tpu_torch.engine import to_model_batch
from clover_tpu_torch.ops import preprocess as ppp

S = 40
FRAMES = np.random.default_rng(0).integers(0, 256, (5, 2, S, S, 3), dtype=np.uint8)
# (y0, x0, h, w): fractional, the whole frame, edge-touching (bottom right),
# up-scaling from a small box, and a box reaching past the frame's edge
BOXES = np.asarray([[3.5, 2.25, 20.5, 17.0], [0, 0, S, S], [12, 30, 28, 10],
                    [5.75, 7.5, 6.25, 9.5], [30.5, -2.0, 15.0, 44.0]], np.float32)
FLIPS = np.asarray([True, False, True, False, True])


def _close_fp32(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def _within_one_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp at the larger magnitude of the two, or the
    fp32 limit where that is larger (values within fp32 noise of 0, e.g. a
    port 0 against a JAX 4.5e-4 at pixel scale)."""
    big = np.maximum(np.abs(got), np.abs(want)).astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    limit = np.maximum(ulp, 1e-4 * max(1.0, float(np.abs(want).max())))
    assert (np.abs(got.astype(np.float64) - want) <= limit).all(), float(
        (np.abs(got - want) / limit).max())


@pytest.mark.parametrize("seed", range(40))
def test_parameter_draws_are_bitwise_the_jax_ones(seed):
    """random_resized_crop_params (tiny sizes force the fallback, wide area
    ranges the rejections), center_crop_params and color_jitter_params: the
    same values from the same rng state, and the rng left in the same
    state."""
    for fn_args in ((32,), (3, (0.9, 1.0), (0.2, 5.0)), (224,), (7, (0.5, 1.0))):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(5):
            np.testing.assert_array_equal(ppp.random_resized_crop_params(a, *fn_args),
                                          jpp.random_resized_crop_params(b, *fn_args))
        assert a.bit_generator.state == b.bit_generator.state
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(ppp.color_jitter_params(a), jpp.color_jitter_params(b))
    np.testing.assert_array_equal(ppp.center_crop_params(256 + seed, 224),
                                  jpp.center_crop_params(256 + seed, 224))


def test_the_crop_fallback_is_reached():
    """A 3-pixel frame with a near-1 area and extreme aspects rejects all ten
    draws: both give the whole frame."""
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    got = ppp.random_resized_crop_params(a, 3, (0.99, 1.0), (8.0, 9.0))
    np.testing.assert_array_equal(got, [0, 0, 3, 3])
    np.testing.assert_array_equal(got, jpp.random_resized_crop_params(b, 3, (0.99, 1.0),
                                                                      (8.0, 9.0)))


@pytest.mark.parametrize("out_size", [24, 56])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocess_clips_matches_jax(out_size, normalize, dtype):
    want = np.asarray(jpp.preprocess_clips(
        jnp.asarray(FRAMES), jnp.asarray(BOXES), jnp.asarray(FLIPS), out_size=out_size,
        dtype=getattr(jnp, dtype), normalize=normalize).astype(jnp.float32))
    got = ppp.preprocess_clips(torch.from_numpy(FRAMES), BOXES, FLIPS, out_size,
                               getattr(torch, dtype), normalize)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    (_close_fp32 if dtype == "float32" else _within_one_bf16_ulp)(got.float().numpy(), want)


def test_an_integer_crop_is_exact():
    """A box of the output's size at integer offsets is a copy of the pixels."""
    box = np.asarray([[4, 7, 24, 24]], np.float32)
    got = ppp.preprocess_clips(torch.from_numpy(FRAMES[:1]), box, [False], 24, torch.float32,
                               normalize=False)
    np.testing.assert_array_equal(got.numpy(), FRAMES[:1, :, 4:28, 7:31].astype(np.float32))


@pytest.mark.parametrize("size,out_size", [(24, 24), (S, 24), (S, 56)])
@pytest.mark.parametrize("normalize", [True, False])
def test_eval_preprocess_matches_jax(size, out_size, normalize):
    """Both branches: the identity crop (size == out_size: the normalize and
    the cast only) and the centre crop."""
    frames = FRAMES[:, :, :size, :size]
    want = np.asarray(jpp.eval_preprocess(jnp.asarray(frames), out_size, jnp.float32,
                                          normalize))
    got = ppp.eval_preprocess(torch.from_numpy(np.ascontiguousarray(frames)), out_size,
                              torch.float32, normalize)
    _close_fp32(got.numpy(), want)


def test_three_crop_preprocess_matches_jax():
    want = np.asarray(jpp.three_crop_preprocess(jnp.asarray(FRAMES[:2]), 24, jnp.float32))
    got = ppp.three_crop_preprocess(torch.from_numpy(FRAMES[:2]), 24, torch.float32)
    assert got.shape == (6, 2, 24, 24, 3)
    _close_fp32(got.numpy(), want)


def test_color_jitter_matches_jax():
    rng = np.random.default_rng(3)
    frames = FRAMES.astype(np.float32)
    factors = np.stack([ppp.color_jitter_params(rng) for _ in range(len(frames))])
    want = np.asarray(jpp.apply_color_jitter(jnp.asarray(frames), jnp.asarray(factors)))
    got = ppp.apply_color_jitter(torch.from_numpy(frames), torch.from_numpy(factors))
    _close_fp32(got.numpy(), want)


@pytest.mark.parametrize("shape,canonical", [((3, 120, 200), 64), ((2, 300, 170), 224),
                                             ((2, 50, 50), 64), ((2, 64, 90), 64)])
def test_canonical_host_resize_within_one_level_of_opencv(shape, canonical):
    """Short side to ``canonical``, centre square; up- and down-scaling, and
    a frame already at the short side. OpenCV rounds its weights in fixed
    point: at most one uint8 level apart (observed: 1, on ~13% of pixels)."""
    frames = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    want = jpp.canonical_host_resize(frames, canonical)
    got = ppp.canonical_host_resize(frames, canonical)
    assert got.shape == want.shape == (shape[0], canonical, canonical, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want).max() <= 1


def test_canonical_host_resize_keeps_its_no_op_and_refusal():
    sq = FRAMES[0, :, :32, :32]
    assert ppp.canonical_host_resize(sq, 32) is sq
    with pytest.raises(ValueError, match="space-to-depth"):
        ppp.canonical_host_resize(np.zeros((2, 8, 8, 96), np.uint8), 8)


def test_to_model_batch_matches_the_jax_recipe():
    """tools/train.py's to_model_batch: clips flattened over the candidates,
    preprocess_clips with the loader's boxes and flips, reshaped back; the
    text and label keys carried (the crop boxes and flips not)."""
    rng = np.random.default_rng(7)
    host = {"imgs": FRAMES[:4].reshape(2, 2, 2, S, S, 3),
            "crop_boxes": np.stack([jpp.random_resized_crop_params(rng, S) for _ in range(4)]),
            "flip": np.asarray([True, False, False, True]),
            "token_ids": rng.integers(1000, 2000, (2, 8)), "input_mask": np.ones((2, 8)),
            "mlm_label": rng.integers(0, 5, (2, 8))}
    imgs = jpp.preprocess_clips(jnp.asarray(host["imgs"].reshape(4, 2, S, S, 3)),
                                jnp.asarray(host["crop_boxes"]), jnp.asarray(host["flip"]),
                                out_size=24, dtype=jnp.float32)
    got = to_model_batch(host, 24, torch.float32, "cpu")
    assert set(got) == {"imgs", "token_ids", "input_mask", "mlm_label"}
    assert got["imgs"].shape == (2, 2, 2, 24, 24, 3)
    _close_fp32(got["imgs"].numpy(), np.asarray(imgs).reshape(2, 2, 2, 24, 24, 3))
    np.testing.assert_array_equal(got["mlm_label"].numpy(), host["mlm_label"])
