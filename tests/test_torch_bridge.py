"""The weight bridge: the JAX CloverFinetune tree -> clover_tpu_torch's state.

Also home of the tiny slice configuration shared with test_torch_slice.py:
Swin with embed dim 64 (head dim 32, window-resident stages, shifted
blocks, a stage that pads in PatchMerging) and a 2-layer BERT of width 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clover_tpu.models import BertConfig as JBertConfig
from clover_tpu.models import CloverFinetune as JCloverFinetune
from clover_tpu.models import FinetuneConfig as JFinetuneConfig
from clover_tpu.models import SwinConfig as JSwinConfig
from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig, SwinConfig,
                                     load_jax_params, state_from_jax)
from clover_tpu_torch.ops.preprocess import space_to_depth_host

SWIN = dict(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), fold_normalize=True)
BERT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256)
B, T, S, L = 2, 4, 112, 8


def tiny_models():
    """(JAX model, port model) of the same tiny retrieval configuration."""
    jcfg = JFinetuneConfig(swin=JSwinConfig(embed_impl="host_s2d", **SWIN),
                           text_bert=JBertConfig(**BERT), task="retrieval")
    pcfg = FinetuneConfig(swin=SwinConfig(**SWIN), text_bert=BertConfig(**BERT))
    return JCloverFinetune(jcfg, dtype=jnp.float32), CloverFinetune(pcfg, device="cpu")


def tiny_inputs(seed=0):
    """Host-s2d uint8 clips (B, 1, T/2, S/4, S/4, 96), token ids, mask."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(B, T, S, S, 3), dtype=np.uint8)
    tok = rng.integers(1000, 30522, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 5:] = 0
    return space_to_depth_host(frames)[:, None], tok, mask


def random_jax_params(model, imgs, tok, mask, seed=0):
    """The model's parameter tree (from jax.eval_shape, no init compile)
    filled with seeded values; biases and LN affines are non-trivial so the
    bridge's mapping of every leaf shows in the outputs."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(imgs),
                                               jnp.asarray(tok), jnp.asarray(mask),
                                               method="forward_test"))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.normal(size=shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name == "kernel":
            z = z / np.sqrt(shape[0])
        else:
            z = (0.5 if name in ("embedding", "relative_position_bias_table") else 0.1) * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def tree():
    jm, pm = tiny_models()
    return random_jax_params(jm, *tiny_inputs()), pm


def _leaves(t, prefix=()):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_bridge_consumes_every_leaf_once_and_sets_every_parameter(tree):
    params, pm = tree
    leaves = list(_leaves(params["params"]))
    state = state_from_jax(params)
    assert len(state) == len(leaves)                      # no two leaves merge
    assert set(state) == {n for n, _ in pm.named_parameters()}
    for p in pm.parameters():
        p.data.fill_(float("nan"))
    load_jax_params(pm, params)
    assert all(bool(torch.isfinite(p).all()) for p in pm.parameters())


def test_bridge_leaf_rules(tree):
    params, pm = tree
    p = params["params"]
    load_jax_params(pm, params)
    blk = p["backbone"]["stage_0_block_1"]
    port_blk = pm.backbone.stage_0_block_1
    np.testing.assert_array_equal(port_blk.mlp.fc1.weight.detach().numpy(),
                                  blk["mlp"]["fc1"]["kernel"].T)          # Dense -> (out, in)
    np.testing.assert_array_equal(port_blk.norm1.weight.detach().numpy(),
                                  blk["norm1"]["scale"])                  # scale -> weight
    np.testing.assert_array_equal(port_blk.attn.relative_position_bias_table.detach().numpy(),
                                  blk["attn"]["relative_position_bias_table"])
    np.testing.assert_array_equal(pm.backbone.patch_embed.proj["weight"].detach().numpy(),
                                  p["backbone"]["patch_embed"]["proj"]["kernel"])  # kept layout
    np.testing.assert_array_equal(
        pm.text_backbone.embeddings.word_embeddings.weight.detach().numpy(),
        p["text_backbone"]["embeddings"]["word_embeddings"]["embedding"])
    np.testing.assert_array_equal(pm.ssl_head.img_norm1.norm.bias.detach().numpy(),
                                  p["ssl_head"]["img_norm1"]["norm"]["bias"])


def test_bridge_rejects_a_tree_that_does_not_fit(tree):
    params, pm = tree
    bad = jax.tree_util.tree_map(lambda a: a, params)
    del bad["params"]["ssl_head"]["text_fc2"]
    with pytest.raises(KeyError):
        load_jax_params(pm, bad)
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["params"]["ssl_head"]["text_fc2"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        load_jax_params(pm, bad)
