"""The port's serving bundles (``clover_tpu_torch/serving.py``,
``clover_tpu_torch/tools/export.py``) held against the JAX package's
(``clover_tpu/serving.py``) on the CPU, as ``tests/test_serving.py`` holds
the JAX bundle against its model.

One tiny retrieval configuration (Swin with the raw-clip 'conv' embed, embed
dim 32, depths 2/2; a 1-layer BERT of width 32), one seeded JAX parameter
tree through the bridge, the same seeded uint8 frames and token ids:

- the port bundle's loaded towers against the JAX bundle's (1e-4 absolute
  and relative: fp32 summation order over 4 Swin blocks and a BERT layer);
  ``similarity`` against the JAX ``similarity_fn`` (1e-6);
- the manifest: names, fields, the text artifact smaller than the video one;
- ``bake_params=False`` (the weights and the bias cache as inputs) and a
  bare JAX parameter tree give the baked bundle's embeddings;
- the bundle loaded and run in a process that imports no model module;
- ``host_s2d`` swapped for 's2d' at export;
- the export entry on ``configs/exp/debug_retrieval_synthetic.py --cpu``;
- each route's exported video graph: its ``clover::*`` ops at the counts
  reckoned from the config (K1; K6 under 'fused_block' and at N >= 384; K9
  under 'pallas'; K10 under 'pallas_fused'; K11 under ``long_attn``), the
  cached bias layouts as graph inputs, no ``aten`` softmax.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clover_tpu.models import BertConfig as JBertConfig
from clover_tpu.models import CloverFinetune as JCloverFinetune
from clover_tpu.models import FinetuneConfig as JFinetuneConfig
from clover_tpu.models import SwinConfig as JSwinConfig
from clover_tpu.serving import export_retrieval_towers as jexport
from clover_tpu.serving import load_bundle as jload_bundle
from clover_tpu.serving import save_bundle as jsave_bundle
from clover_tpu.serving import similarity_fn as jsimilarity_fn
from clover_tpu_torch import serving
from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig, SwinConfig,
                                     init_params, load_jax_params)
from clover_tpu_torch.ops.preprocess import space_to_depth_host
from clover_tpu_torch.tools import export as export_entry
from test_torch_bridge import random_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), drop_path_rate=0.0)
BERT = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=1, intermediate_size=64,
            vocab_size=120, max_position_embeddings=40, hidden_dropout=0.0,
            attention_dropout=0.0)
B, T, S, L, CAND = 2, 4, 56, 8, 5
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed=0, frames=T, size=S):
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (B, frames, size, size, 3), dtype=np.uint8)
    ids = rng.integers(1, 120, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 5:] = 0
    return clips, ids, mask


def _port_model(**swin):
    cfg = FinetuneConfig(swin=SwinConfig(**{**dict(embed_impl="conv"), **SWIN, **swin}),
                         text_bert=BertConfig(**BERT), task="retrieval", vts_embed_dim=8)
    return CloverFinetune(cfg, device="cpu").eval()


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _int64(ids, mask):
    return torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask.astype(np.int64))


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    jcfg = JFinetuneConfig(swin=JSwinConfig(embed_impl="conv", **SWIN),
                           text_bert=JBertConfig(**BERT), task="retrieval", vts_embed_dim=8)
    jm = JCloverFinetune(jcfg, dtype=jnp.float32)
    clips, ids, mask = _inputs()
    imgs = clips[:, None].astype(np.float32)
    params = random_jax_params(jm, imgs, ids, mask)
    jout = str(tmp_path_factory.mktemp("jax_bundle"))
    jsave_bundle(jexport(jm, params, batch_sizes=(B,), frames=T, image_size=S, text_len=L,
                         sim_candidates=CAND), jout)
    pm = _port_model()
    load_jax_params(pm, params)
    exports = serving.export_retrieval_towers(pm, batch_sizes=(B,), frames=T, image_size=S,
                                              text_len=L, sim_candidates=CAND)
    pout = str(tmp_path_factory.mktemp("port_bundle"))
    serving.save_bundle(exports, pout)
    return dict(params=params, pm=pm, jax=jload_bundle(jout), port=serving.load_bundle(pout),
                port_dir=pout, exports=exports)


def test_bundle_files_and_manifest(bundles):
    out = bundles["port_dir"]
    names = {f"video_tower_b{B}", f"text_tower_b{B}", "similarity"}
    assert set(os.listdir(out)) == {n + ".pt2" for n in names} | {"manifest.json"}
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest) == names
    for name, meta in manifest.items():
        assert set(meta) == {"inputs", "outputs", "device", "nbytes", "baked_bytes"}
        assert meta["device"] == "cpu" and meta["nbytes"] == os.path.getsize(
            os.path.join(out, name + ".pt2"))
    video, text = manifest[f"video_tower_b{B}"], manifest[f"text_tower_b{B}"]
    assert video["inputs"] == [{"shape": [B, T, S, S, 3], "dtype": "uint8"}]
    assert text["inputs"] == [{"shape": [B, L], "dtype": "int64"}] * 2
    assert video["outputs"] == text["outputs"] == [{"shape": [B, 8], "dtype": "float32"}]
    assert manifest["similarity"]["baked_bytes"] == 0
    # the text artifact carries no Swin weight
    assert 0 < text["baked_bytes"] < video["baked_bytes"]
    assert text["nbytes"] < video["nbytes"]


def test_loaded_towers_match_the_jax_bundle(bundles):
    clips, ids, mask = _inputs(seed=1)
    want_v = np.asarray(bundles["jax"][f"video_tower_b{B}"](jnp.asarray(clips)))
    want_t = np.asarray(bundles["jax"][f"text_tower_b{B}"](jnp.asarray(ids), jnp.asarray(mask)))
    got_v = bundles["port"][f"video_tower_b{B}"](*_t(clips))
    got_t = bundles["port"][f"text_tower_b{B}"](*_int64(ids, mask))
    assert got_v.dtype == got_t.dtype == torch.float32
    np.testing.assert_allclose(got_v.numpy(), want_v, **TOL)
    np.testing.assert_allclose(got_t.numpy(), want_t, **TOL)


def test_similarity_matches_jax(bundles):
    rng = np.random.default_rng(2)
    t5, v5 = (rng.normal(size=(CAND, 8)).astype(np.float32) for _ in range(2))
    want = np.asarray(jsimilarity_fn(jnp.asarray(t5), jnp.asarray(v5)))
    np.testing.assert_allclose(bundles["port"]["similarity"](*_t(t5, v5)).numpy(), want,
                               atol=1e-6)
    np.testing.assert_allclose(serving.similarity_fn(*_t(t5, v5)).numpy(), want, atol=1e-6)


def test_weights_as_inputs_give_the_baked_embeddings(bundles, tmp_path):
    """bake_params=False: the video artifact takes (params, bias cache,
    frames), the text one (params, ids, mask), each tower's parameters by
    the model's names; the weights are not in the files."""
    pm = bundles["pm"]
    out = serving.save_bundle(serving.export_retrieval_towers(
        pm, batch_sizes=(B,), frames=T, image_size=S, text_len=L, sim_candidates=CAND,
        bake_params=False), str(tmp_path / "weights_in"))
    fns = serving.load_bundle(out)
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    params = dict(pm.named_parameters())
    video_params = {k: v for k, v in params.items()
                    if k.startswith(("backbone.", "ssl_head.img_"))}
    text_params = {k: v for k, v in params.items()
                   if k.startswith(("text_backbone.", "ssl_head.text_"))}
    assert manifest[f"text_tower_b{B}"]["baked_bytes"] == 0
    assert len(manifest[f"text_tower_b{B}"]["inputs"]) == len(text_params) + 2
    from clover_tpu_torch.models.swin3d import embed_dims, swin_bias_cache

    cache = swin_bias_cache(pm.backbone, pm.config.swin, embed_dims(pm.config.swin, (T, S, S)))
    clips, ids, mask = _inputs(seed=3)
    with torch.no_grad():
        got_v = fns[f"video_tower_b{B}"](video_params, cache, *_t(clips))
        got_t = fns[f"text_tower_b{B}"](text_params, *_int64(ids, mask))
    assert torch.equal(got_v, bundles["port"][f"video_tower_b{B}"](*_t(clips)))
    assert torch.equal(got_t, bundles["port"][f"text_tower_b{B}"](*_int64(ids, mask)))


@pytest.mark.parametrize("wrapped", [False, True])
def test_export_takes_a_bare_jax_parameter_tree(bundles, wrapped):
    """A fresh model exported with the JAX tree (bare, or under 'params')
    gives the bundle of the model that holds those weights, bitwise; the
    fresh model keeps its own weights."""
    fresh = _port_model()
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    tree = bundles["params"] if wrapped else bundles["params"]["params"]
    exports = serving.export_retrieval_towers(fresh, tree, batch_sizes=(B,), frames=T,
                                              image_size=S, text_len=L, sim_candidates=CAND)
    clips, ids, mask = _inputs(seed=4)
    with torch.no_grad():
        got = exports[f"video_tower_b{B}"].module()(*_t(clips))
        got_t = exports[f"text_tower_b{B}"].module()(*_int64(ids, mask))
    assert torch.equal(got, bundles["port"][f"video_tower_b{B}"](*_t(clips)))
    assert torch.equal(got_t, bundles["port"][f"text_tower_b{B}"](*_int64(ids, mask)))
    assert all(torch.equal(before[k], v) for k, v in fresh.state_dict().items())


def test_loaded_bundle_runs_without_the_model_modules(bundles, tmp_path):
    clips, ids, mask = _inputs(seed=5)
    np.savez(tmp_path / "inputs.npz", clips=clips, ids=ids.astype(np.int64),
             mask=mask.astype(np.int64))
    code = textwrap.dedent(f"""
        import sys
        import numpy as np, torch
        from clover_tpu_torch.serving import load_bundle
        fns = load_bundle({bundles["port_dir"]!r})
        a = np.load({str(tmp_path / "inputs.npz")!r})
        v = fns["video_tower_b{B}"](torch.from_numpy(a["clips"]))
        t = fns["text_tower_b{B}"](torch.from_numpy(a["ids"]), torch.from_numpy(a["mask"]))
        np.savez({str(tmp_path / "out.npz")!r}, v=v.numpy(), t=t.numpy())
        print("MODELS", sorted(m for m in sys.modules if m.startswith("clover_tpu_torch.models")))
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MODELS []" in proc.stdout, proc.stdout
    out = np.load(tmp_path / "out.npz")
    assert np.array_equal(out["v"], bundles["port"][f"video_tower_b{B}"](*_t(clips)).numpy())
    assert np.array_equal(out["t"], bundles["port"][f"text_tower_b{B}"](
        *_int64(ids, mask)).numpy())


def test_host_s2d_is_exported_as_s2d():
    """A host_s2d model (fold_normalize) exports the on-device s2d embed with
    the same weights: the artifact on frames equals the model on the host's
    space-to-depth clips; the model keeps its config."""
    pm = _port_model(embed_impl="host_s2d", fold_normalize=True)
    init_params(pm, torch.Generator().manual_seed(0))
    exports = serving.export_retrieval_towers(pm, batch_sizes=(B,), frames=T, image_size=S,
                                              text_len=L, sim_candidates=CAND)
    clips, _, _ = _inputs(seed=6)
    with torch.inference_mode():
        want = pm.forward_video(torch.from_numpy(
            space_to_depth_host(clips).astype(np.float32))[:, None])
    with torch.no_grad():
        got = exports[f"video_tower_b{B}"].module()(*_t(clips))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    assert pm.config.swin.embed_impl == "host_s2d"


def test_export_entry_on_the_debug_config(tmp_path):
    out, manifest = export_entry.main([
        os.path.join(REPO, "configs", "exp", "debug_retrieval_synthetic.py"),
        "--out", str(tmp_path / "bundle"), "--batch-sizes", "1", "--frames", "2",
        "--text-len", "8", "--sim-candidates", "4", "--cpu"])
    assert set(manifest) == {"video_tower_b1", "text_tower_b1", "similarity"}
    fns = serving.load_bundle(out)
    clips = torch.zeros((1, 2, 32, 32, 3), dtype=torch.uint8)
    v = fns["video_tower_b1"](clips)
    t = fns["text_tower_b1"](torch.ones((1, 8), dtype=torch.int64),
                             torch.ones((1, 8), dtype=torch.int64))
    assert v.shape == t.shape == (1, 16) and torch.isfinite(v).all() and torch.isfinite(t).all()


def test_export_entry_reads_the_test_split_frames():
    from clover_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "exp", "finetune_msrvtt_retrieval.py"))
    assert export_entry.split_frames(cfg) == 32
    debug = load_config(os.path.join(REPO, "configs", "exp", "debug_retrieval_synthetic.py"))
    assert export_entry.split_frames(debug) == 4


# each route's video graph: SwinConfig fields, frames, size, the reckoned ops.
# T=4 at 56^2: token dims (2, 14, 14), then (2, 7, 7): N=98 in both stages; K4
# the patch norm, 4 norm1, the downsample's and the final norm. T=16 at 28^2:
# (8, 7, 7), N=392 in stage 0, then (8, 4, 4), N=128
ROUTES = {
    "K1": ({}, T, S, {"k1_window_attention": 4, "k2_ln_mlp_residual": 4, "k4_layer_norm": 7}),
    "K6 fused_block": (dict(attention_impl="fused_block"), T, S,
                       {"k6_window_attn_block": 4, "k2_ln_mlp_residual": 4, "k4_layer_norm": 3}),
    "K6 at N=392": ({}, 16, 28, {"k6_window_attn_block": 2, "k1_window_attention": 2,
                                 "k2_ln_mlp_residual": 4, "k4_layer_norm": 5}),
    "K9 pallas": (dict(attention_impl="pallas"), T, S,
                  {"k9_window_attention_heads": 4, "k2_ln_mlp_residual": 4, "k4_layer_norm": 7}),
    "K10 pallas_fused": (dict(attention_impl="pallas_fused"), T, S,
                         {"k10_window_attention_grid": 4, "k2_ln_mlp_residual": 4,
                          "k4_layer_norm": 7}),
    "K11 v7": (dict(fused_attn="off", long_attn="v7"), 16, 28,
               {"k11_flash_attention_flat": 2, "k1_window_attention": 2,
                "k2_ln_mlp_residual": 4, "k4_layer_norm": 7}),
    "K11 v6": (dict(fused_attn="off", long_attn="v6"), 16, 28,
               {"k11_flash_attention_heads": 2, "k1_window_attention": 2,
                "k2_ln_mlp_residual": 4, "k4_layer_norm": 7}),
}
TERMS_ARG = {"k1_window_attention": 6, "k9_window_attention_heads": 6,
             "k10_window_attention_grid": 5}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_video_graph_holds_the_reckoned_ops(route):
    fields, frames, size, want = ROUTES[route]
    pm = _port_model(**fields)
    init_params(pm, torch.Generator().manual_seed(0))
    exports = serving.export_retrieval_towers(pm, batch_sizes=(1,), frames=frames,
                                              image_size=size, text_len=L, sim_candidates=2)
    ep = exports["video_tower_b1"]
    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    got = {}
    for n in calls:
        name = str(n.target)
        if name.startswith("clover."):
            got[name.split(".")[1]] = got.get(name.split(".")[1], 0) + 1
            # the cached bias layout is a graph input (a buffer), not laid out in the graph
            if name.split(".")[1] in TERMS_ARG:
                terms = n.args[TERMS_ARG[name.split(".")[1]]]
                assert terms is not None and terms.op == "placeholder", (name, terms)
    assert got == want
    assert not any("softmax" in str(n.target) for n in calls)
    clips = _inputs(seed=7, frames=frames, size=size)[0][:1]
    cfg = dataclasses.replace(pm.config.swin)
    assert cfg.embed_impl == "conv"
    from clover_tpu_torch.models.swin3d import embed_dims, swin_bias_cache
    from clover_tpu_torch.ops.preprocess import eval_preprocess

    cache = swin_bias_cache(pm.backbone, cfg, embed_dims(cfg, (frames, size, size)))
    with torch.inference_mode():
        want_v = pm.forward_video(eval_preprocess(*_t(clips), size, torch.float32)[:, None],
                                  cache)
    with torch.no_grad():
        got = ep.module()(*_t(clips))
    np.testing.assert_allclose(got.numpy(), want_v.numpy(), atol=1e-5, rtol=1e-5)

