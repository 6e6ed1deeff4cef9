"""The port's retrieval-eval slice held against the JAX package on the CPU.

One tiny configuration (test_torch_bridge.tiny_models), one set of seeded
weights through the bridge, the same seeded uint8 clips and token ids:
``forward_test``, ``forward_video`` and ``forward_text`` of the port against
the JAX ``CloverFinetune`` run under ``jax.jit`` once per module, in fp32.
Tolerance 1e-4 (absolute and relative) on embeddings of magnitude ~1: fp32
summation-order differences over 8 Swin blocks and 2 BERT layers (the
observed gap is ~4e-6).
"""

import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clover_tpu.engine.eval_loop import run_retrieval_eval as jax_run_retrieval_eval
from clover_tpu.evaluation.metrics import retrieval_recall
from clover_tpu_torch.engine import make_embed_eval_step, run_retrieval_eval
from clover_tpu_torch.models import load_jax_params, swin_bias_cache
from test_torch_bridge import random_jax_params, tiny_inputs, tiny_models

TOL = dict(atol=1e-4, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def slice_run():
    jm, pm = tiny_models()
    imgs, tok, mask = tiny_inputs()
    params = random_jax_params(jm, imgs, tok, mask)
    ji, jt, jmask = jnp.asarray(imgs), jnp.asarray(tok), jnp.asarray(mask)

    def run(method, *args):
        return jax.jit(lambda p, *a: jm.apply(p, *a, method=method))(params, *args)

    ref = {"test": run("forward_test", ji, jt, jmask),
           "video": run("forward_video", ji),
           "text": run("forward_text", jt, jmask)}
    ref = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), ref)
    load_jax_params(pm, params)
    pm.eval()
    inputs = tuple(torch.from_numpy(a) for a in (imgs, tok, mask))
    return pm, inputs, ref


@pytest.mark.parametrize("cached_bias", [False, True])
def test_forward_test_matches_jax(slice_run, cached_bias):
    pm, (imgs, tok, mask), ref = slice_run
    cache = swin_bias_cache(pm.backbone, pm.config.swin, imgs.shape[2:5]) if cached_bias else None
    with torch.inference_mode():
        v, t = pm.forward_test(imgs, tok, mask, cache)
    np.testing.assert_allclose(v.numpy(), ref["test"][0], **TOL)
    np.testing.assert_allclose(t.numpy(), ref["test"][1], **TOL)


def test_forward_video_matches_jax(slice_run):
    pm, (imgs, _, _), ref = slice_run
    with torch.inference_mode():
        v = pm.forward_video(imgs)
    np.testing.assert_allclose(v.numpy(), ref["video"], **TOL)


def test_forward_text_matches_jax(slice_run):
    pm, (_, tok, mask), ref = slice_run
    with torch.inference_mode():
        t = pm.forward_text(tok, mask)
    np.testing.assert_allclose(t.numpy(), ref["text"], **TOL)


def test_eval_step_through_the_retrieval_loop_matches_jax_metrics(slice_run):
    """make_embed_eval_step + run_retrieval_eval on the port, fed the two
    halves of the batch as two loader batches, gives the R@K that the
    metrics give on the JAX embeddings."""
    pm, (imgs, tok, mask), ref = slice_run
    batches = [{"imgs": imgs[i:i + 1].numpy(), "token_ids": tok[i:i + 1].numpy(),
                "input_mask": mask[i:i + 1].numpy(), "index": np.array([i]),
                "video_index": np.array([i])} for i in (1, 0)]
    dataset = types.SimpleNamespace(text_video_ids=[[0], [1]])
    got = run_retrieval_eval(make_embed_eval_step(pm), pm, dataset, iter(batches),
                             bias_cache=lambda m, dims: swin_bias_cache(m.backbone,
                                                                        m.config.swin, dims))
    assert got == retrieval_recall(video_embd=ref["test"][0], text_embd=ref["test"][1])


@pytest.mark.parametrize("captions", ["one_per_video", "varied"])
def test_retrieval_loop_matches_the_jax_loop(captions):
    """Same embeddings and batches (with a sampler-padding duplicate) through
    both loops: identical R@K."""
    rng = np.random.default_rng(11)
    n_entries = 6
    video_index = (np.arange(n_entries) if captions == "one_per_video"
                   else np.array([0, 0, 1, 2, 2, 2]))
    text_video_ids = [[int(i) for i in np.flatnonzero(video_index == v)]
                      for v in range(video_index.max() + 1)]
    emb_v = rng.normal(size=(n_entries + 1, 8)).astype(np.float32)
    emb_t = rng.normal(size=(n_entries + 1, 8)).astype(np.float32)
    order = np.array([3, 0, 5, 1, 4, 2, 0])          # entry 0 twice: sampler padding
    batches = [{"imgs": np.zeros((2, 1, 1, 1, 1, 96), np.uint8),
                "token_ids": np.zeros((2, 4), np.int32), "input_mask": np.ones((2, 4), np.int32),
                "index": order[i:i + 2], "video_index": video_index[order[i:i + 2]],
                "rows": slice(i, i + 2)} for i in range(0, 6, 2)]
    batches.append(dict(batches[-1], index=order[6:], video_index=video_index[order[6:]],
                        rows=slice(6, 7), imgs=np.zeros((1, 1, 1, 1, 1, 96), np.uint8)))
    dataset = types.SimpleNamespace(text_video_ids=text_video_ids)
    emb_v[6], emb_t[6] = emb_v[1], emb_t[1]          # the duplicate carries entry 0's values

    def embeddings():
        for b in batches:
            yield emb_v[b["rows"]], emb_t[b["rows"]]

    jax_embs = embeddings()
    want = jax_run_retrieval_eval(lambda *a: next(jax_embs), None, dataset, iter(batches))
    port_embs = embeddings()
    model = torch.nn.Linear(1, 1)                    # supplies the device only
    got = run_retrieval_eval(
        lambda *a: tuple(map(torch.from_numpy, next(port_embs))), model, dataset,
        iter(batches))
    assert got == want


# printed by a subprocess: the modules of JAX and of the JAX package it loaded
_FOREIGN_MODULES = """
foreign = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "clover_tpu" or m.startswith("clover_tpu."))
print("FOREIGN_MODULES", foreign)
"""


def _run_isolated(code):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code + _FOREIGN_MODULES], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FOREIGN_MODULES []" in proc.stdout, proc.stdout


def test_port_imports_no_jax():
    """Importing clover_tpu_torch and running the tiny slice through the eval
    loop, then converting seeded published-schema checkpoints
    (``tools/convert_checkpoint.py``) and exporting, saving and loading the
    serving bundle (``serving.py``, the ``clover::*`` ops), and the
    data-parallel modules (``parallel/``) in a one-rank gloo group, leaves
    jax, and every module of the JAX package (clover_tpu and clover_tpu.*),
    out of sys.modules."""
    code = textwrap.dedent("""
        import sys, types
        import numpy as np, torch
        from clover_tpu_torch.engine import make_embed_eval_step, run_retrieval_eval
        from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig,
                                             SwinConfig, init_params, swin_bias_cache)
        from clover_tpu_torch.ops.preprocess import space_to_depth_host
        cfg = FinetuneConfig(
            swin=SwinConfig(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16),
                            fold_normalize=True),
            text_bert=BertConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                                 intermediate_size=256))
        model = CloverFinetune(cfg, device="cpu").eval()
        init_params(model, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        batches = [{"imgs": space_to_depth_host(
                        rng.integers(0, 256, (2, 4, 112, 112, 3), dtype=np.uint8))[:, None],
                    "token_ids": rng.integers(1000, 30522, (2, 8)),
                    "input_mask": np.ones((2, 8), np.int64),
                    "index": np.arange(2) + 2 * i, "video_index": np.arange(2) + 2 * i}
                   for i in range(2)]
        metrics = run_retrieval_eval(
            make_embed_eval_step(model), model,
            types.SimpleNamespace(text_video_ids=[[i] for i in range(4)]), iter(batches),
            bias_cache=lambda m, dims: swin_bias_cache(m.backbone, cfg.swin, dims))
        assert np.isfinite(metrics["Recall@1"]), metrics
        import tempfile
        from clover_tpu_torch.serving import export_retrieval_towers, load_bundle, save_bundle
        from clover_tpu_torch.tools import convert_checkpoint, dress_rehearsal
        swin = {k: v.numpy() for k, v in dress_rehearsal.synth_swin2d_state_dict(
            embed=64, depths=(2, 2, 2, 2), heads=(2, 4, 8, 16)).items()}
        bert = {k: v.numpy() for k, v in dress_rehearsal.synth_hf_bert_state_dict(
            hidden=64, layers=2, intermediate=256).items()}
        params = convert_checkpoint.convert(swin, bert, inflate_2d=True, depths=(2, 2, 2, 2),
                                            bert_layers=2, fusion_layers=1)
        assert {k.split(".")[0] for k in params} >= {"backbone", "text_backbone"}
        out = save_bundle(export_retrieval_towers(model, batch_sizes=(1,), frames=4,
                                                  image_size=112, text_len=8, sim_candidates=2),
                          tempfile.mkdtemp())
        fns = load_bundle(out)
        v = fns["video_tower_b1"](torch.zeros((1, 4, 112, 112, 3), dtype=torch.uint8))
        assert v.shape == (1, 768) and bool(torch.isfinite(v).all())
        import torch.distributed as dist
        from clover_tpu_torch.parallel import all_gather_with_grad, broadcast_module
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        broadcast_module(model, dist.group.WORLD)
        assert all_gather_with_grad(v, dist.group.WORLD) is v
        dist.destroy_process_group()
    """)
    _run_isolated(code)


def test_chip_smoke_and_every_port_module_import_nothing_of_jax():
    """A bare ``import chip_smoke`` plus an import of every module of
    clover_tpu_torch (the serving, conversion and op-library modules, the
    data-parallel modules, and the export, convert and dress-rehearsal
    entries among them) leaves jax and the JAX package out of sys.modules."""
    _run_isolated(textwrap.dedent("""
        import importlib, pkgutil, sys
        import chip_smoke
        import clover_tpu_torch
        for mod in pkgutil.walk_packages(clover_tpu_torch.__path__, "clover_tpu_torch."):
            importlib.import_module(mod.name)
        assert "clover_tpu_torch.ops.attn_block" in sys.modules
        assert {"clover_tpu_torch.serving", "clover_tpu_torch.models.convert",
                "clover_tpu_torch.ops.library", "clover_tpu_torch.tools.export",
                "clover_tpu_torch.tools.convert_checkpoint",
                "clover_tpu_torch.tools.dress_rehearsal", "clover_tpu_torch.parallel",
                "clover_tpu_torch.parallel.collectives",
                "clover_tpu_torch.parallel.mesh"} <= set(sys.modules)
    """))
