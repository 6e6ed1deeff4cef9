"""The JAX ``Trainer`` and the port's on ``configs/exp/debug_retrieval_synthetic.py``
(CPU, fp32).

Both trainers are built as their train entries build them (the JAX
``tools/train.py``, ``clover_tpu_torch.tools.train``): the same optimizer,
schedule, clip and retrieval step, the eval of ``data.val`` every epoch.
The port's weights are the JAX init, through the bridge. Both run 2 epochs
on the same JAX loaders' host batches (so the resize to the canonical size,
torch's against OpenCV's, stays out); each makes its model batch on its own
device preprocess. Compared: each step's loss and grad_norm (within 2e-5
relative; observed 9.2e-7 and 2.9e-6 at most), the parameters after the 4 steps
(``test_torch_train.py``'s tolerances: 1e-5 absolute, the attention key
biases, whose exact gradient is zero, within 3 lr), each eval's metric dict
(equal), and the eval similarity matrix after training (within 1e-4).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clover_tpu import builder as jbuilder
from clover_tpu import config as jconfig
from clover_tpu.engine import TrainState as JTrainState
from clover_tpu.engine import Trainer as JTrainer
from clover_tpu.engine import make_embed_eval_step as jmake_eval_step
from clover_tpu.engine import make_optimizer as jmake_optimizer
from clover_tpu.engine import make_retrieval_train_step as jmake_step
from clover_tpu.engine import run_retrieval_eval as jrun_retrieval_eval
from clover_tpu.models.swin3d import bias_cache_builder as jbias_cache_builder
from clover_tpu.ops.preprocess import eval_preprocess as jeval_preprocess
from clover_tpu.ops.preprocess import preprocess_clips as jpreprocess_clips
from clover_tpu_torch.builder import build_model
from clover_tpu_torch.config import load_config
from clover_tpu_torch.engine import (TrainState, Trainer, make_embed_eval_step, make_optimizer,
                                     make_retrieval_train_step, to_model_batch)
from clover_tpu_torch.engine.eval_loop import _embeddings
from clover_tpu_torch.models import bias_cache_builder, load_jax_params
from clover_tpu_torch.tools.train import build_eval_fn
from test_torch_train import _assert_params_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RETRIEVAL = os.path.join(ROOT, "configs", "exp", "debug_retrieval_synthetic.py")


def _lines(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in ("time", "steps_per_sec")}
                for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = jconfig.load_config(RETRIEVAL)
    img, epochs = cfg.img_size, cfg.total_epochs
    opt, sched, loss = cfg.optimizer, cfg.schedule, cfg.model.loss
    ds = jbuilder.build_dataset(cfg.data.train, None)
    loader = jbuilder.build_loader(ds, cfg.data.train_loader, seed=0)
    val_ds = jbuilder.build_dataset(cfg.data.val, None)
    val_loader = jbuilder.build_loader(val_ds, cfg.data.val_loader, test=True)
    total = len(loader) * epochs
    optim = dict(base_lr=opt.lr, total_steps=total, warmup_steps=0,
                 weight_decay=opt.weight_decay, betas=tuple(opt.betas),
                 min_lr_ratio=sched.min_lr_ratio, warmup_start_ratio=0.001)

    # ---- the JAX trainer, as tools/train.py builds it (one device, no mesh)
    jmodel, _ = jbuilder.build_model(cfg.model)

    def jbatch(li, hb):
        imgs = jpreprocess_clips(hb["imgs"].reshape((-1,) + hb["imgs"].shape[2:]),
                                 hb["crop_boxes"], hb["flip"], out_size=img,
                                 dtype=jmodel.dtype)
        return {"imgs": imgs.reshape((-1, hb["imgs"].shape[1]) + imgs.shape[1:]),
                "token_ids": hb["token_ids"], "input_mask": hb["input_mask"]}

    params = jmodel.init(jax.random.PRNGKey(0), jbatch(0, next(iter(loader))),
                         train=False)["params"]
    init = jax.device_get(params)
    tx, _ = jmake_optimizer(params, grad_clip_norm=None, **optim)
    jstep = jmake_step(jmodel, temperature=loss.temperature, cos_sim=loss.cos_sim,
                       grad_clip_norm=opt.grad_clip)
    jeval_step = jmake_eval_step(jmodel)
    jcache = jbias_cache_builder(jmodel.config.swin)

    def jeval_fn(p):
        return jrun_retrieval_eval(jeval_step, p, val_ds, val_loader.epoch(0), out_size=img,
                                   dtype=jmodel.dtype, bias_cache=jcache)

    jdir = str(tmp_path_factory.mktemp("jax"))
    jtr = JTrainer(JTrainState.create(params, tx), [jstep], [loader], jbatch,
                   jax.random.PRNGKey(cfg.get("seed", 0) + 1), epochs, work_dir=jdir,
                   log_interval=cfg.log_interval, eval_fn=jeval_fn,
                   save_best_key=cfg.evaluation.save_best)
    jtr.fit()

    # ---- the port's trainer, as clover_tpu_torch.tools.train builds it
    pcfg = load_config(RETRIEVAL)
    pmodel, _ = build_model(pcfg.model, device="cpu")
    load_jax_params(pmodel, init)
    optimizer, schedule = make_optimizer(pmodel, **optim)
    pstep = make_retrieval_train_step(pmodel, temperature=loss.temperature,
                                      cos_sim=loss.cos_sim, grad_clip_norm=opt.grad_clip)
    pdir = str(tmp_path_factory.mktemp("port"))
    ptr = Trainer(TrainState.create(pmodel, optimizer, schedule), [pstep], [loader],
                  lambda li, hb: to_model_batch(hb, img, pmodel.dtype, "cpu"),
                  torch.Generator().manual_seed(1), epochs, work_dir=pdir,
                  log_interval=pcfg.log_interval,
                  eval_fn=build_eval_fn(pcfg, pmodel, val_ds, val_loader, img),
                  save_best_key=pcfg.evaluation.save_best)
    ptr.fit()
    return dict(jtr=jtr, ptr=ptr, jdir=jdir, pdir=pdir, jmodel=jmodel, jeval_step=jeval_step,
                jcache=jcache, val_loader=val_loader, img=img)


def test_per_step_loss_and_grad_norm_match(runs):
    jl = [r for r in _lines(runs["jdir"]) if "loss" in r]
    pl = [r for r in _lines(runs["pdir"]) if "loss" in r]
    assert [r["step"] for r in pl] == [r["step"] for r in jl] == [1, 2, 3, 4]
    assert max(r["grad_norm"] for r in jl) > 5.0, "the clip never fired"
    for p, j in zip(pl, jl):
        assert p.keys() == j.keys()
        for k in ("retrieval_nce_loss", "loss", "grad_norm"):
            assert p[k] == pytest.approx(j[k], rel=2e-5, abs=0), (p["step"], k)
        assert p["epoch"] == j["epoch"]


def test_final_parameters_match(runs):
    assert runs["ptr"].state.step == int(runs["jtr"].state.step) == 4
    _assert_params_close(runs["ptr"].state.model, jax.device_get(runs["jtr"].state.params),
                         1e-5, "after 2 epochs")


def test_eval_metrics_and_similarity_match(runs):
    je = [r for r in _lines(runs["jdir"]) if "Recall@1" in r]
    pe = [r for r in _lines(runs["pdir"]) if "Recall@1" in r]
    assert len(pe) == len(je) == 2 and pe == je
    # the similarity matrix of the trained models on the val set
    jmodel, params = runs["jmodel"], runs["jtr"].state.params
    vs, ts = [], []
    cache = None
    for b in runs["val_loader"].epoch(0):
        imgs = jeval_preprocess(jnp.asarray(b["imgs"].reshape((-1,) + b["imgs"].shape[2:])),
                                out_size=runs["img"], dtype=jmodel.dtype)
        imgs = imgs.reshape((-1, b["imgs"].shape[1]) + imgs.shape[1:])
        if cache is None:
            cache = runs["jcache"](params, (b["imgs"].shape[2], runs["img"], runs["img"]))
        v, t = runs["jeval_step"](params, imgs, jnp.asarray(b["token_ids"]),
                                  jnp.asarray(b["input_mask"]), cache)
        vs.append(np.asarray(v, np.float32))
        ts.append(np.asarray(t, np.float32))
    model = runs["ptr"].state.model.eval()
    pv, pt, _ = _embeddings(make_embed_eval_step(model), model, runs["val_loader"].epoch(0),
                            bias_cache_builder(model.config.swin), runs["img"], torch.float32)

    def sims(v, t):
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        t = t / np.linalg.norm(t, axis=1, keepdims=True)
        return t @ v.T

    got, want = sims(pv, pt), sims(np.concatenate(vs), np.concatenate(ts))
    assert got.shape == want.shape == (8, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
