"""The port's checkpoints, trainer, logging and entry points
(``clover_tpu_torch/engine/{checkpoint,trainer}.py``, ``utils/``,
``tools/{train,test}.py``) on the CPU, on the tiny
``configs/exp/debug_retrieval_synthetic.py`` model.

Held against the JAX package where the two compute the same thing: the
loader interleaving order, the best-step bookkeeping, the warm-start merge
lists, the metrics lines and TensorBoard bytes. Checked on their own: a
checkpoint round trip (bitwise), pruning, resume (1 epoch + ``--resume`` is
bitwise 2 epochs), preemption, the eval after training steps (the bias
cache rebuilt from the new weights), ``ema_eval``, and the train entry then
the test entry. ``tests/test_torch_trainer_parity.py`` runs the JAX
Trainer beside the port's.
"""

import json
import os
import shutil
import signal
import time

import numpy as np
import pytest
import torch

from clover_tpu.engine import trainer as jtrainer
from clover_tpu.engine.checkpoint import CheckpointManager as JCheckpointManager
from clover_tpu.engine.checkpoint import merge_pretrained_params as jmerge
from clover_tpu.utils import io as jio
from clover_tpu.utils import profiling as jprofiling
from clover_tpu.utils.logging import MetricsLogger as JMetricsLogger
from clover_tpu_torch.builder import build_dataset, build_loader, build_model
from clover_tpu_torch.config import load_config, parse_cfg_options
from clover_tpu_torch.engine import (CheckpointManager, TrainState, Trainer, interleave_loaders,
                                     make_embed_eval_step, make_optimizer,
                                     make_retrieval_train_step, merge_pretrained_params,
                                     to_model_batch)
from clover_tpu_torch.engine.eval_loop import _embeddings
from clover_tpu_torch.models import bias_cache_builder, init_params
from clover_tpu_torch.models.heads import NCEHeadForMM
from clover_tpu_torch.tools import test as ptest_entry
from clover_tpu_torch.tools import train as ptrain_entry
from clover_tpu_torch.utils import io as pio
from clover_tpu_torch.utils import profiling as pprofiling
from clover_tpu_torch.utils.logging import MetricsLogger
from test_torch_config import _jax_init_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RETRIEVAL = os.path.join(ROOT, "configs", "exp", "debug_retrieval_synthetic.py")
QA = os.path.join(ROOT, "configs", "exp", "debug_qa_synthetic.py")
PRETRAIN = os.path.join(ROOT, "configs", "exp", "debug_pretrain_synthetic.py")


def _train(argv):
    return ptrain_entry.main(["--cpu"] + argv)


def _lines(work_dir, prefix=None):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("time", "steps_per_sec")} for r in rows]


def _tiny(bn=False, ema=False, seed=0):
    """(cfg, train state, model batches, val dataset, val loader) of the
    debug retrieval config on the CPU; ``bn``: the projector with BatchNorm
    (running statistics, the JAX batch_stats)."""
    cfg = load_config(RETRIEVAL)
    model, mc = build_model(cfg.model, device="cpu")
    if bn:
        model.ssl_head = NCEHeadForMM(mc.swin.num_features, mc.text_bert.hidden_size,
                                      2 * mc.fusion.hidden_size, mc.vts_embed_dim,
                                      use_ln=False, text_bn=True)
    init_params(model, torch.Generator().manual_seed(seed))
    optimizer, schedule = make_optimizer(model, base_lr=1e-3, total_steps=10)
    state = TrainState.create(model, optimizer, schedule, ema=ema)
    ds = build_dataset(cfg.data.train, None)
    batches = [to_model_batch(b, cfg.img_size, torch.float32, "cpu")
               for b in build_loader(ds, {"batch_size": 8, "num_workers": 1}).epoch(0)]
    val_ds = build_dataset(cfg.data.val, None)
    return cfg, state, batches, val_ds, build_loader(val_ds, cfg.data.val_loader, test=True)


def _state_tensors(state):
    out = {"p." + n: p.detach().clone() for n, p in state.model.named_parameters()}
    out.update({"b." + n: b.clone() for n, b in state.model.named_buffers()})
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"o.{i}.{k}": v.clone() for k, v in s.items()})
    for n, e in (state.ema_params or {}).items():
        out["e." + n] = e.clone()
    return out


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


class _Loader:
    def __init__(self, tag, n):
        self.tag, self.n = tag, n

    def __len__(self):
        return self.n

    def epoch(self, e):
        return [(self.tag, e, i) for i in range(self.n)]


@pytest.mark.parametrize("lengths,epoch", [((3, 1), 0), ((2, 5, 3), 1), ((4,), 0),
                                           ((1, 2, 7), 1000)])
def test_interleave_loaders_matches_jax(lengths, epoch):
    loaders = [_Loader(i, n) for i, n in enumerate(lengths)]
    got = list(interleave_loaders(loaders, epoch))
    assert got == list(jtrainer.interleave_loaders(loaders, epoch))
    assert len(got) == max(lengths) * len(lengths)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip_is_bitwise(tmp_path, async_save):
    """Parameters, BatchNorm buffers, AdamW moments and step counts, the EMA
    copy and the step after two steps, restored into a fresh model and
    optimizer, are bitwise the saved ones."""
    cfg, state, batches, _, _ = _tiny(bn=True, ema=True)
    step = make_retrieval_train_step(state.model, ema_momentum=0.5, grad_clip_norm=5.0)
    gen = torch.Generator().manual_seed(1)
    for b in batches:
        state, _ = step(state, b, gen)
    assert state.step == 2 and any("running" in n or n.endswith(("mean", "var"))
                                   for n, _ in state.model.named_buffers())
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    mgr.save(state, meta={"epoch": 0})
    want = _state_tensors(state)
    for b in batches:   # the live state moves on; the snapshot must not
        state, _ = step(state, b, gen)
    _, fresh, _, _, _ = _tiny(bn=True, ema=True, seed=5)
    assert CheckpointManager(str(tmp_path)).restore(fresh) is fresh
    assert fresh.step == 2 and mgr.read_meta() == {"step": 2, "epoch": 0}
    _assert_bitwise(_state_tensors(fresh), want)
    params = mgr.restore_params()
    assert all(torch.equal(params[n[2:]], want[n]) for n in want if n.startswith("p."))


def test_pruning_keeps_the_best_step(tmp_path):
    _, state, _, _, _ = _tiny()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    os.makedirs(tmp_path / ".tmp_step_0000000099.1")   # a write cut short: not a step
    for s in range(1, 7):
        state.step = s
        if s == 2:
            assert mgr.update_best(s, "Recall@1", 50.0)
        mgr.save(state, meta={"epoch": s})
    assert mgr.all_steps() == [2, 5, 6] and mgr.latest_step() == 6
    metas = sorted(f for f in os.listdir(tmp_path) if f.startswith("meta_"))
    assert metas == [f"meta_{s:010d}.json" for s in (2, 5, 6)]
    assert json.loads((tmp_path / "best.json").read_text()) == {
        "step": 2, "key": "Recall@1", "value": 50.0}
    assert CheckpointManager(str(tmp_path)).restore(_tiny()[1], step=5).step == 5


@pytest.mark.parametrize("greater", [True, False])
def test_update_best_matches_jax(tmp_path, greater):
    values = [3.0, 2.0, 5.0, 5.0, 4.0, 7.5, 1.0, 7.5, 9.0]
    p, j = CheckpointManager(str(tmp_path / "p")), JCheckpointManager(str(tmp_path / "j"))
    got = [p.update_best(i, "acc", v, greater) for i, v in enumerate(values)]
    want = [j.update_best(i, "acc", v, greater) for i, v in enumerate(values)]
    assert got == want
    assert (tmp_path / "p" / "best.json").read_text() == (tmp_path / "j" / "best.json").read_text()
    # a new manager reads the best back
    assert CheckpointManager(str(tmp_path / "p"))._best == json.loads(
        (tmp_path / "j" / "best.json").read_text())


def test_merge_pretrained_params_lists_match_jax(tmp_path):
    """A pretrain checkpoint warm-starting the QA model: the same children
    loaded and fresh as the JAX merge on the JAX init trees, the loaded ones
    copied bitwise, and the test entry's --load-from on it."""
    pre_cfg, pre_shapes = _jax_init_shapes(PRETRAIN)
    qa_cfg, qa_shapes = _jax_init_shapes(QA)
    _, jloaded, jfresh = jmerge(dict(qa_shapes), dict(pre_shapes))
    pre, _ = build_model(pre_cfg.model, device="cpu")
    init_params(pre, torch.Generator().manual_seed(3))
    opt, sched = make_optimizer(pre, base_lr=1e-3, total_steps=10)
    CheckpointManager(str(tmp_path)).save(TrainState.create(pre, opt, sched))
    qa, _ = build_model(qa_cfg.model, device="cpu")
    init_params(qa, torch.Generator().manual_seed(4))
    pretrained = CheckpointManager(str(tmp_path)).restore_params()
    _, loaded, fresh = merge_pretrained_params(qa, pretrained)
    assert sorted(loaded) == sorted(jloaded) and sorted(fresh) == sorted(jfresh)
    assert loaded and fresh
    src = dict(pre.named_parameters())
    for name, p in qa.named_parameters():
        if name.split(".")[0] in loaded:
            assert torch.equal(p, src[name]), name
    metrics = ptest_entry.main([QA, "--cpu", "--load-from", str(tmp_path)])
    assert set(metrics) == {"acc"}


def test_two_epochs_equal_one_epoch_and_resume(tmp_path, monkeypatch):
    """Two epochs in one run, and the same config stopped after its first
    epoch then resumed (``--resume``): bitwise the same parameters, AdamW
    state and step, and the same per-step losses."""
    full = _train([RETRIEVAL, "--work-dir", str(tmp_path / "a")])
    fit = Trainer.fit

    def first_epoch_only(self):
        self.total_epochs = 1
        return fit(self)

    monkeypatch.setattr(Trainer, "fit", first_epoch_only)
    _train([RETRIEVAL, "--work-dir", str(tmp_path / "b")])
    monkeypatch.setattr(Trainer, "fit", fit)
    resumed = _train([RETRIEVAL, "--work-dir", str(tmp_path / "b"), "--resume"])
    assert resumed.start_epoch == 1 and resumed.state.step == full.state.step == 4
    _assert_bitwise(_state_tensors(resumed.state), _state_tensors(full.state))
    a = [r for r in _lines(tmp_path / "a") if "loss" in r]
    b = [r for r in _lines(tmp_path / "b") if "loss" in r]
    assert a == b and len(a) == 4
    assert {"resumed_step": 2.0, "resumed_epoch": 1.0} in _lines(tmp_path / "b")


def test_preemption_saves_the_finished_step_and_resume_redoes_the_epoch(tmp_path):
    """A SIGTERM inside step 3 (epoch 1) is acted on when the step ends: the
    checkpoint holds step 3 with meta preempted / epoch 1, the run exits
    with 128 + 15, the handlers are restored, and a resume starts at epoch
    1 again."""
    cfg, state, _, _, _ = _tiny()
    ds = build_dataset(cfg.data.train, None)
    loader = build_loader(ds, cfg.data.train_loader)
    step = make_retrieval_train_step(state.model, grad_clip_norm=5.0)

    def interrupted(state, batch, gen):
        if state.step == 2:
            signal.raise_signal(signal.SIGTERM)
        return step(state, batch, gen)

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    before = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(state, [interrupted], [loader],
                      lambda li, b: to_model_batch(b, cfg.img_size, torch.float32, "cpu"),
                      torch.Generator().manual_seed(1), 3, work_dir=str(tmp_path),
                      log_interval=1, ckpt_manager=mgr)
    with pytest.raises(SystemExit) as exc:
        trainer.fit()
    assert exc.value.code == 128 + signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before
    assert mgr.all_steps() == [2, 3]
    assert mgr.read_meta() == {"step": 3, "preempted": True, "epoch": 1}
    want = _state_tensors(trainer.state)
    again = Trainer(_tiny(seed=7)[1], [step], [loader], trainer.batch_to_device,
                    torch.Generator(), 3, ckpt_manager=CheckpointManager(str(tmp_path / "ckpt")))
    assert again.resume() and again.start_epoch == 1 and again.state.step == 3
    _assert_bitwise(_state_tensors(again.state), want)
    assert {"preempted_signal": 15.0, "step": 3} in _lines(tmp_path)


def test_a_signal_during_the_ema_eval_saves_the_trained_weights(tmp_path):
    """A SIGTERM inside an ``ema_eval`` eval, while the model holds the EMA
    copy, is acted on when the eval has ended: the preemption checkpoint
    holds the trained weights (not the EMA copy) with meta preempted /
    epoch 0, and the run exits with 128 + 15."""
    cfg, state, _, _, _ = _tiny(ema=True)
    ds = build_dataset(cfg.data.train, None)
    loader = build_loader(ds, cfg.data.train_loader)
    step = make_retrieval_train_step(state.model, ema_momentum=0.5, grad_clip_norm=5.0)
    seen = {}

    def eval_fn(model):
        seen["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        signal.raise_signal(signal.SIGTERM)
        return {"Recall@1": 0.0}

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    trainer = Trainer(state, [step], [loader],
                      lambda li, b: to_model_batch(b, cfg.img_size, torch.float32, "cpu"),
                      torch.Generator(), 2, eval_fn=eval_fn, save_best_key="Recall@1",
                      ema_eval=True, ckpt_manager=mgr)
    with pytest.raises(SystemExit) as exc:
        trainer.fit()
    assert exc.value.code == 128 + signal.SIGTERM
    assert mgr.all_steps() == [2]
    assert mgr.read_meta() == {"step": 2, "preempted": True, "epoch": 0}
    ema = trainer.state.ema_params
    assert all(torch.equal(seen["params"][n], ema[n]) for n in ema)
    saved = mgr.restore_params()
    trained = dict(trainer.state.model.named_parameters())
    assert saved.keys() == trained.keys()
    assert all(torch.equal(saved[n], trained[n].detach()) for n in saved)
    assert any(not torch.equal(saved[n], ema[n]) for n in ema)


def test_resume_refuses_a_checkpoint_without_an_epoch(tmp_path):
    """Every save of the trainer writes the epoch into the meta; a
    checkpoint whose meta lacks it is refused, not guessed from the step."""
    cfg, state, _, _, _ = _tiny()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state)
    trainer = Trainer(_tiny()[1], [None], [None], None, torch.Generator(), 1, ckpt_manager=mgr)
    with pytest.raises(ValueError, match="no epoch in its meta"):
        trainer.resume()


def _val_embeddings(model, val_ds, val_loader, cache):
    return _embeddings(make_embed_eval_step(model.eval()), model, val_loader.epoch(0), cache,
                       32, torch.float32)


def test_eval_after_training_matches_a_fresh_model(tmp_path):
    """The bias-cache trap: the train entry's eval after training steps
    builds the Swin bias cache from the weights of that moment, so it gives
    a freshly built model's eval on the same weights, bitwise; a cache kept
    from before the steps gives other embeddings."""
    cfg, state, batches, val_ds, val_loader = _tiny()
    model = state.model
    eval_fn = ptrain_entry.build_eval_fn(cfg, model, val_ds, val_loader, cfg.img_size)
    builder = bias_cache_builder(model.config.swin)
    stale = builder(model, (2, 8, 8))
    model.eval()
    eval_fn(model)   # an eval before the steps, as the trainer runs one each epoch
    step = make_retrieval_train_step(model, grad_clip_norm=5.0)
    for b in batches:
        state, _ = step(state, b, torch.Generator())
    model.eval()
    got = eval_fn(model)
    got_v, got_t, _ = _val_embeddings(model, val_ds, val_loader, builder)
    fresh, _ = build_model(cfg.model, device="cpu")
    fresh.load_state_dict(model.state_dict())
    fresh.eval()
    assert ptrain_entry.build_eval_fn(cfg, fresh, val_ds, val_loader, cfg.img_size)(fresh) == got
    want_v, want_t, _ = _val_embeddings(fresh, val_ds, val_loader, builder)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_t, want_t)
    stale_v, _, _ = _val_embeddings(model, val_ds, val_loader, stale)
    assert np.abs(stale_v - want_v).max() > 1e-6


def test_ema_eval_swaps_the_ema_weights_in_and_out(tmp_path):
    """With ``ema_eval`` the eval sees the EMA copy (and its eval equals a
    fresh model's on the EMA weights); after it the model holds the trained
    weights again, bitwise, in training mode."""
    cfg, state, _, val_ds, val_loader = _tiny(ema=True)
    ds = build_dataset(cfg.data.train, None)
    loader = build_loader(ds, cfg.data.train_loader)
    step = make_retrieval_train_step(state.model, ema_momentum=0.5, grad_clip_norm=5.0)
    real_eval = ptrain_entry.build_eval_fn(cfg, state.model, val_ds, val_loader, cfg.img_size)
    seen = {}

    def eval_fn(model):
        seen["training"] = model.training
        seen["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        seen["metrics"] = real_eval(model)
        return seen["metrics"]

    trainer = Trainer(state, [step], [loader],
                      lambda li, b: to_model_batch(b, cfg.img_size, torch.float32, "cpu"),
                      torch.Generator(), 1, eval_fn=eval_fn, ema_eval=True)
    trainer.fit()
    model = trainer.state.model
    assert not seen["training"] and model.training
    ema = trainer.state.ema_params
    assert all(torch.equal(seen["params"][n], ema[n]) for n in ema)
    assert any(not torch.equal(p, ema[n]) for n, p in model.named_parameters())
    fresh, _ = build_model(cfg.model, device="cpu")
    with torch.no_grad():
        for n, p in fresh.named_parameters():
            p.copy_(ema[n])
    fresh.eval()
    want = ptrain_entry.build_eval_fn(cfg, fresh, val_ds, val_loader, cfg.img_size)(fresh)
    assert seen["metrics"] == want


def test_metrics_logger_and_tensorboard_match_jax(tmp_path, monkeypatch):
    """The same payloads through both loggers, the clock fixed: equal jsonl
    lines and byte-equal TensorBoard event files (same names)."""
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    payloads = [({"loss": 1.5, "grad_norm": np.float32(2.25), "epoch": 0}, 1, "train "),
                ({"Recall@1": 12.5, "MR": 4.5, "hist": [1, 2]}, 2, "eval[ep0] "),
                ({"resumed_step": 2, "resumed_epoch": 1}, None, "")]
    for cls, name in ((MetricsLogger, "p"), (JMetricsLogger, "j")):
        logger = cls(str(tmp_path / name), tensorboard=True)
        for payload, step, prefix in payloads:
            logger.log(payload, step=step, prefix=prefix)
        logger.close()
    MetricsLogger(None).log({"loss": torch.tensor(0.5)}, step=1)   # tensors too, no file
    assert (tmp_path / "p" / "metrics.jsonl").read_text() == (
        tmp_path / "j" / "metrics.jsonl").read_text()
    (pev,), (jev,) = os.listdir(tmp_path / "p" / "tb"), os.listdir(tmp_path / "j" / "tb")
    assert pev == jev
    assert (tmp_path / "p" / "tb" / pev).read_bytes() == (tmp_path / "j" / "tb" / jev).read_bytes()


def test_io_and_step_timer_match_jax(tmp_path, monkeypatch):
    obj = {"a": [1, 2], "b": "x"}
    for mod, name in ((pio, "p"), (jio, "j")):
        mod.hmkdir(str(tmp_path / name))
        mod.hsave_json(obj, str(tmp_path / name / "o.json"))
        mod.hsave_jsonl([obj, obj], str(tmp_path / name / "o.jsonl"))
        mod.hsave_pkl(obj, str(tmp_path / name / "o.pkl"))
    for f in ("o.json", "o.jsonl", "o.pkl"):
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    assert pio.hload_jsonl(str(tmp_path / "j" / "o.jsonl")) == [obj, obj]
    assert pio.hload_pkl(str(tmp_path / "j" / "o.pkl")) == obj
    assert pio.hglob(str(tmp_path / "p" / "o.*")) == sorted(
        str(tmp_path / "p" / f) for f in ("o.json", "o.jsonl", "o.pkl"))
    clock = iter(np.cumsum([0.0, 1.0, 1.0, 0.5, 0.25, 2.0]).tolist() * 2)
    monkeypatch.setattr(time, "time", lambda: next(clock))
    timers = [pprofiling.StepTimer(warmup=1), jprofiling.StepTimer(warmup=1)]
    for t in timers:
        for _ in range(6):
            t.tick()
    assert timers[0].summary() == timers[1].summary() and timers[0].summary()["steps"] == 4


def test_profile_trace_writes_a_trace(tmp_path):
    with pprofiling.trace(str(tmp_path / "prof")):
        torch.ones(8) @ torch.ones(8)
    assert {"trace.json", "ops.txt"} <= set(os.listdir(tmp_path / "prof"))
    with pprofiling.trace(None):
        pass


def test_train_then_test_entry(tmp_path, capsys):
    """The train entry then the test entry, in-process, on the CPU: the test
    entry's metrics on the latest and on the best step equal the trainer's
    eval lines for them, and --all-steps prints one line per checkpoint."""
    trainer = _train([RETRIEVAL, "--work-dir", str(tmp_path), "--tb",
                      "--cfg-options", "checkpoint.max_to_keep=1"])
    assert trainer.state.step == 4
    lines = _lines(tmp_path)
    train = [r for r in lines if "loss" in r]
    evals = {r["step"]: r for r in lines if "Recall@1" in r}
    assert [r["step"] for r in train] == [1, 2, 3, 4] and sorted(evals) == [2, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in train)
    assert os.path.exists(tmp_path / "config.json") and os.listdir(tmp_path / "tb")
    ckpt = str(tmp_path / "checkpoints")
    best = json.loads(open(os.path.join(ckpt, "best.json")).read())["step"]
    capsys.readouterr()
    for step in sorted({best, 4}):
        metrics = ptest_entry.main([RETRIEVAL, "--cpu", "--ckpt-dir", ckpt, "--step", str(step)])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        want = {k: v for k, v in evals[step].items() if k != "step"}
        assert printed == metrics == want
        assert {"Recall@1", "Recall@5", "Recall@10", "Recall@all"} <= set(metrics)
    sweep = ptest_entry.main([RETRIEVAL, "--cpu", "--ckpt-dir", ckpt, "--all-steps"])
    assert [m["step"] for m in sweep] == CheckpointManager(ckpt).all_steps()


@pytest.mark.parametrize("mode", ["itm_retrieval", "zeroshot_action"])
def test_test_entry_eval_modes(tmp_path, capsys, mode):
    """The test entry under the ITM rerank and the zero-shot action
    ``eval_mode`` (the seeded random weights): its printed metrics equal
    the port's eval loop of that mode run by hand on a model built and
    initialised the same way."""
    from clover_tpu_torch.data.datasets import ActionVideoDataset
    from clover_tpu_torch.builder import build_tokenizer
    from clover_tpu_torch.engine import (make_itm_embed_step, make_itm_score_step,
                                         run_itm_retrieval_eval, run_zeroshot_action_eval)

    if mode == "itm_retrieval":
        path, opts = RETRIEVAL, ["model.eval_mode=itm_retrieval", "model.use_itm_head=True"]
    else:
        ann = tmp_path / "ann.jsonl"
        ann.write_text("".join(json.dumps({"filename": f"v{i}.mp4", "label": 1 + i % 3}) + "\n"
                               for i in range(6)))
        path = tmp_path / "zeroshot.py"
        path.write_text(f"""_base_ = [{RETRIEVAL!r}]
model = dict(eval_mode="zeroshot_action")
tokenizer = dict(synthetic=True)
data = dict(test=dict(type="ActionVideoDataset", ann_file={str(ann)!r},
                      class_names=["runs", "sits", "eats"], backend="synthetic",
                      num_frames=4, test_canonical_size=40))
""")
        path, opts = str(path), []
    got = ptest_entry.main([path, "--cpu", "--cfg-options", *opts])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got

    cfg = load_config(path, overrides=parse_cfg_options(opts))
    model, _ = build_model(cfg.model, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    model.eval()
    common = dict(bias_cache=bias_cache_builder(model.config.swin), out_size=cfg.img_size,
                  dtype=torch.float32)
    if mode == "itm_retrieval":
        ds = build_dataset(cfg.data.val, None)
        loader = build_loader(ds, cfg.data.val_loader, test=True)
        want = run_itm_retrieval_eval(make_itm_embed_step(model), make_itm_score_step(model),
                                      model, ds, loader.epoch(0), **common)
    else:
        ds = ActionVideoDataset(tokenizer=build_tokenizer(cfg.tokenizer),
                                **{k: v for k, v in cfg.data.test.items() if k != "type"})
        loader = build_loader(ds, cfg.data.val_loader, test=True)
        enc = ds.encode_class_names("a video of {}")
        with torch.no_grad():
            cls = model.forward_text(torch.as_tensor(enc["token_ids"]),
                                     torch.as_tensor(enc["input_mask"])).numpy()
        want = run_zeroshot_action_eval(make_embed_eval_step(model), model, ds, loader.epoch(0),
                                        cls, **common)
    assert got == want and len(got) > 0


def test_entries_refuse_what_they_do_not_run(tmp_path):
    """No card and no --cpu, --distributed without torchrun's variables, or
    a parallel section above 1: each raises before any work."""
    with pytest.raises(SystemExit, match="torchrun"):
        ptrain_entry.main([RETRIEVAL, "--cpu", "--distributed"])
    with pytest.raises(SystemExit, match="Queue 1 item 5"):
        _train([RETRIEVAL, "--cfg-options", "parallel.fsdp=2"])
    with pytest.raises(SystemExit, match="Queue 1 item 5"):
        ptest_entry.main([RETRIEVAL, "--cpu", "--cfg-options", "parallel.model=2"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            ptrain_entry.main([RETRIEVAL, "--work-dir", str(tmp_path / "x")])
        with pytest.raises(SystemExit, match="no CUDA device"):
            ptest_entry.main([RETRIEVAL])
        assert not os.path.exists(tmp_path / "x")
    with pytest.raises(SystemExit, match="no checkpoint"):
        ptest_entry.main([RETRIEVAL, "--cpu", "--ckpt-dir", str(tmp_path / "empty")])
    shutil.rmtree(tmp_path / "empty", ignore_errors=True)
