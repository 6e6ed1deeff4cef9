"""The port's QA / multiple-choice / FIB finetune held against the JAX package
on the CPU, on the tiny QA configuration of ``test_torch_qa_eval.py``
(fp32, dropouts at 0 where the JAX dropout stream cannot be matched):

- ``ITMHead``, ``QAMCHead`` and ``QAOEHead`` in eval and in training
  (outputs and input gradients, 1e-5 absolute and relative);
- each classification loss, with its soft-label, ``class_weight`` and
  ``pos_weight`` forms, and ``qa_loss`` (1e-6);
- ``forward_test`` of every QA readout (MC and OE with ``answer_cls``, FIB
  with ``answer_mask``, ``answer_cls`` through the ITM head, the default
  ITM readout) against the JAX ``forward_test`` jitted once a task, 1e-4
  absolute and relative as ``tests/test_torch_slice.py``;
- ``load_jax_params`` of every task's tree (exact), and the weight-decay
  mask against the JAX mask;
- 3 steps of ``make_qa_train_step`` (AdamW, warmup, a clip that fires)
  against the JAX step: loss and grad_norm within 2e-5 relative, the
  parameters within 2e-5 absolute.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clover_tpu.models.finetune as jfinetune
from clover_tpu.engine import TrainState as JTrainState
from clover_tpu.engine import make_optimizer as jmake_optimizer
from clover_tpu.engine import weight_decay_mask as jweight_decay_mask
from clover_tpu.engine.steps import make_qa_train_step as jmake_qa_train_step
from clover_tpu.losses import classification as jcls
from clover_tpu.losses.objectives import qa_loss as jqa_loss
from clover_tpu.models import heads as jheads
from clover_tpu_torch.engine import (TrainState, make_optimizer, make_qa_train_step,
                                     weight_decay_mask)
from clover_tpu_torch.losses import (bce_with_logits, cross_entropy, label_smoothing_cross_entropy,
                                     qa_loss, softmax_focal_multiclass)
from clover_tpu_torch.models import (FinetuneConfig, ITMHead, QAMCHead, QAOEHead, load_jax_params,
                                     state_from_jax)
from test_torch_qa_eval import TASKS, TOL, _t, jax_model, jax_tree, port_model, qa_inputs
from test_torch_train import LR, _assert_params_close

HEAD_TOL = dict(atol=1e-5, rtol=1e-5)
TOTAL, WARMUP, CLIP = 20, 2, 1.0   # the 3-step run's optimizer and clip (lr: LR)


@contextlib.contextmanager
def jax_heads_without_dropout():
    """The JAX finetune's heads built with dropout 0 (their rates are not
    config fields), so a training forward draws nothing."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("ITMHead", "QAMCHead", "QAOEHead"):
            mp.setattr(jfinetune, name, functools.partial(getattr(jheads, name),
                                                          dropout_ratio=0.0))
        yield


def port_model_without_dropout(task):
    pm = port_model(task)
    for head in ("itm_head", "qa_head"):
        if hasattr(pm, head):
            getattr(pm, head).drop = 0.0
    return pm


@pytest.fixture(scope="module")
def trees():
    """Each task's seeded JAX tree, made once."""
    cache = {}

    def get(task):
        if task not in cache:
            cache[task] = jax_tree(jax_model(task), task)
        return cache[task]

    return get


# ------------------------------------------------------------------- heads

HEADS = {"ITMHead": (lambda: jheads.ITMHead(64, dropout_ratio=0.0),
                     lambda: ITMHead(64, dropout_ratio=0.0)),
         "QAMCHead": (lambda: jheads.QAMCHead(64, dropout_ratio=0.0),
                      lambda: QAMCHead(64, dropout_ratio=0.0)),
         "QAOEHead": (lambda: jheads.QAOEHead(64, num_labels=7, dropout_ratio=0.0),
                      lambda: QAOEHead(64, 64, num_labels=7, dropout_ratio=0.0))}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_matches_jax(head, train):
    """The head on seeded (5, 64) features: output, and in training the
    gradient of a seeded projection of it with respect to the input."""
    jhead, phead = (make() for make in HEADS[head])
    rng = np.random.default_rng(20)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = jax.tree_util.tree_map(
        lambda leaf: (0.3 * rng.normal(size=leaf.shape)).astype(np.float32), shapes)
    load_jax_params(phead, params)
    phead.train(train)

    def jfn(p, a):
        return jhead.apply(p, a, deterministic=not train)

    want = np.asarray(jfn(params, x))
    xt = torch.tensor(x, requires_grad=True)
    got = phead(xt, torch.Generator())
    np.testing.assert_allclose(got.detach().numpy(), want, **HEAD_TOL)
    if train:
        w = rng.normal(size=want.shape).astype(np.float32)
        jgrad = jax.grad(lambda a: jnp.sum(jfn(params, a) * w))(x)
        (got * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **HEAD_TOL)


def test_head_shapes_and_rates():
    """The JAX heads' widths and dropout rates: ITM fc1 D -> D, fc2 2; MC
    fc1 256, fc2 1; OE fc1 D / 2, fc2 num_labels; dropouts 0.1, 0.1, 0.5."""
    itm, mc, oe = ITMHead(768), QAMCHead(768), QAOEHead(768, 768, 1500)
    assert (itm.fc1.out_features, itm.fc2.out_features, itm.drop) == (768, 2, 0.1)
    assert (mc.fc1.out_features, mc.fc2.out_features, mc.drop) == (256, 1, 0.1)
    assert (oe.fc1.out_features, oe.fc2.out_features, oe.drop) == (384, 1500, 0.5)
    assert oe.norm.eps == 1e-5 and not oe.norm.kernel and not mc.norm.kernel


# ------------------------------------------------------------------ losses

def _loss_cases():
    rng = np.random.default_rng(21)
    logits = (3 * rng.normal(size=(6, 5))).astype(np.float32)
    hard = rng.integers(0, 5, size=6)
    soft = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    weight = rng.uniform(0.2, 2.0, size=5).astype(np.float32)
    binary = (rng.random(size=(6, 5)) < 0.5).astype(np.float32)
    return {
        "cross_entropy": (jcls.cross_entropy, cross_entropy, (logits, hard), {}),
        "cross_entropy class_weight": (jcls.cross_entropy, cross_entropy, (logits, hard),
                                       {"class_weight": weight}),
        "cross_entropy soft": (jcls.cross_entropy, cross_entropy, (logits, soft), {}),
        "cross_entropy soft class_weight": (jcls.cross_entropy, cross_entropy, (logits, soft),
                                            {"class_weight": weight}),
        "bce_with_logits": (jcls.bce_with_logits, bce_with_logits, (logits, binary), {}),
        "bce_with_logits pos_weight": (jcls.bce_with_logits, bce_with_logits, (logits, binary),
                                       {"pos_weight": weight}),
        "label_smoothing_cross_entropy": (jcls.label_smoothing_cross_entropy,
                                          label_smoothing_cross_entropy, (logits, hard),
                                          {"epsilon": 0.2}),
        "softmax_focal_multiclass": (jcls.softmax_focal_multiclass, softmax_focal_multiclass,
                                     (logits, hard), {"gamma": 2.0}),
        "qa_loss": (lambda *a: jqa_loss(*a)["qa_loss"], lambda *a: qa_loss(*a)["qa_loss"],
                    (logits, hard[:, None]), {}),
    }


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_classification_loss_matches_jax(case):
    """The loss on seeded logits (6, 5) and labels: within 1e-6 absolute and
    relative of the JAX loss."""
    jfn, pfn, args, kw = _loss_cases()[case]
    want = float(jfn(*(jnp.asarray(a) for a in args),
                     **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                        for k, v in kw.items()}))
    got = pfn(*_t(*args), **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.item() == pytest.approx(want, rel=1e-6, abs=1e-6)


# --------------------------------------------------------- forward_test

# (task, inputs with a doubled and a missing [MASK])
FORWARD_CASES = {"mc_cls": ("mc_cls", False), "oe_cls": ("oe_cls", False),
                 "oe_cls_scaled": ("oe_cls_scaled", False),
                 "fib_mask": ("fib_mask", False), "fib_mask edge": ("fib_mask", True),
                 "cls_itm": ("cls_itm", False), "mc_cls_itm": ("mc_cls_itm", False),
                 "itm": ("itm", False)}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_test_matches_jax(trees, case):
    """forward_test's (V, num_choices) scores against the JAX forward_test:
    MC (3 candidates, each video's tokens repeated per candidate), OE (6
    answers; with scale_pixels the clips divided by 255 first), FIB's [MASK] readout (with ``edge``: the first of two, and
    row position 0 where there is none), answer_cls through the ITM head
    (its P(match) column, or the MC head on its 2 logits), the default ITM
    readout."""
    task, edge = FORWARD_CASES[case]
    imgs, tok, mask, _ = qa_inputs(task, seed=4, edge=edge)
    params = trees(task)
    jm = jax_model(task)
    want = np.asarray(jax.jit(lambda p, *a: jm.apply(p, *a, method="forward_test"))(
        params, imgs, tok, mask))
    pm = port_model(task)
    load_jax_params(pm, params)
    with torch.inference_mode():
        got = pm.eval().forward_test(*_t(imgs, tok, mask))
    cfg = pm.config
    assert got.shape == want.shape == (len(imgs), cfg.num_labels if cfg.qa_head == "oe"
                                       else tok.shape[1])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -------------------------------------------------- bridge and decay mask

@pytest.mark.parametrize("task", sorted(TASKS))
def test_every_task_tree_loads_exactly(trees, task):
    """CloverFinetune builds every task of the JAX model, and its tree loads
    with no leaf missing or left over (load_jax_params raises otherwise),
    every tensor equal to its leaf."""
    params = trees(task)
    pm = port_model(task)
    load_jax_params(pm, params)
    want = state_from_jax(params)
    assert set(want) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name], err_msg=name)
    qa = TASKS[task]["task"] != "retrieval"
    assert hasattr(pm, "multimodal_backbone") == (qa or TASKS[task].get("use_itm_head", False))
    assert not hasattr(pm, "ssl_head") == qa
    assert not hasattr(pm.__dict__.get("multimodal_backbone", pm), "embeddings")


@pytest.mark.parametrize("task", sorted(TASKS))
def test_weight_decay_mask_matches_jax(trees, task):
    """The decay mask on each parameter's JAX leaf path equals the JAX mask
    on the task's tree, the new heads included."""
    params = trees(task)["params"]
    pm = port_model(task)
    want = {k: bool(v) for k, v in state_from_jax(jweight_decay_mask(params)).items()}
    got = weight_decay_mask(pm)
    assert got == want
    for head in ("itm_head", "qa_head"):
        if hasattr(pm, head):
            assert got[f"{head}.fc1.weight"] and not got[f"{head}.fc1.bias"]


def test_readout_width_follows_the_readout():
    """The QA head takes the fusion width, or the ITM head's 2 logits where
    the readout goes through it (flax infers this from the input)."""
    widths = {task: FinetuneConfig(**kw).readout_width for task, kw in TASKS.items()}
    assert widths["mc_cls"] == widths["oe_cls"] == widths["fib_mask"] == 768
    assert widths["oe_cls_scaled"] == 768
    assert widths["mc_cls_itm"] == widths["cls_itm"] == widths["itm"] == 2
    with pytest.raises(ValueError):
        FinetuneConfig(task="vqa")
    with pytest.raises(ValueError):
        FinetuneConfig(task="video_qa", qa_head="open")


# ------------------------------------------------------------- train step

@pytest.fixture(scope="module")
def qa_train_run(trees):
    """The JAX MC finetune (heads without dropout): 3 steps of the jitted
    make_qa_train_step with make_optimizer (warmup 2, clip 1.0), the state
    after each."""
    task = "mc_cls"
    params = trees(task)["params"]
    batches = [dict(zip(("imgs", "token_ids", "input_mask", "label"), qa_inputs(task, seed=s)))
               for s in (10, 11, 12)]
    with jax_heads_without_dropout():
        jm = jax_model(task)
        tx, _ = jmake_optimizer(params, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
        state = JTrainState.create(params, tx)
        step = jax.jit(jmake_qa_train_step(jm, jit=False, grad_clip_norm=CLIP))
        history = []
        for b in batches:
            state, metrics = step(state, b, jax.random.PRNGKey(0))
            history.append(jax.device_get((metrics, state.params)))
    return dict(params=params, batches=batches, history=history)


def test_three_qa_train_steps_match_jax(qa_train_run):
    """make_qa_train_step on the port (the MC task, dropouts 0) from the
    same weights and batches: qa_loss, loss and grad_norm within 2e-5
    relative at each step (the clip fires), the parameters after 3 steps
    within 2e-5 absolute (those with a zero exact gradient aside: the
    attention key biases and the MC head's output bias, a shift shared by a
    video's candidates, which their softmax does not see)."""
    history = qa_train_run["history"]
    assert max(float(h[0]["grad_norm"]) for h in history) > CLIP, "the clip never fired"
    pm = port_model_without_dropout("mc_cls")
    load_jax_params(pm, {"params": qa_train_run["params"]})
    optimizer, schedule = make_optimizer(pm, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
    state = TrainState.create(pm, optimizer, schedule)
    step = make_qa_train_step(pm, grad_clip_norm=CLIP)
    for b, (want, _) in zip(qa_train_run["batches"], history):
        batch = dict(zip(b, _t(*b.values())))
        state, metrics = step(state, batch, torch.Generator().manual_seed(0))
        assert set(metrics) == {"qa_loss", "loss", "grad_norm"}
        for k in metrics:
            assert metrics[k].item() == pytest.approx(float(want[k]), rel=2e-5), k
    assert state.step == 3
    _assert_params_close(pm, history[-1][1], 2e-5, "after 3 QA steps",
                         zero=("qa_head.fc2.bias",))
