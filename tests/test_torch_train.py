"""The port's retrieval-finetune train step held against the JAX package on
the CPU.

The tiny configuration of test_torch_bridge.tiny_models with DropPath and
the BERT dropouts at 0, so that a step is deterministic; one set of seeded
weights through the bridge; the same seeded uint8 clips and token ids; fp32.
The JAX side runs under ``jax.jit``: ``jax.value_and_grad`` of the
retrieval loss, and ``make_retrieval_train_step`` with ``make_optimizer``
(warmup, and a clip small enough to fire). Each test states its tolerance
and the gap observed when it was written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clover_tpu.engine import TrainState as JTrainState
from clover_tpu.engine import make_optimizer as jmake_optimizer
from clover_tpu.engine import weight_decay_mask as jweight_decay_mask
from clover_tpu.engine.optim import cosine_warmup_schedule as jcosine
from clover_tpu.engine.optim import linear_annealing_schedule as jlinear
from clover_tpu.engine.steps import ema_momentum_schedule as jema_schedule
from clover_tpu.engine.steps import make_retrieval_train_step as jmake_step
from clover_tpu.losses.contrastive import norm_softmax_loss as jnorm_softmax_loss
from clover_tpu.losses.objectives import retrieval_loss as jretrieval_loss
from clover_tpu.models import BertConfig as JBertConfig
from clover_tpu.models import CloverFinetune as JCloverFinetune
from clover_tpu.models import FinetuneConfig as JFinetuneConfig
from clover_tpu.models import SwinConfig as JSwinConfig
from clover_tpu_torch.engine import TrainState, ema_momentum_schedule, make_optimizer
from clover_tpu_torch.engine import (make_embed_eval_step, make_retrieval_train_step,
                                     weight_decay_mask)
from clover_tpu_torch.engine.optim import cosine_warmup_schedule, linear_annealing_schedule
from clover_tpu_torch.losses import norm_softmax_loss, retrieval_loss, total_loss
from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig, SwinConfig,
                                     load_jax_params, opt_state_from_jax, state_from_jax)
from clover_tpu_torch.models import swin3d as pswin
from clover_tpu_torch.models.bridge import jax_leaf_paths
from clover_tpu_torch.ops import library
from test_torch_bridge import BERT, SWIN, random_jax_params, tiny_inputs

LR, TOTAL, WARMUP, CLIP = 1e-3, 20, 2, 1.0   # the 3-step runs' optimizer and clip


def tiny_train_models():
    """(JAX model, port model) of the tiny configuration with no dropout."""
    jcfg = JFinetuneConfig(
        swin=JSwinConfig(embed_impl="host_s2d", drop_path_rate=0.0, **SWIN),
        text_bert=JBertConfig(hidden_dropout=0.0, attention_dropout=0.0, **BERT),
        task="retrieval")
    pcfg = FinetuneConfig(swin=SwinConfig(drop_path_rate=0.0, **SWIN),
                          text_bert=BertConfig(hidden_dropout=0.0, attention_dropout=0.0, **BERT))
    return JCloverFinetune(jcfg, dtype=jnp.float32), CloverFinetune(pcfg, device="cpu")


def _batch(seed, n_clips=1):
    imgs, tok, mask = tiny_inputs(seed)
    if n_clips > 1:
        imgs = np.concatenate([imgs, imgs[:, :, ::-1]], axis=1)[:, :n_clips]
    return {"imgs": np.ascontiguousarray(imgs), "token_ids": tok, "input_mask": mask}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _port_model(jax_params):
    _, pm = tiny_train_models()
    load_jax_params(pm, jax_params)
    return pm


@pytest.fixture(scope="module")
def train_run():
    """The JAX reference: the weights, the loss and gradient of batch 0, and
    3 optimizer steps (state after each, numpy)."""
    jm, _ = tiny_train_models()
    batches = [_batch(s) for s in range(3)]
    params = random_jax_params(jm, *tiny_inputs(0))["params"]
    key = jax.random.PRNGKey(0)

    def loss_fn(p, batch):
        v, t = jm.apply({"params": p}, batch, train=True, rngs={"dropout": key})
        return jretrieval_loss(v, t, temperature=0.05, cos_sim=True)["retrieval_nce_loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batches[0])
    tx, _ = jmake_optimizer(params, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
    state = JTrainState.create(params, tx)
    step = jax.jit(jmake_step(jm, jit=False, grad_clip_norm=CLIP))
    history = []
    for b in batches:
        state, metrics = step(state, b, key)
        history.append(jax.device_get((metrics, state.params, state.opt_state)))
    return dict(jm=jm, params=jax.device_get(params), batches=batches, loss=float(loss),
                grads=jax.device_get(grads), history=history)


def _key_bias(name, n):
    """Mask of the attention key-bias entries of parameter ``name`` (n
    values): their gradient is zero in exact arithmetic, since softmax does
    not see q.b_k, a shift shared by a query's logits."""
    mask = np.zeros(n, bool)
    if name.endswith("attention.key.bias"):
        mask[:] = True
    elif name.endswith("attn.qkv.bias"):
        mask[n // 3:2 * n // 3] = True
    return mask


def _assert_params_close(pm, jax_params, atol, what, zero=()):
    """Every parameter within atol of the JAX one, except the attention key
    biases and the tensors named in ``zero``, whose gradient is zero in
    exact arithmetic: Adam normalises their fp32-noise gradients (|g|
    ~1e-9) into updates of order lr on both sides, so those are held to 3
    lr."""
    want = state_from_jax(jax_params)
    for name, p in pm.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name]).reshape(-1)
        noise = _key_bias(name, diff.size) | (name in zero)
        err = float(diff[~noise].max()) if (~noise).any() else 0.0
        assert err <= atol, f"{what}: {name} differs by {err}"
        assert not noise.any() or diff[noise].max() <= 3 * LR, f"{what}: {name} key bias"


def test_one_step_loss_and_gradients_match_jax(train_run):
    """forward_train + the retrieval loss + backward in train() mode against
    jax.value_and_grad of the JAX retrieval loss: loss and global gradient
    norm within 1e-5 relative, each parameter's gradient within
    2e-4 * max|its JAX gradient| + 1e-7 (fp32 summation order over 8 Swin
    blocks and 2 BERT layers); observed: loss and norm 3e-7, worst
    gradient 1.4e-5 of its max."""
    pm = _port_model(train_run["params"])
    pm.train()
    v, t = pm.forward_train(_torch_batch(train_run["batches"][0]), torch.Generator())
    loss = total_loss(retrieval_loss(v, t, temperature=0.05, cos_sim=True))
    loss.backward()
    assert loss.item() == pytest.approx(train_run["loss"], rel=1e-5)
    want = state_from_jax(train_run["grads"])
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want.values()))
    got_norm = np.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in pm.parameters()))
    assert got_norm == pytest.approx(gnorm, rel=1e-5)
    for name, p in pm.named_parameters():
        w = want[name]
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 2e-4 * np.abs(w).max() + 1e-7, f"{name}: {err} vs max {np.abs(w).max()}"


def test_train_step_after_an_eval_step(train_run):
    """The shift permutations and region ids are cached per shape; here the
    eval step (inference mode) makes them first. A train step on the same
    shapes must still save them for its backward: the loss within 1e-5
    relative of JAX's, as in the test above, and every parameter a gradient."""
    pswin._device_constant.cache_clear()
    pm = _port_model(train_run["params"])
    batch = _torch_batch(train_run["batches"][0])
    make_embed_eval_step(pm.eval())(batch["imgs"], batch["token_ids"], batch["input_mask"])
    pm.train()
    v, t = pm.forward_train(batch, torch.Generator())
    loss = total_loss(retrieval_loss(v, t, temperature=0.05, cos_sim=True))
    loss.backward()
    assert loss.item() == pytest.approx(train_run["loss"], rel=1e-5)
    for name, p in pm.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


@pytest.mark.parametrize("n_clips", [1, 2])
def test_forward_train_matches_jax(train_run, n_clips):
    """forward_train's embeddings (clip features mean-pooled over n_clips)
    against the JAX forward_train with train=True. Tolerance 1e-4 absolute
    and relative; observed 3.1e-6."""
    jm, batch = train_run["jm"], _batch(5, n_clips)
    want = jax.jit(lambda p, b: jm.apply({"params": p}, b, train=True))(
        train_run["params"], batch)
    pm = _port_model(train_run["params"]).train()
    with torch.no_grad():
        got = pm.forward_train(_torch_batch(batch), torch.Generator())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_three_train_steps_match_jax(train_run):
    """3 steps of make_retrieval_train_step (AdamW, warmup, clip at 1.0)
    against the JAX step + make_optimizer: per step the loss and grad_norm
    within 1e-4 relative (observed 1.9e-5, from torch's fp32 norm on the
    CPU), and the parameters after 3 steps
    within 1e-5 absolute, 1% of the largest single update lr = 1e-3
    (observed 4.5e-6), the attention key biases aside (_assert_params_close)."""
    history = train_run["history"]
    assert max(float(h[0]["grad_norm"]) for h in history) > CLIP, "the clip never fired"
    pm = _port_model(train_run["params"])
    optimizer, schedule = make_optimizer(pm, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
    state = TrainState.create(pm, optimizer, schedule)
    step = make_retrieval_train_step(pm, grad_clip_norm=CLIP)
    for b, (want, _, _) in zip(train_run["batches"], history):
        state, metrics = step(state, _torch_batch(b), torch.Generator().manual_seed(0))
        for k in ("retrieval_nce_loss", "loss", "grad_norm"):
            assert metrics[k].item() == pytest.approx(float(want[k]), rel=1e-4), k
    assert state.step == 3
    _assert_params_close(pm, history[-1][1], 1e-5, "after 3 steps")


def test_optimizer_state_bridge_resumes_a_jax_run(train_run):
    """The JAX state after 2 steps (params, AdamW count/mu/nu) carried into
    the port, then the port's step 3 against JAX's step 3: parameters within
    1e-5 absolute as in test_three_train_steps_match_jax."""
    history = train_run["history"]
    pm = _port_model(history[1][1])
    optimizer, schedule = make_optimizer(pm, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
    count = opt_state_from_jax(history[1][2], pm, optimizer)
    assert count == 2
    state = TrainState(pm, optimizer, schedule, step=count)
    step = make_retrieval_train_step(pm, grad_clip_norm=CLIP)
    step(state, _torch_batch(train_run["batches"][2]), torch.Generator())
    _assert_params_close(pm, history[2][1], 1e-5, "resumed step 3")


def test_weight_decay_mask_matches_jax(train_run):
    """The decay mask decided on each parameter's JAX leaf path equals the
    JAX mask leaf for leaf, and every path names a leaf of the JAX tree."""
    params = train_run["params"]
    pm = _port_model(params)
    for name, path in jax_leaf_paths(pm).items():
        leaf = params
        for k in path:
            leaf = leaf[k]
        assert leaf.shape == tuple(dict(pm.named_parameters())[name].shape[::-1]) or \
            np.prod(leaf.shape) == dict(pm.named_parameters())[name].numel(), name
    want = {k: bool(v) for k, v in state_from_jax(jweight_decay_mask(params)).items()}
    got = weight_decay_mask(pm)
    assert got == want
    assert not got["backbone.stage_0_block_0.attn.relative_position_bias_table"]
    assert not got["text_backbone.embeddings.word_embeddings.weight"]
    assert not got["backbone.stage_0_block_0.norm1.weight"]
    assert got["backbone.stage_0_block_0.mlp.fc1.weight"]


@pytest.mark.parametrize("policy", ["cosine", "linear"])
def test_schedules_match_optax(policy):
    """The lr schedules against the JAX package's optax schedules at steps
    0..20 (warmup 5 of 12 total steps, so both joins and the end are
    crossed). Tolerance 1e-6 of base_lr: optax computes in fp32, and its
    warmup (init - end) * frac + end loses ~1e-12 to cancellation (observed
    7.8e-13 at step 0)."""
    jfn, pfn = {"cosine": (jcosine, cosine_warmup_schedule),
                "linear": (jlinear, linear_annealing_schedule)}[policy]
    base = 1.2e-5
    want, got = jfn(base, 12, 5, 0.001, 0.1), pfn(base, 12, 5, 0.001, 0.1)
    for count in range(21):
        assert got(count) == pytest.approx(float(want(count)), rel=0, abs=1e-6 * base), count


@pytest.mark.parametrize("cos_sim", [True, False])
def test_norm_softmax_loss_value_and_gradient_match_jax(cos_sim):
    """norm_softmax_loss and its gradient against the JAX loss, fp32.
    Tolerance 1e-5 relative (observed 1.1e-7; gradients 3.6e-7)."""
    rng = np.random.default_rng(40)
    v, t = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    want, (jgv, jgt) = jax.value_and_grad(
        lambda a, b: jnorm_softmax_loss(a, b, temperature=0.05, cos_sim=cos_sim), (0, 1))(v, t)
    tv, tt = torch.tensor(v, requires_grad=True), torch.tensor(t, requires_grad=True)
    loss = norm_softmax_loss(tv, tt, temperature=0.05, cos_sim=cos_sim)
    loss.backward()
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), rtol=1e-5, atol=1e-6)


def test_ema_update_matches_jax():
    """TrainState's EMA update e * m + p * (1 - m) on the updated
    parameters, against the JAX TrainState.apply_gradients (SGD at lr 0.1,
    momentum 0.9). Tolerance 1e-6."""
    rng = np.random.default_rng(41)
    w, e, g = (rng.normal(size=(3, 4)).astype(np.float32) for _ in range(3))
    jstate = JTrainState.create({"w": jnp.asarray(w)}, optax.sgd(0.1), ema_params={"w": e})
    want = jstate.apply_gradients({"w": jnp.asarray(g)}, ema_momentum=0.9).ema_params["w"]
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.tensor(w))
    state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=0.1),
                              lambda count: 0.1, ema=True)
    state.ema_params["w"].copy_(torch.tensor(e))
    model.w.grad = torch.tensor(g)
    state.apply_gradients(ema_momentum=0.9)
    np.testing.assert_allclose(state.ema_params["w"].numpy(), np.asarray(want), atol=1e-6)
    assert state.step == 1


@pytest.mark.parametrize("kind", ["constant", "exp", "linear"])
def test_ema_momentum_schedule_matches_jax(kind):
    want, got = jema_schedule(kind, 0.999, 100), ema_momentum_schedule(kind, 0.999, 100)
    for step in (0, 1, 50, 1000):
        assert got(step) == pytest.approx(float(want(jnp.int32(step))), rel=1e-6)


def test_train_mode_routes_through_the_autograd_functions(train_run, monkeypatch):
    """In train() mode every Swin block's attention goes through
    WindowAttentionFn and its MLP half through FusedLnMlpResidualFn; no
    registered op (``torch.ops.clover.*``) is called, so neither the
    LayerNorm (K4) nor the BERT FFN (K3). In eval mode neither autograd
    Function is called: every kernel site goes through its op (K1, K2, K3,
    K4)."""
    calls = {"attn": 0, "mlp": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    class Attn(pswin.WindowAttentionFn):
        apply = staticmethod(counting("attn", pswin.WindowAttentionFn.apply))

    class Mlp(pswin.FusedLnMlpResidualFn):
        apply = staticmethod(counting("mlp", pswin.FusedLnMlpResidualFn.apply))

    monkeypatch.setattr(pswin, "WindowAttentionFn", Attn)
    monkeypatch.setattr(pswin, "FusedLnMlpResidualFn", Mlp)
    pm = _port_model(train_run["params"]).train()
    batch = _torch_batch(train_run["batches"][0])
    library.reset_call_counts()
    pm.forward_train(batch, torch.Generator())
    assert calls == {"attn": 8, "mlp": 8}
    assert not any(library.call_counts().values())
    with torch.no_grad():
        pm.eval().forward_test(batch["imgs"], batch["token_ids"], batch["input_mask"])
    assert calls == {"attn": 8, "mlp": 8}
    ops = {k: n for k, n in library.call_counts().items() if n}
    assert ops == {"k1_window_attention": 8, "k2_ln_mlp_residual": 8, "k3_mlp_postln": 2,
                   "k4_layer_norm": 1 + 8 + 3 + 1 + 3}


def test_dropout_in_training_needs_a_generator(train_run):
    """With the published dropout rates, train() mode draws from the given
    generator (same seed, same output; another seed, another output) and
    refuses to run without one."""
    pm = tiny_model_with_dropout()
    load_jax_params(pm, train_run["params"])
    pm.train()
    batch = _torch_batch(train_run["batches"][0])
    with torch.no_grad():
        a = pm.forward_train(batch, torch.Generator().manual_seed(1))[0]
        b = pm.forward_train(batch, torch.Generator().manual_seed(1))[0]
        c = pm.forward_train(batch, torch.Generator().manual_seed(2))[0]
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError):
            pm.forward_train(batch, None)


def tiny_model_with_dropout():
    """The tiny port model with DropPath 0.1 and the BERT dropouts at 0.1."""
    pcfg = FinetuneConfig(swin=SwinConfig(drop_path_rate=0.1, **SWIN),
                          text_bert=BertConfig(**BERT))
    return CloverFinetune(pcfg, device="cpu")
