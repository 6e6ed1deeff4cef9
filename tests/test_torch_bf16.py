"""The port's bf16 path held against the JAX package's bf16 path on the CPU.

Every other CPU parity test runs fp32; on the card the kernels are held
against their plain versions only. Here both packages run the tiny slice of
test_torch_bridge (the retrieval-eval forward) and one step of the tiny
finetune of test_torch_train (DropPath and dropout at 0) in bf16 compute
with fp32 parameters, from one set of seeded weights, and in fp32 as each
one's own control. The bf16 roundings fall at other places in the two
frameworks, so the limits are statistical, set from a measurement of this
configuration:

- eval embeddings: max |bf16 - other| <= 0.06 (read 0.031 port against
  JAX, 0.036 and 0.036 each against its fp32) and min per-row cosine
  >= 0.9999 (read 0.99996, 0.99995, 0.99996);
- train gradients: loss within 2e-2 relative (read 9.0e-4, 1.0e-3,
  1.2e-4) and per-tensor cosine >= 0.995 (read 0.9973 port against JAX,
  0.9979 JAX against its fp32, 0.9983 port against its fp32: the
  attention-output biases of the first Swin blocks and the text head's
  last bias are the lowest), the
  attention key biases left out (zero in exact arithmetic, rounding noise on
  both sides), and the patch embed's weight and bias left out wherever the
  JAX bf16 run takes part: their bf16 gradients on XLA-CPU lose the
  pixel-scale fold (W / std, b - sum(W mean / std)) to cancellation
  (cosines 0.685 and 0.969 against its own fp32 run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clover_tpu.losses.objectives import retrieval_loss as jretrieval_loss
from clover_tpu.models import CloverFinetune as JCloverFinetune
from clover_tpu_torch.losses import retrieval_loss, total_loss
from clover_tpu_torch.models import CloverFinetune, load_jax_params, state_from_jax
from test_torch_bridge import random_jax_params, tiny_inputs, tiny_models
from test_torch_train import _batch, _key_bias, _torch_batch, tiny_train_models

EMB_MAX_ABS, EMB_COS_MIN, GRAD_COS_MIN = 0.06, 0.9999, 0.995
FOLDED = ("backbone.patch_embed.proj.weight", "backbone.patch_embed.proj.bias")


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)))
                 .min())


@pytest.fixture(scope="module")
def eval_run():
    """forward_test's (video, text) embeddings of the tiny slice from one
    tree: {(package, dtype): (v, t)} as fp32 numpy."""
    jm32, pm32 = tiny_models()
    imgs, tok, mask = tiny_inputs()
    params = random_jax_params(jm32, imgs, tok, mask)
    out = {}
    for name, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm = JCloverFinetune(jm32.config, dtype=jdt)
        v, t = jax.jit(lambda p, *a, jm=jm: jm.apply(p, *a, method="forward_test"))(
            params, *map(jnp.asarray, (imgs, tok, mask)))
        out["jax", name] = (np.asarray(v, np.float32), np.asarray(t, np.float32))
        pm = CloverFinetune(pm32.config, dtype=tdt, device="cpu")
        load_jax_params(pm, params)
        with torch.inference_mode():
            pv, pt = pm.eval().forward_test(*(torch.from_numpy(a) for a in (imgs, tok, mask)))
        out["port", name] = (pv.float().numpy(), pt.float().numpy())
    return out


def _assert_embeddings_close(got, want):
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= EMB_MAX_ABS, np.abs(g - w).max()
        assert _cos_rows(g, w) >= EMB_COS_MIN, _cos_rows(g, w)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_bf16_eval_embeddings_against_own_fp32(eval_run, package):
    """Each package's bf16 embeddings against its own fp32 run."""
    assert eval_run[package, "bf16"][0].dtype == np.float32
    _assert_embeddings_close(eval_run[package, "bf16"], eval_run[package, "fp32"])


def test_bf16_eval_embeddings_port_against_jax(eval_run):
    """The port's bf16 embeddings against the JAX package's bf16 ones."""
    _assert_embeddings_close(eval_run["port", "bf16"], eval_run["jax", "bf16"])


@pytest.fixture(scope="module")
def train_run():
    """Batch 0's retrieval loss and gradients of the tiny finetune from one
    tree: {(package, dtype): (loss, {name: grad})}, gradients fp32 numpy."""
    jm32, pm32 = tiny_train_models()
    params = random_jax_params(jm32, *tiny_inputs(0))["params"]
    batch = _batch(0)
    key = jax.random.PRNGKey(0)
    out = {}
    for name, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm = JCloverFinetune(jm32.config, dtype=jdt)

        def loss_fn(p, b, jm=jm):
            v, t = jm.apply({"params": p}, b, train=True, rngs={"dropout": key})
            return jretrieval_loss(v, t, temperature=0.05, cos_sim=True)["retrieval_nce_loss"]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
        out["jax", name] = (float(loss), {k: np.asarray(v, np.float32)
                                          for k, v in state_from_jax(grads).items()})
        pm = CloverFinetune(pm32.config, dtype=tdt, device="cpu")
        load_jax_params(pm, params)
        v, t = pm.train().forward_train(_torch_batch(batch), torch.Generator())
        ploss = total_loss(retrieval_loss(v, t, temperature=0.05, cos_sim=True))
        ploss.backward()
        out["port", name] = (ploss.item(), {n: p.grad.float().numpy()
                                            for n, p in pm.named_parameters()})
    return out


def _assert_grads_close(got, want, skip=()):
    (loss, grads), (wloss, wgrads) = got, want
    assert loss == pytest.approx(wloss, rel=2e-2)
    assert set(grads) == set(wgrads)
    worst = []
    for name, g in grads.items():
        if name in skip:
            continue
        keep = ~_key_bias(name, g.size)
        a, b = g.reshape(-1)[keep].astype(np.float64), wgrads[name].reshape(-1)[keep]
        if a.size == 0 or not np.any(b):
            continue
        worst.append((float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))), name))
    assert len(worst) > 100 and min(worst)[0] >= GRAD_COS_MIN, sorted(worst)[:3]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_bf16_train_gradients_against_own_fp32(train_run, package):
    """Each package's bf16 loss (within 2e-2 relative) and gradients
    against its own fp32 run (the JAX one without the folded patch embed)."""
    _assert_grads_close(train_run[package, "bf16"], train_run[package, "fp32"],
                        skip=FOLDED if package == "jax" else ())


def test_bf16_train_gradients_port_against_jax(train_run):
    """The port's bf16 loss and gradients against the JAX package's bf16
    ones, every leaf but the folded patch embed's weight and bias."""
    _assert_grads_close(train_run["port", "bf16"], train_run["jax", "bf16"], skip=FOLDED)
