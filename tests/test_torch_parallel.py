"""The port's data-parallel collectives, sharded losses, BatchNorm and eval
gather (``clover_tpu_torch/parallel/``, ``losses/``, ``models/layers.py``,
``engine/eval_loop.py``) on two gloo ranks, held against the JAX package.

One pair of CPU processes (``torch.distributed`` over gloo, one intra-op
thread each, 120 s each) computes every case in a module-scoped fixture;
each rank holds its rows of a seeded global batch (rank r the r-th
contiguous slice). The JAX side runs here: under ``jax.shard_map`` on 2 of
the 8 virtual CPU devices of ``tests/conftest.py``, or single-device on the
global batch. fp32 throughout; each test states its tolerance.

- ``all_gather_with_grad`` against JAX's tiled ``all_gather``: the rows and
  the gradient each rank gets back (the reduce-scatter);
- ``norm_softmax_loss_sharded`` against the JAX one under ``shard_map``
  (value, the summed parameter gradients), and the ragged
  ``norm_softmax_loss_sharded_varied`` (3 and 5 rows) against JAX's and
  against the compact single-device loss;
- ``exclusive_nce_with_ranking``, ``masked_lm_focal_loss`` (unequal masked
  counts) and ``cross_entropy`` over the group against the JAX losses on the
  global batch;
- ``BatchNorm`` (the ``use_ln=False`` projector) in training against flax's
  on the global batch: output, running statistics, gradients;
- ``_host_gather`` with ragged counts and a cross-rank duplicate, and the
  train entry's eval at 2 ranks (retrieval, ITM, QA) against one process;
- a SIGTERM on one rank, agreed on by both at the step's end (``Trainer``);
- the world-1 identity: no copy, bitwise (in this process, a one-rank group).
"""

import functools
import os
import pickle
import signal
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

from clover_tpu.losses import classification as jcls
from clover_tpu.losses import contrastive as jcon
from clover_tpu.models.layers import ProjectorNorm as JProjectorNorm
from clover_tpu.parallel import all_gather_with_grad as jall_gather_with_grad
from clover_tpu_torch.losses import (cross_entropy, exclusive_nce_with_ranking,
                                     masked_lm_focal_loss, norm_softmax_loss)
from clover_tpu_torch.losses.contrastive import (norm_softmax_loss_sharded,
                                                 norm_softmax_loss_sharded_varied)
from clover_tpu_torch.models.layers import ProjectorNorm
from clover_tpu_torch.parallel import collectives

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
WORLD, B, D = 2, 8, 8           # ranks, global rows, embedding width
RAGGED = (3, 5)                 # the varied case's real rows per rank
TOL = dict(rtol=1e-6, atol=1e-6)
EVALS = {"retrieval": ("debug_retrieval_synthetic.py", ["data.val.n_videos=7"]),
         "itm_retrieval": ("debug_retrieval_synthetic.py",
                           ["data.val.n_videos=7", "model.eval_mode=itm_retrieval",
                            "model.use_itm_head=True"]),
         "qa": ("debug_qa_synthetic.py", [])}


# ---------------------------------------------------------------- the pair

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_pair(code: str, out_dir, args=()):
    """Python ``code`` in 2 fresh processes (one intra-op thread each) that
    form a gloo group; ``sys.argv[1:4]`` are its rank, the group's port and
    the path it pickles its results to, then ``args``. -> the running
    processes and their result paths, for ``finish_pair``."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    outs = [os.path.join(str(out_dir), f"rank{r}.pkl") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), outs[r],
                               *map(str, args)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    return procs, outs


def finish_pair(pair, timeout: int = 120):
    """Wait for ``start_pair``'s processes (``timeout`` s each); raise with
    the log of a rank that failed. -> the 2 results, rank order."""
    procs, outs = pair
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def run_pair(module: str, fn: str, out_dir):
    """``module.fn(rank, port, out_path)`` on 2 ranks (``start_pair``). ->
    the 2 results."""
    code = (f"import sys, torch; sys.path.insert(0, {TESTS!r}); torch.set_num_threads(1); "
            f"import {module} as m; m.{fn}(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])")
    return finish_pair(start_pair(code, out_dir))


def join_group(rank: int, port: int):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    return dist.group.WORLD


# ---------------------------------------------------------------- inputs

def _rng(seed):
    return np.random.default_rng(seed)


def _rows(a, rank, n=B // WORLD):
    return a[rank * n:(rank + 1) * n]


def gather_inputs():
    return _rng(10).normal(size=(B, 3)).astype(np.float32), \
        _rng(11).normal(size=(WORLD, B, 3)).astype(np.float32)


def nce_inputs():
    rng = _rng(12)
    v, t = (rng.normal(size=(B, D)).astype(np.float32) for _ in range(2))
    w = {k: (rng.normal(size=(D, D)) * 0.3).astype(np.float32) for k in ("wv", "wt")}
    return v, t, w


def varied_inputs():
    rng = _rng(13)
    n = max(RAGGED)
    v, t = (rng.normal(size=(WORLD * n, D)).astype(np.float32) for _ in range(2))
    w = {k: (rng.normal(size=(D, D)) * 0.3).astype(np.float32) for k in ("wv", "wt")}
    valid = (np.arange(n)[None, :] < np.asarray(RAGGED)[:, None]).reshape(-1)
    return v, t, w, valid


def exclusive_inputs():
    rng = _rng(14)
    return [rng.normal(size=(B, 16)).astype(np.float32) for _ in range(4)]


def mlm_inputs():
    """(B, 6, 11) logits and labels: rank 0's rows hold 5 masked tokens,
    rank 1's 2."""
    rng = _rng(15)
    logits = (rng.normal(size=(B, 6, 11)) * 2).astype(np.float32)
    labels = np.full((B, 6), -100, np.int64)
    for row, col in [(0, 1), (0, 4), (1, 2), (2, 0), (3, 5), (5, 3), (6, 1)]:
        labels[row, col] = rng.integers(0, 11)
    return logits, labels


def ce_inputs():
    rng = _rng(16)
    logits = (rng.normal(size=(B, 5)) * 2).astype(np.float32)
    labels = rng.integers(0, 5, size=B)
    soft = rng.random((B, 5)).astype(np.float32)
    return logits, labels, soft / soft.sum(-1, keepdims=True), \
        rng.random(5).astype(np.float32) + 0.5


def bn_inputs():
    rng = _rng(17)
    x = (rng.normal(size=(B, 12)) * 2 + 1).astype(np.float32)
    cot = rng.normal(size=(B, 12)).astype(np.float32)
    return x, cot, {"scale": (1 + 0.1 * rng.normal(size=12)).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=12)).astype(np.float32)}


CE_FORMS = ("hard", "weighted", "soft")


def _ce(fn, logits, labels, soft, weight, form):
    """``fn`` (a cross_entropy) in the CE_FORMS ``form``."""
    if form == "hard":
        return fn(logits, labels)
    if form == "weighted":
        return fn(logits, labels, class_weight=weight)
    return fn(logits, soft)


# ---------------------------------------------------------------- rank side

def _leaf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()


def _eval_metrics(case, group, rank=0, world=1):
    """The train entry's eval of ``EVALS[case]`` on a seeded model, this
    rank's shard of the val set (``build_eval_fn``)."""
    from clover_tpu_torch.builder import (build_dataset, build_loader, build_model,
                                          build_tokenizer)
    from clover_tpu_torch.config import load_config, parse_cfg_options
    from clover_tpu_torch.models import init_params
    from clover_tpu_torch.tools.train import build_eval_fn

    name, opts = EVALS[case]
    cfg = load_config(os.path.join(ROOT, "configs", "exp", name),
                      overrides=parse_cfg_options(opts))
    model, _ = build_model(cfg.model, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    # the train entry's tokenizer: the config's, else the train set's
    tok = (build_tokenizer(cfg.tokenizer) if cfg.get("tokenizer")
           else build_dataset(cfg.data.train, None).tokenizer)
    ds = build_dataset(cfg.data.val, tok)
    loader = build_loader(ds, cfg.data.val_loader, test=True, rank=rank, world_size=world)
    return build_eval_fn(cfg, model.eval(), ds, loader, cfg.img_size, group)(model)


def _preempted_run(rank, group, ckpt_dir):
    """The debug retrieval config's Trainer at 2 ranks (2 steps an epoch, 3
    epochs, one checkpoint directory), SIGTERM raised on rank 1 alone inside
    step 3. -> (the exit code, the checkpoint steps, the latest meta)."""
    from clover_tpu_torch.builder import build_dataset, build_loader, build_model
    from clover_tpu_torch.config import load_config
    from clover_tpu_torch.engine import (CheckpointManager, TrainState, Trainer, make_optimizer,
                                         make_retrieval_train_step, to_model_batch)
    from clover_tpu_torch.models import init_params

    cfg = load_config(os.path.join(ROOT, "configs", "exp", "debug_retrieval_synthetic.py"))
    model, _ = build_model(cfg.model, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    state = TrainState.create(model, *make_optimizer(model, base_lr=1e-3, total_steps=10))
    loader = build_loader(build_dataset(cfg.data.train, None), cfg.data.train_loader,
                          rank=rank, world_size=WORLD)
    step = make_retrieval_train_step(model, grad_clip_norm=5.0, group=group)

    def interrupted(state, batch, gen):
        if rank == 1 and state.step == 2:
            signal.raise_signal(signal.SIGTERM)
        return step(state, batch, gen)

    mgr = CheckpointManager(ckpt_dir, group=group)
    trainer = Trainer(state, [interrupted], [loader],
                      lambda li, b: to_model_batch(b, cfg.img_size, torch.float32, "cpu"),
                      torch.Generator().manual_seed(1), 3, ckpt_manager=mgr, group=group)
    code = None
    try:
        trainer.fit()
    except SystemExit as exc:
        code = exc.code
    return code, mgr.all_steps(), mgr.read_meta()


def pair_cases(rank: int, port: int, out: str) -> None:
    """Every case's port-side result on this rank."""
    group = join_group(rank, port)
    res = {}

    x_all, w_all = gather_inputs()
    x = _leaf(_rows(x_all, rank))
    g = collectives.all_gather_with_grad(x, group)
    (g * torch.from_numpy(w_all[rank])).sum().backward()
    res["gather"] = (g.detach().numpy(), x.grad.numpy())
    for name, fn in (("psum", collectives.psum_scalar), ("pmean", collectives.pmean_scalar)):
        x = torch.tensor(float(rank + 1), requires_grad=True)
        y = fn(x * 3.0, group)
        y.backward()
        res[name] = (y.item(), x.grad.item())

    v, t, w = nce_inputs()
    wv, wt, vl, tl = _leaf(w["wv"]), _leaf(w["wt"]), _leaf(_rows(v, rank)), _leaf(_rows(t, rank))
    loss = norm_softmax_loss_sharded(vl @ wv, tl @ wt, group, temperature=0.1)
    loss.backward()
    default, collectives.BUCKET_BYTES = collectives.BUCKET_BYTES, D * D * 4   # 2 buckets
    collectives.all_reduce_grads([wv, wt], group)
    collectives.BUCKET_BYTES = default
    res["nce"] = (loss.item(), wv.grad.numpy(), wt.grad.numpy(), vl.grad.numpy())
    wv, wt = _leaf(w["wv"]), _leaf(w["wt"])
    loss = norm_softmax_loss(_leaf(_rows(v, rank)) @ wv, _leaf(_rows(t, rank)) @ wt,
                             temperature=0.1, cos_sim=False, group=group)
    loss.backward()
    collectives.all_reduce_grads([wv, wt], group)
    res["nce_l2"] = (loss.item(), wv.grad.numpy(), wt.grad.numpy())

    v, t, w, _ = varied_inputs()
    n = max(RAGGED)
    wv, wt = _leaf(w["wv"]), _leaf(w["wt"])
    vl, tl = _leaf(_rows(v, rank, n)), _leaf(_rows(t, rank, n))
    loss = norm_softmax_loss_sharded_varied(vl @ wv, tl @ wt, RAGGED[rank], group,
                                            temperature=0.1)
    loss.backward()
    collectives.all_reduce_grads([wv, wt], group)
    res["varied"] = (loss.item(), wv.grad.numpy(), wt.grad.numpy(), vl.grad.numpy())

    embs = [_leaf(_rows(e, rank)) for e in exclusive_inputs()]
    got = exclusive_nce_with_ranking(*embs, temperature=0.05, margin_ttm=5.0, group=group)
    sum(got.values()).backward()
    res["exclusive"] = ({k: v.item() for k, v in got.items()}, [e.grad.numpy() for e in embs])

    logits, labels = mlm_inputs()
    for gamma in (2.0, 0.0):
        lg = _leaf(_rows(logits, rank))
        loss = masked_lm_focal_loss(lg, torch.from_numpy(_rows(labels, rank)), gamma, group)
        loss.backward()
        res["mlm", gamma] = (loss.item(), lg.grad.numpy())

    logits, labels, soft, weight = ce_inputs()
    for form in CE_FORMS:
        lg = _leaf(_rows(logits, rank))
        loss = _ce(functools.partial(cross_entropy, group=group), lg,
                   torch.from_numpy(_rows(labels, rank)), torch.from_numpy(_rows(soft, rank)),
                   torch.from_numpy(weight), form)
        loss.backward()
        res["ce", form] = (loss.item(), lg.grad.numpy())

    x, cot, p = bn_inputs()
    norm = ProjectorNorm(12, use_ln=False).train()
    norm.norm.group = group
    with torch.no_grad():
        norm.norm.weight.copy_(torch.from_numpy(p["scale"]))
        norm.norm.bias.copy_(torch.from_numpy(p["bias"]))
    xl = _leaf(_rows(x, rank))
    y = norm(xl)
    (y * torch.from_numpy(_rows(cot, rank))).sum().backward()
    collectives.all_reduce_grads(list(norm.parameters()), group)
    res["bn"] = (y.detach().numpy(), norm.norm.mean.numpy(), norm.norm.var.numpy(),
                 xl.grad.numpy(), norm.norm.weight.grad.numpy(), norm.norm.bias.grad.numpy())

    from clover_tpu_torch.engine.eval_loop import _dedup_sort, _host_gather

    if rank == 0:
        vals, idx, flags = np.array([[0.0], [1.0]]), np.array([0, 1]), np.array([True, False])
    else:
        vals, idx = np.array([[2.0], [0.5], [7.0]]), np.array([2, 0, 3])
        flags = np.array([False, True, True])
    gv, gidx, gflags = _host_gather(vals, idx, flags, group=group)
    res["host_gather"] = (gv, gidx, gflags, _dedup_sort(gidx, gv)[0])

    for case in EVALS:
        res["eval", case] = _eval_metrics(case, group, rank, WORLD)

    res["preempt"] = _preempted_run(rank, group, os.path.join(os.path.dirname(out), "ckpt"))

    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_pair("test_torch_parallel", "pair_cases", tmp_path_factory.mktemp("pair"))


# ---------------------------------------------------------------- JAX side

@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))


def test_all_gather_with_grad_matches_jax(ranks, mesh):
    """Each rank gets every rank's rows in rank order, bitwise, and the
    gradient of sum(gathered * W[rank]) back on its own rows as JAX's tiled
    all_gather transposes it (the rows' cotangents summed over the ranks):
    within 1e-6."""
    x_all, w_all = gather_inputs()

    def local(x, w):
        return jnp.sum(jall_gather_with_grad(x, "data") * w[0])

    fn = jax.shard_map(lambda x, w: jax.lax.psum(local(x, w), "data"), mesh=mesh,
                       in_specs=(P("data"), P("data")), out_specs=P())
    want = np.asarray(jax.grad(fn)(jnp.asarray(x_all), jnp.asarray(w_all)))
    for r, res in enumerate(ranks):
        gathered, grad = res["gather"]
        np.testing.assert_array_equal(gathered, x_all)
        np.testing.assert_allclose(grad, _rows(want, r), **TOL)


@pytest.mark.parametrize("name", ["psum", "pmean"])
def test_psum_and_pmean_count_a_global_value_once(ranks, name):
    """psum_scalar / pmean_scalar of 3 x (rank + 1): the sum 9 (the mean
    4.5) on both ranks, and each rank's gradient its own share's, 3 (1.5):
    the global value's cotangent reaches every rank's term once, as JAX's
    psum / pmean transpose under shard_map."""
    value, grad = {"psum": (9.0, 3.0), "pmean": (4.5, 1.5)}[name]
    assert [res[name] for res in ranks] == [(value, grad)] * WORLD


def test_norm_softmax_loss_sharded_matches_jax(ranks, mesh):
    """norm_softmax_loss_sharded(v @ wv, t @ wt) on each rank's rows, the
    parameter gradients summed by all_reduce_grads (in 2 flat buckets),
    against the JAX norm_softmax_loss_sharded under shard_map: the loss and
    both gradients within 1e-6 on both ranks; each rank's input gradient
    against the single-device JAX loss's on the global batch."""
    v, t, w = nce_inputs()

    def local(p, vl, tl):
        return jcon.norm_softmax_loss_sharded(vl @ p["wv"], tl @ p["wt"], "data",
                                              temperature=0.1)

    fn = jax.shard_map(jax.value_and_grad(local), mesh=mesh,
                       in_specs=(P(), P("data"), P("data")), out_specs=(P(), P()))
    val, grads = jax.jit(fn)(w, jnp.asarray(v), jnp.asarray(t))
    gv = jax.grad(lambda vv: jcon.norm_softmax_loss(vv @ w["wv"], t @ w["wt"], temperature=0.1,
                                                    cos_sim=True))(jnp.asarray(v))
    for r, res in enumerate(ranks):
        loss, g_wv, g_wt, g_v = res["nce"]
        assert loss == pytest.approx(float(val), **{"rel": 1e-6})
        np.testing.assert_allclose(g_wv, np.asarray(grads["wv"]), **TOL)
        np.testing.assert_allclose(g_wt, np.asarray(grads["wt"]), **TOL)
        np.testing.assert_allclose(g_v, _rows(np.asarray(gv), r), **TOL)


def test_norm_softmax_loss_over_a_group_is_the_global_loss(ranks):
    """norm_softmax_loss(..., cos_sim=False, group) (the F.normalize eps)
    on each rank's rows against the JAX single-device loss on the global
    batch: value and summed parameter gradients within 1e-6."""
    v, t, w = nce_inputs()

    def loss(p):
        return jcon.norm_softmax_loss(v @ p["wv"], t @ p["wt"], temperature=0.1)

    val, grads = jax.value_and_grad(loss)(w)
    for res in ranks:
        got, g_wv, g_wt = res["nce_l2"]
        assert got == pytest.approx(float(val), rel=1e-6)
        np.testing.assert_allclose(g_wv, np.asarray(grads["wv"]), **TOL)
        np.testing.assert_allclose(g_wt, np.asarray(grads["wt"]), **TOL)


@pytest.mark.parametrize("against", ["shard_map", "compact"])
def test_norm_softmax_loss_sharded_varied_matches_jax(ranks, mesh, against):
    """Ragged shards (3 and 5 real rows of 5): the padded, masked loss and
    its summed parameter gradients against JAX's
    norm_softmax_loss_sharded_varied under shard_map, and against the JAX
    loss of the 8 real rows on one device: within 1e-6. The padded rows get
    exactly zero input gradient."""
    v, t, w, valid = varied_inputs()
    if against == "shard_map":
        def local(p, vl, tl, n):
            return jcon.norm_softmax_loss_sharded_varied(vl @ p["wv"], tl @ p["wt"], n[0],
                                                         "data", temperature=0.1)

        fn = jax.shard_map(jax.value_and_grad(local), mesh=mesh,
                           in_specs=(P(), P("data"), P("data"), P("data")),
                           out_specs=(P(), P()))
        val, grads = jax.jit(fn)(w, jnp.asarray(v), jnp.asarray(t),
                                 jnp.asarray(RAGGED, jnp.int32))
    else:
        val, grads = jax.value_and_grad(lambda p: jcon.norm_softmax_loss(
            v[valid] @ p["wv"], t[valid] @ p["wt"], temperature=0.1, cos_sim=True))(w)
    n = max(RAGGED)
    for r, res in enumerate(ranks):
        loss, g_wv, g_wt, g_v = res["varied"]
        assert loss == pytest.approx(float(val), rel=1e-6)
        np.testing.assert_allclose(g_wv, np.asarray(grads["wv"]), **TOL)
        np.testing.assert_allclose(g_wt, np.asarray(grads["wt"]), **TOL)
        assert not g_v[RAGGED[r]:].any() and g_v[:RAGGED[r]].any()
        assert g_v.shape == (n, D)


def test_exclusive_nce_with_ranking_over_a_group_matches_jax(ranks):
    """The tri-modal exclusive NCE and the ranking term over the group
    against the JAX loss on the global batch: each value within 1e-6
    relative, each rank's gradient of their sum w.r.t. its rows of the four
    embeddings within 1e-6."""
    embs = exclusive_inputs()
    fn = functools.partial(jcon.exclusive_nce_with_ranking, temperature=0.05, margin_ttm=5.0)
    want = fn(*map(jnp.asarray, embs))
    grads = jax.grad(lambda *a: sum(fn(*a).values()), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, embs))
    for r, res in enumerate(ranks):
        got, got_grads = res["exclusive"]
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(float(want[k]), rel=1e-6), k
        for g, w in zip(got_grads, grads):
            np.testing.assert_allclose(g, _rows(np.asarray(w), r), **TOL)


@pytest.mark.parametrize("gamma", [2.0, 0.0])
def test_masked_lm_focal_loss_with_unequal_counts_matches_jax(ranks, gamma):
    """The masked-LM focal loss (and its CE form) with 5 masked tokens on
    rank 0 and 2 on rank 1: the global mean over the 7 (the count
    all-reduced) against JAX on the global batch, value and each rank's
    logits gradient within 1e-6."""
    logits, labels = mlm_inputs()
    want, grad = jax.value_and_grad(lambda lg: jcls.masked_lm_focal_loss(
        lg, jnp.asarray(labels.astype(np.int32)), gamma=gamma))(jnp.asarray(logits))
    counts = [(_rows(labels, r) != -100).sum() for r in range(WORLD)]
    assert counts == [5, 2]
    for r, res in enumerate(ranks):
        got, g = res["mlm", gamma]
        assert got == pytest.approx(float(want), rel=1e-6)
        np.testing.assert_allclose(g, _rows(np.asarray(grad), r), **TOL)


@pytest.mark.parametrize("form", CE_FORMS)
def test_cross_entropy_over_a_group_matches_jax(ranks, form):
    """cross_entropy over the group (hard labels, hard labels with
    class_weight, soft labels) against the JAX loss on the global batch:
    value and each rank's logits gradient within 1e-6."""
    logits, labels, soft, weight = ce_inputs()
    want, grad = jax.value_and_grad(lambda lg: _ce(jcls.cross_entropy, lg, jnp.asarray(labels),
                                                   jnp.asarray(soft), jnp.asarray(weight),
                                                   form))(jnp.asarray(logits))
    for r, res in enumerate(ranks):
        got, g = res["ce", form]
        assert got == pytest.approx(float(want), rel=1e-6)
        np.testing.assert_allclose(g, _rows(np.asarray(grad), r), **TOL)


def test_batch_norm_projector_over_a_group_matches_flax(ranks):
    """ProjectorNorm(use_ln=False) in training with each rank's rows
    against the JAX ProjectorNorm (flax nn.BatchNorm) on the global batch:
    the output rows, the running mean and variance (equal on both ranks),
    the input gradient of sum(y * cot) and the summed scale / bias gradients,
    within 1e-6 (1e-5 relative on the running variance)."""
    x, cot, p = bn_inputs()
    module = JProjectorNorm(12, use_ln=False)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x), deterministic=False)

    def fn(params, xx):
        y, upd = module.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                              deterministic=False, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    params = {"norm": {"scale": jnp.asarray(p["scale"]), "bias": jnp.asarray(p["bias"])}}
    (_, (y, stats)), (g_p, g_x) = jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    for r, res in enumerate(ranks):
        out, mean, var, gx, gw, gb = res["bn"]
        np.testing.assert_allclose(out, _rows(np.asarray(y), r), **TOL)
        np.testing.assert_allclose(mean, np.asarray(stats["norm"]["mean"]), **TOL)
        np.testing.assert_allclose(var, np.asarray(stats["norm"]["var"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gx, _rows(np.asarray(g_x), r), **TOL)
        np.testing.assert_allclose(gw, np.asarray(g_p["norm"]["scale"]), **TOL)
        np.testing.assert_allclose(gb, np.asarray(g_p["norm"]["bias"]), **TOL)
    np.testing.assert_array_equal(ranks[0]["bn"][1], ranks[1]["bn"][1])


def test_host_gather_ragged_with_a_cross_rank_duplicate(ranks):
    """_host_gather of 2 and 3 rows (float, int and bool arrays), index 0 on
    both ranks: every rank gets the 5 rows in rank order, the dtypes kept;
    _dedup_sort drops the duplicate (as tests/test_multiprocess_real.py's
    JAX pair)."""
    for res in ranks:
        gv, gidx, gflags, v_sorted = res["host_gather"]
        assert gv.shape == (5, 1) and gflags.dtype == bool
        np.testing.assert_array_equal(gidx, [0, 1, 2, 0, 3])
        np.testing.assert_array_equal(gflags, [True, False, False, True, True])
        np.testing.assert_array_equal(v_sorted[:, 0], [0.0, 1.0, 2.0, 7.0])


@pytest.mark.parametrize("case", sorted(EVALS))
def test_eval_at_two_ranks_equals_one_process(ranks, case):
    """The train entry's eval (build_eval_fn: run_retrieval_eval, the ITM
    rerank with its tokens gathered, run_qa_eval) with each rank on its
    rank-strided shard of the val set (7 videos: the sampler pads one
    duplicate) gives every rank the metrics dict of one process, exactly."""
    want = _eval_metrics(case, None)
    assert want and all(res["eval", case] == want for res in ranks)


def test_a_signal_on_one_rank_stops_every_rank_at_the_step_boundary(ranks):
    """A SIGTERM that reaches rank 1 alone, inside step 3, is agreed on when
    the step ends: both ranks save step 3 (rank 0 writes, meta preempted /
    epoch 1) and exit with 128 + 15; neither goes on to a step the other
    does not take."""
    want = (128 + signal.SIGTERM, [2, 3], {"step": 3, "preempted": True, "epoch": 1})
    assert [res["preempt"] for res in ranks] == [want] * WORLD


@pytest.fixture
def one_rank_group():
    """A gloo group of this process alone (an in-process store)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_world_one_is_the_identity(one_rank_group):
    """In a group of one (and with no group) the collectives hand back their
    inputs themselves, the gradient reduction and the broadcast change
    nothing, _host_gather returns its arrays, and the group's losses are
    bitwise the ungrouped ones."""
    from clover_tpu_torch.engine.eval_loop import _host_gather

    x = torch.arange(6.0).reshape(3, 2)
    for group in (None, one_rank_group):
        assert collectives.all_gather_with_grad(x, group) is x
        assert collectives.psum_scalar(x, group) is x
        assert collectives.pmean_scalar(x, group) is x
        assert collectives.all_reduce_with_grad(x, group) is x
        padded, mask = collectives.all_gather_varied(x, 2, group)
        assert padded is x and mask.tolist() == [True, True, False]
        p = torch.nn.Parameter(x.clone())
        p.grad = x.clone()
        collectives.all_reduce_grads([p], group)
        collectives.broadcast_tensors([p], group)
        assert torch.equal(p.grad, x) and torch.equal(p.detach(), x)
        a, b = np.arange(3), np.ones(3)
        got = _host_gather(a, b, group=group)
        assert got[0] is a and got[1] is b
    v, t, _ = nce_inputs()
    v, t = torch.from_numpy(v), torch.from_numpy(t)
    assert torch.equal(norm_softmax_loss(v, t, temperature=0.05, cos_sim=True,
                                         group=one_rank_group),
                       norm_softmax_loss(v, t, temperature=0.05, cos_sim=True))
    logits, labels = mlm_inputs()
    lg, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    assert torch.equal(masked_lm_focal_loss(lg, lab, group=one_rank_group),
                       masked_lm_focal_loss(lg, lab))
