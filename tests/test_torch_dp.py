"""The port's data-parallel train steps and train entry on two gloo ranks,
held against the JAX package's single-device step on the global batch.

One pair of CPU processes (``torch.distributed`` over gloo, one intra-op
thread each, 120 s each) runs every step case in a module-scoped fixture,
each rank on its contiguous half of each global batch, from the seeded
weights the JAX side made here:

- the tiny retrieval finetune of ``test_torch_train.py`` (B=4, 2 a rank):
  2 steps of ``make_retrieval_train_step`` (AdamW, warmup, a clip that
  fires) against 2 jitted JAX ``make_retrieval_train_step`` steps on B=4;
- the tiny pretrain of ``test_torch_pretrain.py`` (B=4, rank 0's rows with
  6 masked tokens, rank 1's with 2): one step's loss terms, grad_norm and
  summed gradients against ``jax.value_and_grad`` of the JAX pretrain loss;
- the tiny MC QA finetune of ``test_torch_qa.py`` (4 videos): the same.

Then the train entry: ``python -m clover_tpu_torch.tools.train
configs/exp/debug_retrieval_synthetic.py --cpu --distributed`` as 2
processes with torchrun's variables, against one process; a ``--resume``
at 2 ranks; the refusals.
"""

import json
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clover_tpu.models as jmodels
import clover_tpu.models.bert as jbert
from clover_tpu.engine import TrainState as JTrainState
from clover_tpu.engine import make_optimizer as jmake_optimizer
from clover_tpu.engine.steps import make_retrieval_train_step as jmake_retrieval_step
from clover_tpu.losses.objectives import pretrain_losses as jpretrain_losses
from clover_tpu.losses.objectives import qa_loss as jqa_loss
from clover_tpu.losses.objectives import total_loss as jtotal_loss
from clover_tpu_torch.engine.steps import fold_in
from clover_tpu_torch.models import load_jax_params, state_from_jax
from clover_tpu_torch.ops.preprocess import space_to_depth_host
from clover_tpu_torch.tools import train as ptrain_entry
from test_torch_bridge import random_jax_params
from test_torch_parallel import ROOT, WORLD, finish_pair, free_port, start_pair
from test_torch_pretrain import _configs as pretrain_configs
from test_torch_pretrain import _init as pretrain_init
from test_torch_pretrain import _jax_knobs, _pretrain_batch
from test_torch_pretrain import _port_model as pretrain_port_model
from test_torch_qa import jax_heads_without_dropout, port_model_without_dropout
from test_torch_qa_eval import jax_model as qa_jax_model
from test_torch_qa_eval import jax_tree as qa_jax_tree
from test_torch_qa_eval import qa_inputs
from test_torch_train import LR, _assert_params_close, _key_bias, tiny_train_models

TOTAL, WARMUP, CLIP = 20, 2, 1.0   # the retrieval run's optimizer and clip
GB = 4                             # the global batch of every step case
KEY = jax.random.PRNGKey(0)
RETRIEVAL = os.path.join(ROOT, "configs", "exp", "debug_retrieval_synthetic.py")
PRETRAIN_TERMS = ("mlm_loss", "nce_loss", "rank_t_tm_loss", "v_nce_loss", "rank_v_vm_loss")


def retrieval_batch(seed):
    """B=4 host-s2d uint8 clips of 4 x 112^2, token ids, a ragged mask (the
    tiny inputs of test_torch_bridge at B=4)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(GB, 4, 112, 112, 3), dtype=np.uint8)
    tok = rng.integers(1000, 30522, size=(GB, 8)).astype(np.int32)
    mask = np.ones((GB, 8), np.int32)
    mask[1, 5:] = mask[2, 3:] = 0
    return {"imgs": space_to_depth_host(frames)[:, None], "token_ids": tok, "input_mask": mask}


def pretrain_batch(seed):
    """test_torch_pretrain's batch at B=4 (its 3 rows and one more), 4 more
    tokens masked and labelled in rows 0-1: rank 0's rows hold 6 masked
    tokens, rank 1's 2."""
    a, b = _pretrain_batch(seed), _pretrain_batch(seed + 100)
    batch = {k: np.concatenate([a[k], b[k][:1]]) for k in a}
    for row, col in ((0, 1), (0, 5), (1, 2), (1, 6)):
        batch["mlm_label"][row, col] = batch["token_ids"][row, col]
        batch["token_ids"][row, col] = 3
    return batch


def qa_batch(seed):
    return dict(zip(("imgs", "token_ids", "input_mask", "label"),
                    qa_inputs("mc_cls", seed=seed, videos=GB)))


def _pretrain_jx():
    return types.SimpleNamespace(jax=jax, jnp=jnp, models=jmodels, bert=jbert)


# ---------------------------------------------------------------- the ranks

# the rank side, which imports only the port: each case's model rebuilt
# from its pickled config and weights, its step factory at 2 ranks of a
# group, each global batch's contiguous half
RANK_STEPS = """
import pickle, sys
import torch
import torch.distributed as dist
from clover_tpu_torch import engine

torch.set_num_threads(1)
rank, out, inputs = int(sys.argv[1]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="tcp://localhost:" + sys.argv[2], rank=rank,
                        world_size=2)
with open(inputs, "rb") as f:
    cases = pickle.load(f)
res = {}
for name, case in cases.items():
    model = case["cls"](case["cfg"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    for path in case["no_dropout"]:
        model.get_submodule(path).drop = 0.0
    optimizer, schedule = engine.make_optimizer(model, **case["opt"])
    state = engine.TrainState.create(model, optimizer, schedule)
    step = getattr(engine, case["step"])(model, grad_clip_norm=case["clip"],
                                         group=dist.group.WORLD)
    metrics = []
    for batch in case["batches"]:
        n = len(batch["token_ids"]) // 2
        half = {k: torch.from_numpy(v[rank * n:(rank + 1) * n].copy()) for k, v in batch.items()}
        state, m = step(state, half, torch.Generator().manual_seed(0))
        metrics.append({k: v.item() for k, v in m.items()})
    res[name] = dict(metrics=metrics,
                     params={k: p.detach().numpy() for k, p in model.named_parameters()},
                     grads={k: p.grad.numpy() for k, p in model.named_parameters()})
with open(out, "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
"""


def _case(model, step, batches, clip=None, no_dropout=(), **opt):
    """A step case for RANK_STEPS: the port model's class, config and
    weights."""
    return dict(cls=type(model), cfg=model.config, no_dropout=no_dropout, step=step, clip=clip,
                batches=batches, opt=dict(base_lr=LR, total_steps=TOTAL, **opt),
                state={k: v.detach().numpy() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def cases():
    """Each case's seeded JAX weights, global batches and JAX model; the
    port's side as RANK_STEPS takes it."""
    out = {}
    jm, pm = tiny_train_models()
    batches = [retrieval_batch(s) for s in (0, 1)]
    params = jax.device_get(random_jax_params(jm, *(batches[0][k] for k in (
        "imgs", "token_ids", "input_mask")))["params"])
    load_jax_params(pm, {"params": params})
    out["retrieval"] = (jm, params, _case(pm, "make_retrieval_train_step", batches, clip=CLIP,
                                          warmup_steps=WARMUP))

    jx = _pretrain_jx()
    jcfg, pcfg = pretrain_configs(jx)
    jm = jmodels.CloverPretrain(jcfg, dtype=jnp.float32)
    batch = pretrain_batch(0)
    params = jax.device_get(pretrain_init(jx, jm, batch, train=False)["params"])
    out["pretrain"] = (jm, params, _case(pretrain_port_model(pcfg, params),
                                         "make_pretrain_train_step", [batch],
                                         no_dropout=("mlm_ssl_T_head",)))

    batch = qa_batch(10)
    params = qa_jax_tree(qa_jax_model("mc_cls"), "mc_cls")["params"]
    pm = port_model_without_dropout("mc_cls")
    load_jax_params(pm, {"params": params})
    out["qa"] = (None, params, _case(pm, "make_qa_train_step", [batch],
                                     no_dropout=("qa_head",)))
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """The 2 ranks' results; they run while the JAX references compile."""
    tmp = tmp_path_factory.mktemp("dp_pair")
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({k: c for k, (_, _, c) in cases.items()}, f)
    pair = start_pair(RANK_STEPS, tmp, args=(inputs,))
    try:
        refs = _jax_references(cases)
    finally:
        results = finish_pair(pair)
    return refs, results


def _jax_references(cases):
    """The JAX side on the global batches: 2 jitted retrieval steps (AdamW,
    warmup, a clip that fires); jax.value_and_grad of the pretrain and the
    QA loss."""
    out = {}
    jm, params, case = cases["retrieval"]
    tx, _ = jmake_optimizer(params, base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP)
    state = JTrainState.create(params, tx)
    step = jax.jit(jmake_retrieval_step(jm, jit=False, grad_clip_norm=CLIP))
    history = []
    for b in case["batches"]:
        state, metrics = step(state, b, KEY)
        history.append(jax.device_get((metrics, state.params)))
    out["retrieval"] = history

    jm, params, case = cases["pretrain"]
    batch = case["batches"][0]
    mp = _jax_knobs(_pretrain_jx())
    try:
        def pretrain_loss(p):
            losses = jpretrain_losses(jm.apply({"params": p}, batch, train=True,
                                               rngs={"dropout": KEY}), batch["mlm_label"])
            return jtotal_loss(losses), losses

        (loss, terms), grads = jax.jit(jax.value_and_grad(pretrain_loss, has_aux=True))(params)
    finally:
        mp.undo()
    out["pretrain"] = dict(loss=float(loss), terms=jax.device_get(terms),
                           grads=jax.device_get(grads))

    _, params, case = cases["qa"]
    batch = case["batches"][0]
    with jax_heads_without_dropout():
        qm = qa_jax_model("mc_cls")

        def qa(p):
            return jtotal_loss(jqa_loss(qm.apply({"params": p}, batch, train=True,
                                                 rngs={"dropout": KEY}), batch["label"]))

        loss, grads = jax.jit(jax.value_and_grad(qa))(params)
    out["qa"] = dict(loss=float(loss), grads=jax.device_get(grads))
    return out


def _global_norm(grads):
    return np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))


def _assert_grads_close(got, jax_grads, what, zero=()):
    """Every summed gradient within 2e-4 * max|its JAX gradient| + 1e-7
    (test_torch_train's limits); the attention key biases' and the ``zero``
    tensors' (a zero gradient in exact arithmetic: fp32 noise on both sides)
    below 1e-6."""
    want = state_from_jax(jax_grads)
    assert got.keys() == want.keys()
    for name, w in want.items():
        w, g = w.reshape(-1), got[name].reshape(-1)
        noise = _key_bias(name, w.size) | (name in zero)
        assert np.abs(g[noise]).max(initial=0) < 1e-6, f"{what}: {name} noise"
        if (~noise).any():
            err = float(np.abs(g[~noise] - w[~noise]).max())
            assert err <= 2e-4 * np.abs(w[~noise]).max() + 1e-7, f"{what}: {name}: {err}"


@pytest.mark.parametrize("step", [0, 1])
def test_retrieval_steps_at_two_ranks_match_jax(ranks, step):
    """make_retrieval_train_step at 2 ranks of 2 rows against the JAX step on
    the 4: retrieval_nce_loss, loss and grad_norm within 2e-5 relative at
    each step, on both ranks (the clip fires: grad_norm > 1)."""
    refs, results = ranks
    history = refs["retrieval"]
    assert max(float(h[0]["grad_norm"]) for h in history) > CLIP, "the clip never fired"
    want = history[step][0]
    for res in results:
        got = res["retrieval"]["metrics"][step]
        assert set(got) == set(want) == {"retrieval_nce_loss", "loss", "grad_norm"}
        for k in want:
            assert got[k] == pytest.approx(float(want[k]), rel=2e-5), k


def test_retrieval_parameters_after_two_steps_match_jax(ranks):
    """The parameters after the 2 AdamW steps within 2e-5 of the JAX ones
    (the attention key biases, whose exact gradient is zero, within 3 lr:
    test_torch_train._assert_params_close), and bitwise equal on both ranks
    (one reduction, one update)."""
    refs, results = ranks
    _, pm = tiny_train_models()
    for res in results:
        pm.load_state_dict({k: torch.from_numpy(v) for k, v in
                            res["retrieval"]["params"].items()}, strict=False)
        _assert_params_close(pm, refs["retrieval"][-1][1], 2e-5, "after 2 steps at 2 ranks")
    a, b = (r["retrieval"]["params"] for r in results)
    assert a.keys() == b.keys() and all(np.array_equal(a[n], b[n]) for n in a)


def test_pretrain_step_at_two_ranks_matches_jax(ranks, cases):
    """make_pretrain_train_step at 2 ranks (6 and 2 masked tokens) against
    jax.value_and_grad of the JAX pretrain loss on the global batch: the
    five terms and their total within 1e-5 relative, grad_norm within 1e-5
    relative of the JAX gradient's norm, the summed gradients as
    _assert_grads_close."""
    refs, results = ranks
    want = refs["pretrain"]
    labels = cases["pretrain"][2]["batches"][0]["mlm_label"]
    assert [int((labels[r * 2:(r + 1) * 2] != -100).sum()) for r in range(WORLD)] == [6, 2]
    for res in results:
        (metrics,), grads = res["pretrain"]["metrics"], res["pretrain"]["grads"]
        for k in PRETRAIN_TERMS:
            assert metrics[k] == pytest.approx(float(want["terms"][k]), rel=1e-5, abs=1e-7), k
        assert metrics["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert metrics["grad_norm"] == pytest.approx(
            _global_norm(state_from_jax(want["grads"])), rel=1e-5)
        _assert_grads_close(grads, want["grads"], "pretrain")


def test_qa_step_at_two_ranks_matches_jax(ranks):
    """make_qa_train_step (the MC head, dropouts 0) at 2 ranks of 2 videos
    against jax.value_and_grad of the JAX QA loss on the 4: qa_loss and
    grad_norm within 1e-5 relative, the summed gradients as
    _assert_grads_close (the MC head's output bias, a shift its softmax
    does not see, among the zero-gradient tensors)."""
    refs, results = ranks
    want = refs["qa"]
    for res in results:
        (metrics,), grads = res["qa"]["metrics"], res["qa"]["grads"]
        assert metrics["qa_loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert metrics["grad_norm"] == pytest.approx(
            _global_norm(state_from_jax(want["grads"])), rel=1e-5)
        _assert_grads_close(grads, want["grads"], "qa", zero=("qa_head.fc2.bias",))


def test_fold_in_draws_per_rank():
    """Rank 0 draws the one-process dropout stream; other ranks their own."""
    g = torch.Generator().manual_seed(5)
    draw = [torch.rand(4, generator=fold_in(g, 3, r)) for r in (0, 1, 2)]
    assert torch.equal(draw[0], torch.rand(4, generator=fold_in(g, 3)))
    assert not torch.equal(draw[0], draw[1]) and not torch.equal(draw[1], draw[2])


# ---------------------------------------------------------------- the entry

def _start_entry(work_dirs, *argv):
    """The train entry as 2 processes with torchrun's variables; rank r in
    ``work_dirs[r]``. -> the processes, for ``_finish_entry``."""
    port = free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "clover_tpu_torch.tools.train", RETRIEVAL, "--cpu",
             "--distributed", "--work-dir", str(work_dirs[r]), *argv],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish_entry(procs, timeout=120):
    """-> the ranks' stdout; raises with the log of a rank that failed."""
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
    return logs


def _lines(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def entry_runs(tmp_path_factory):
    """One epoch at 2 ranks (rank 1 in a work dir of its own) and, meanwhile,
    in one process; then --resume to 2 epochs at 2 ranks in rank 0's dir."""
    tmp = tmp_path_factory.mktemp("entry")
    one_epoch = ("--cfg-options", "total_epochs=1")
    procs = _start_entry([tmp / "r0", tmp / "r1"], *one_epoch)
    try:
        ptrain_entry.main([RETRIEVAL, "--cpu", "--work-dir", str(tmp / "one"), *one_epoch])
    finally:
        two = _finish_entry(procs)
    first = _lines(tmp / "r0")
    resumed = _finish_entry(_start_entry([tmp / "r0", tmp / "r0"], "--resume"))
    return dict(tmp=tmp, two=two, first=first, one=_lines(tmp / "one"), resumed=resumed,
                after=_lines(tmp / "r0"))


def test_entry_writes_from_rank_0_only(entry_runs):
    """Rank 0's dir holds the config, metrics.jsonl (2 steps, 1 eval) and a
    checkpoint; rank 1's dir holds no file (an empty checkpoints dir), and
    rank 1 logs its steps to its own stdout."""
    tmp = entry_runs["tmp"]
    assert sorted(os.listdir(tmp / "r1")) == ["checkpoints"]
    assert os.listdir(tmp / "r1" / "checkpoints") == []
    first = entry_runs["first"]
    assert [r["step"] for r in first if "loss" in r] == [1, 2]
    assert sum("Recall@1" in r for r in first) == 1
    assert {"config.json", "metrics.jsonl"} <= set(os.listdir(tmp / "r0"))
    assert "step_0000000002" in os.listdir(tmp / "r0" / "checkpoints")
    assert "rank 1 of 2" in entry_runs["two"][1] and "train retrieval_nce_loss" in \
        entry_runs["two"][1]


def test_entry_losses_equal_one_process(entry_runs):
    """Each step's loss and grad_norm at 2 ranks of 4 rows within 1e-5
    relative of one process on the same 8 (the sampler gives each step the
    same samples; a sample's draws depend on (seed, index) only), and the
    eval's metrics equal."""
    two, one = entry_runs["first"], entry_runs["one"]
    steps = [(a, b) for a, b in zip(two, one) if "loss" in a]
    assert len(steps) == 2 and all("loss" in b for _, b in steps)
    for a, b in steps:
        for k in ("loss", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), (k, a["step"])
    evals = [{k: v for k, v in r.items() if k not in ("time",)} for r in (two[-1], one[-1])]
    assert "Recall@1" in evals[0] and evals[0] == evals[1]


def test_entry_resume_starts_every_rank_at_the_same_step(entry_runs):
    """--resume at 2 ranks: both read the step-2 checkpoint, start at epoch
    1 and end at step 4; rank 0 appends the resumed lines."""
    for log in entry_runs["resumed"]:
        assert "resumed_step=2" in log and "training done at step 4" in log
    after = entry_runs["after"]
    assert [r["step"] for r in after if "loss" in r] == [1, 2, 3, 4]
    assert sum("resumed_step" in r for r in after) == 1


@pytest.mark.parametrize("case", ["no_env", "fsdp", "batch"])
def test_entry_refuses_what_data_parallel_does_not_run(monkeypatch, tmp_path, case):
    """--distributed without torchrun's variables, with parallel.fsdp=2, or
    with a global batch the ranks do not divide raises before any process
    group or work dir is made."""
    from clover_tpu_torch.parallel.mesh import TORCHRUN_ENV

    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    if case != "no_env":
        for k, v in zip(TORCHRUN_ENV, ("0", "3" if case == "batch" else "2", "0", "localhost",
                                       "1")):
            monkeypatch.setenv(k, v)
    opts = {"no_env": [], "fsdp": ["parallel.fsdp=2"], "batch": []}[case]
    match = {"no_env": "torchrun", "fsdp": "Queue 1 item 5", "batch": "divisible"}[case]
    work = tmp_path / "w"
    with pytest.raises(SystemExit, match=match):
        ptrain_entry.main([RETRIEVAL, "--cpu", "--distributed", "--work-dir", str(work),
                           "--cfg-options", *opts])
    assert not torch.distributed.is_initialized() and not work.exists()
