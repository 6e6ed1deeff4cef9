"""The port's QA / ITM eval side held against the JAX package on the CPU,
and its kernels at the fusion tower's call shapes on the card.

Home of the tiny QA configuration that ``test_torch_qa.py`` shares: a
2-stage Swin (embed dim 64, head dim 32; 4 x 56^2 clips give (2, 7, 7)
tokens, a shifted block in stage 0), a 2-layer BERT of width 64 and a
2-layer fusion tower of width 64 over 2 x 49 visual tokens, fp32, every
dropout at 0 (the JAX dropout stream cannot be matched).

- the numpy metric copies against ``clover_tpu.evaluation.metrics``;
- ``encode_visual`` and ``itm_pair_score`` of a retrieval model with the
  ITM head against the JAX ``make_itm_embed_step`` / ``make_itm_score_step``
  (jitted once each), 1e-4 absolute and relative as
  ``tests/test_torch_slice.py``; then ``run_itm_retrieval_eval`` of both
  packages on the same batches, all pairs and the top-2 rerank: equal
  metric dicts;
- ``run_qa_eval``, ``run_mc_retrieval_eval`` and
  ``run_zeroshot_action_eval`` of both packages fed the same step outputs
  and batches (with a sampler-padding duplicate): equal metric dicts.

JAX is imported inside the fixtures and tests that compare with it, so the
``gpu`` tests run on a machine without it:
``python -m pytest tests/test_torch_qa_eval.py -m gpu --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

from clover_tpu_torch import evaluation as pmetrics
from clover_tpu_torch import ops
from clover_tpu_torch.engine import (make_itm_embed_step, make_itm_score_step, make_qa_eval_step,
                                     run_itm_retrieval_eval, run_mc_retrieval_eval, run_qa_eval,
                                     run_zeroshot_action_eval)
from clover_tpu_torch.models import (MASK_TOKEN_ID, BertConfig, CloverFinetune, FinetuneConfig,
                                     FusionConfig, SwinConfig, init_params, load_jax_params)
from clover_tpu_torch.ops.preprocess import space_to_depth_host

TOL = dict(atol=1e-4, rtol=1e-4)
SWIN = dict(embed_dim=64, depths=(2, 2), num_heads=(2, 4), fold_normalize=True,
            drop_path_rate=0.0)
BERT = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, hidden_dropout=0.0, attention_dropout=0.0)
FUSION = dict(img_in_size=128, hidden_size=64, num_frames=2, spatial_tokens=49)
V, T, S, L, N_CAND = 2, 4, 56, 8, 3   # videos, frames, clip size, tokens, MC candidates
# CloverFinetune's tasks and readouts (the JAX FinetuneConfig fields)
TASKS = {
    "mc_cls": dict(task="video_qa", answer_cls=True, qa_head="mc"),
    "oe_cls": dict(task="video_qa", answer_cls=True, qa_head="oe", num_labels=6),
    "oe_cls_scaled": dict(task="video_qa", answer_cls=True, qa_head="oe", num_labels=6,
                          scale_pixels=True),
    "fib_mask": dict(task="FIB", answer_mask=True, qa_head="oe", num_labels=5),
    "cls_itm": dict(task="video_qa", answer_cls=True, use_itm_head=True),
    "mc_cls_itm": dict(task="video_qa", answer_cls=True, use_itm_head=True, qa_head="mc"),
    "itm": dict(task="video_qa", use_itm_head=True),
    "retrieval": dict(task="retrieval"),
    "retrieval_itm": dict(task="retrieval", use_itm_head=True),
}


def port_model(task):
    """The port's tiny model of ``TASKS[task]`` on the CPU, fp32."""
    cfg = FinetuneConfig(swin=SwinConfig(**SWIN), text_bert=BertConfig(**BERT),
                         fusion=FusionConfig(bert=BertConfig(**BERT), **FUSION), **TASKS[task])
    return CloverFinetune(cfg, device="cpu")


def jax_model(task):
    """The JAX package's tiny model of ``TASKS[task]``, fp32."""
    import jax.numpy as jnp

    from clover_tpu.models import BertConfig as JBertConfig
    from clover_tpu.models import CloverFinetune as JCloverFinetune
    from clover_tpu.models import FinetuneConfig as JFinetuneConfig
    from clover_tpu.models import FusionConfig as JFusionConfig
    from clover_tpu.models import SwinConfig as JSwinConfig

    cfg = JFinetuneConfig(swin=JSwinConfig(embed_impl="host_s2d", **SWIN),
                          text_bert=JBertConfig(**BERT),
                          fusion=JFusionConfig(bert=JBertConfig(**BERT), **FUSION),
                          **TASKS[task])
    return JCloverFinetune(cfg, dtype=jnp.float32)


def n_cand(task):
    """Text rows a video: the MC candidates, or one question."""
    return 1 if TASKS[task]["task"] == "retrieval" or TASKS[task].get("qa_head") == "oe" \
        else N_CAND


def qa_inputs(task, seed=0, videos=V, edge=False):
    """Seeded host-s2d uint8 clips (videos, 1, T/2, S/4, S/4, 96), token ids
    and mask (videos, n_cand, L) (ids in [104, 1000), [CLS] first, padded
    tails), labels (videos,). FIB rows hold one [MASK] at a seeded position
    before their padding; with ``edge``, row 0 holds two and row 1 none."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(videos, T, S, S, 3), dtype=np.uint8)
    n = n_cand(task)
    tok = rng.integers(MASK_TOKEN_ID + 1, BERT["vocab_size"], size=(videos, n, L))
    tok[..., 0] = 101
    lengths = rng.integers(L // 2, L + 1, size=(videos, n))
    mask = (np.arange(L) < lengths[..., None]).astype(np.int32)
    if TASKS[task].get("answer_mask"):
        pos = rng.integers(1, lengths)
        np.put_along_axis(tok, pos[..., None], MASK_TOKEN_ID, axis=-1)
        if edge:
            tok[0, 0, 1] = tok[0, 0, L // 2] = MASK_TOKEN_ID
            tok[1, 0] = np.where(tok[1, 0] == MASK_TOKEN_ID, 500, tok[1, 0])
    labels = rng.integers(0, TASKS[task].get("num_labels") or n, size=videos)
    return (space_to_depth_host(frames)[:, None], (tok * mask).astype(np.int32), mask,
            labels.astype(np.int32))


def jax_tree(jm, task, seed=0):
    """The JAX model's parameter tree (jax.eval_shape of an init that runs
    forward_test, and itm_pair_score where the model has the ITM head) with
    seeded values; biases and norm affines non-trivial, as
    test_torch_bridge.random_jax_params fills them."""
    import jax
    import jax.numpy as jnp

    imgs, tok, mask, _ = (jnp.asarray(a) for a in qa_inputs(task))
    retrieval_itm = TASKS[task]["task"] == "retrieval" and TASKS[task].get("use_itm_head")

    def run(m):
        out = m.forward_test(imgs, tok, mask)
        if retrieval_itm:
            tokens = m.encode_visual(imgs, imgs.shape[0])
            out = (out, m.itm_pair_score(tokens, tok[:, 0], mask[:, 0]))
        return out

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), method=run))
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

    return jax.device_get(jax.tree_util.tree_map_with_path(fill, shapes))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ----------------------------------------------------------------- metrics

def _metric_cases():
    rng = np.random.default_rng(30)
    scores = rng.normal(size=(7, 5))
    multi = (rng.random(size=(9, 4)) < 0.4).astype(np.int32)
    return {
        "itm_t2v_recall": ((rng.normal(size=(12, 12)),), {}),
        "itm_t2v_recall with gt_video": ((rng.normal(size=(12, 4)), rng.integers(0, 4, 12)), {}),
        "multiple_choice_retrieval_acc": ((rng.normal(size=(4, 6)), rng.normal(size=(12, 6)),
                                           rng.integers(0, 3, 4)), {}),
        "zeroshot_action_recognition_acc": ((rng.normal(size=(10, 6)), rng.normal(size=(5, 6)),
                                             rng.integers(1, 6, 10)), {}),
        "qa_accuracy": ((scores, rng.integers(0, 5, (7, 1))), {}),
        "top_k_accuracy": ((scores, rng.integers(0, 5, 7)), {"topk": (1, 3)}),
        "mean_average_precision": ((rng.normal(size=(9, 4)), multi), {}),
        "precision_recall_at_threshold": ((rng.random(size=(9, 4)), multi), {"threshold": 0.3}),
        "mean_class_accuracy": ((scores, rng.integers(0, 3, 7)), {}),
    }


@pytest.mark.parametrize("name", sorted(_metric_cases()))
def test_metrics_copy_matches_jax_package(name):
    """Each numpy metric of the port equals the JAX package's on the same
    seeded scores, embeddings and labels."""
    from clover_tpu.evaluation import metrics as jmetrics

    args, kw = _metric_cases()[name]
    fn = name.split()[0]
    assert getattr(pmetrics, fn)(*args, **kw) == getattr(jmetrics, fn)(*args, **kw)


# -------------------------------------------- the ITM eval on the tiny model

@pytest.fixture(scope="module")
def itm_run():
    """The JAX retrieval model with the ITM head: its seeded tree, the
    jitted ITM embed and score steps, and the port model on the same
    weights (eval mode)."""
    import jax

    from clover_tpu.engine.steps import make_itm_embed_step as jmake_embed
    from clover_tpu.engine.steps import make_itm_score_step as jmake_score

    jm = jax_model("retrieval_itm")
    params = jax_tree(jm, "retrieval_itm")
    pm = port_model("retrieval_itm")
    load_jax_params(pm, params)
    return dict(params=params["params"], embed=jmake_embed(jm), score=jmake_score(jm),
                pm=pm.eval(), jax=jax)


def test_encode_visual_and_embeddings_match_jax(itm_run):
    """make_itm_embed_step's tokens (the cached Swin tokens, (V, 2, 49,
    128)) and its dual-tower embeddings against the JAX step's."""
    imgs, tok, mask, _ = qa_inputs("retrieval_itm", seed=1)
    want = itm_run["embed"](itm_run["params"], imgs, tok[:, 0], mask[:, 0])
    got = make_itm_embed_step(itm_run["pm"])(*_t(imgs, tok[:, 0], mask[:, 0]))
    assert got[0].shape == (V, FUSION["num_frames"], FUSION["spatial_tokens"],
                            SWIN["embed_dim"] * 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with torch.inference_mode():
        tokens = itm_run["pm"].encode_visual(*_t(imgs), V)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want[0]), **TOL)


def test_itm_pair_score_matches_jax(itm_run):
    """P(match) of 6 (cached tokens, text) pairs, the fp32 softmax of the
    ITM head on the fused first token, against the JAX score step."""
    rng = np.random.default_rng(2)
    tokens = rng.normal(size=(6, FUSION["num_frames"], FUSION["spatial_tokens"],
                              FUSION["img_in_size"])).astype(np.float32)
    _, tok, mask, _ = qa_inputs("retrieval_itm", seed=2, videos=6)
    want = np.asarray(itm_run["score"](itm_run["params"], tokens, tok[:, 0], mask[:, 0]))
    got = make_itm_score_step(itm_run["pm"])(*_t(tokens, tok[:, 0], mask[:, 0]))
    assert got.dtype == torch.float32 and got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("top_k", [None, 2])
def test_itm_retrieval_loop_matches_jax(itm_run, top_k):
    """run_itm_retrieval_eval of both packages over the same 2 batches of 2
    videos (one caption each; the second batch first, so the loops sort by
    index), every pair or each text's top-2 tower candidates, 3 pairs a
    score call: equal R@K (Recall@1 ... Recall@all)."""
    from clover_tpu.engine.eval_loop import run_itm_retrieval_eval as jrun

    imgs, tok, mask, _ = qa_inputs("retrieval_itm", seed=3, videos=4)
    batches = [{"imgs": imgs[i:i + 2], "token_ids": tok[i:i + 2, 0],
                "input_mask": mask[i:i + 2, 0], "index": np.arange(i, i + 2),
                "video_index": np.arange(i, i + 2)} for i in (2, 0)]
    dataset = types.SimpleNamespace(text_video_ids=[[i] for i in range(4)])
    want = jrun(itm_run["embed"], itm_run["score"], itm_run["params"], dataset, iter(batches),
                top_k=top_k, pair_batch=3)
    pm = itm_run["pm"]
    got = run_itm_retrieval_eval(make_itm_embed_step(pm), make_itm_score_step(pm), pm, dataset,
                                 iter(batches), top_k=top_k, pair_batch=3)
    assert got == want and set(got) == {"Recall@1", "Recall@5", "Recall@10", "MR", "Recall@all"}


# ---------------------------------- the loops on the same step outputs

def _fake_batches(n_entries, extra=()):
    """Batches of 2 entries in a seeded shuffled order, the first entry
    again at the end (sampler padding); ``extra``: (key, array by entry)
    pairs, each batch holding its entries' rows."""
    order = np.random.default_rng(5).permutation(n_entries)
    order = np.append(order, order[0])
    batches = []
    for i in range(0, len(order), 2):
        sel = order[i:i + 2]
        batches.append({"imgs": np.zeros((len(sel), 1, 1, 1, 1, 96), np.uint8),
                        "token_ids": np.zeros((len(sel), 4), np.int32),
                        "input_mask": np.ones((len(sel), 4), np.int32), "index": sel,
                        "rows": sel, **{k: v[sel] for k, v in extra}})
    return batches


def _both_loops(jrun, prun, batches, outputs, dataset, **kw):
    """The JAX loop and the port's fed ``outputs(batch)`` as each step's
    return (numpy; tensors for the port). -> (JAX metrics, port metrics)."""
    def step(to_torch):
        it = iter(batches)

        def run(*a):
            out = outputs(next(it))
            if not to_torch:
                return out
            return (tuple(map(torch.from_numpy, out)) if isinstance(out, tuple)
                    else torch.from_numpy(out))
        return run

    want = jrun(step(False), None, dataset, iter(batches), **kw)
    got = prun(step(True), torch.nn.Linear(1, 1), dataset, iter(batches), **kw)
    return want, got


def test_qa_loop_matches_the_jax_loop():
    """run_qa_eval: (B, 5) scores, labels (B, 1); equal accuracy."""
    from clover_tpu.engine.eval_loop import run_qa_eval as jrun

    rng = np.random.default_rng(6)
    scores = rng.normal(size=(9, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(9, 1))
    batches = _fake_batches(9, (("label", labels),))
    want, got = _both_loops(jrun, run_qa_eval, batches, lambda b: scores[b["rows"]],
                            types.SimpleNamespace())
    assert got == want and 0.0 < got["acc"] < 1.0


def test_mc_retrieval_loop_matches_the_jax_loop():
    """run_mc_retrieval_eval: 4 videos of 3 candidates, an entry a
    (video, candidate) pair; equal accuracy against dataset.labels."""
    from clover_tpu.engine.eval_loop import run_mc_retrieval_eval as jrun

    rng = np.random.default_rng(7)
    v = np.repeat(rng.normal(size=(4, 8)), 3, axis=0).astype(np.float32)
    t = rng.normal(size=(12, 8)).astype(np.float32)
    batches = _fake_batches(12, (("video_index", np.arange(12) // 3),))
    dataset = types.SimpleNamespace(labels=rng.integers(0, 3, 4))
    want, got = _both_loops(jrun, run_mc_retrieval_eval, batches,
                            lambda b: (v[b["rows"]], t[b["rows"]]), dataset)
    assert got == want


def test_zeroshot_loop_matches_the_jax_loop():
    """run_zeroshot_action_eval: 10 videos against 4 class-name embeddings,
    1-indexed labels; equal top-1 accuracy."""
    from clover_tpu.engine.eval_loop import run_zeroshot_action_eval as jrun

    rng = np.random.default_rng(8)
    v = rng.normal(size=(10, 8)).astype(np.float32)
    classes = rng.normal(size=(4, 8)).astype(np.float32)
    labels = rng.integers(1, 5, size=10)
    batches = _fake_batches(10, (("label", labels),))
    want, got = _both_loops(jrun, run_zeroshot_action_eval, batches,
                            lambda b: (v[b["rows"]], v[b["rows"]]), types.SimpleNamespace(),
                            class_text_embd=classes)
    assert got == want


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _card_tol(key, ref):
    from chip_smoke import TOL as CARD_TOL

    atol, rtol = CARD_TOL[key]
    return atol + rtol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [15104, 18080, 28928])
def test_k3_at_the_fusion_rows_on_card(cuda, rows):
    """K3 at the fusion tower's FFN rows (C=768, H=3072, eps 1e-12): the OE
    eval's 64 x (196 + 40), the MC eval's 80 x (196 + 30), the ITM score
    call's 128 x (196 + 30); within chip_smoke.TOL['K3'] of the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    C, H = 768, 3072

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * std

    x = randn(rows, C).bfloat16()
    w = (1 + randn(C, std=0.1), randn(C, std=0.1), randn(H, C, std=C ** -0.5),
         randn(H, std=0.1), randn(C, H, std=H ** -0.5), randn(C, std=0.1))
    got = ops.fused_mlp_postln(x, *w, 1e-12)
    ref = ops.mlp_postln_plain(x, *w, 1e-12).float()
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    assert (got.float() - ref).abs().max().item() <= _card_tol("K3", ref)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [64 * 196, 80 * 196, 128 * 196])
def test_k4_at_the_fusion_visual_norm_rows_on_card(cuda, rows):
    """K4 at visual_norm's rows (B x 196, C=768, eps 1e-5) of the OE eval,
    the MC eval and the ITM score call, within chip_smoke.TOL['K4']."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = (2 * torch.randn(rows, 768, generator=g, device=cuda) + 0.5).bfloat16()
    w = 1 + 0.1 * torch.randn(768, generator=g, device=cuda)
    b = 0.1 * torch.randn(768, generator=g, device=cuda)
    got = ops.fused_layer_norm(x, w, b, 1e-5)
    ref = ops.layer_norm_plain(x, w, b, 1e-5).float()
    assert got.shape == x.shape
    assert (got.float() - ref).abs().max().item() <= _card_tol("K4", ref)


@pytest.mark.gpu
def test_qa_eval_forward_kernels_match_plain_on_card(cuda):
    """The OE QA eval forward at full width (Swin-B, BERT-base, the 3-layer
    fusion tower, 1500 answers; 2 videos of 8 x 224^2, L=40), bf16, through
    the kernels and through the plain versions on the same seeded weights:
    per-row score cosine >= 0.999, K1 24, K2 24, K3 15 and K4 46 launches."""
    cfg = FinetuneConfig(swin=SwinConfig.base(fold_normalize=True), text_bert=BertConfig(),
                         task="video_qa", answer_cls=True, qa_head="oe", num_labels=1500)
    model = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=True).eval()
    init_params(model, torch.Generator().manual_seed(0))
    plain = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=False).eval()
    plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(2, 8, 224, 224, 3), dtype=np.uint8)
    tok = rng.integers(1000, 30522, size=(2, 1, 40))
    tok[..., 0] = 101
    args = [a.to(cuda) for a in _t(space_to_depth_host(frames)[:, None], tok,
                                   np.ones_like(tok))]
    ops.reset_launch_counts()
    got = make_qa_eval_step(model)(*args)
    launches = {k: f.launches for k, f in (("K1", ops.flat2_window_attention),
                                           ("K2", ops.fused_ln_mlp_residual),
                                           ("K3", ops.fused_mlp_postln),
                                           ("K4", ops.fused_layer_norm))}
    want = make_qa_eval_step(plain)(*args)
    assert got.shape == (2, 1500) and bool(torch.isfinite(got).all())
    assert launches == {"K1": 24, "K2": 24, "K3": 15, "K4": 46}
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1)
    assert cos.min().item() >= 0.999, cos
