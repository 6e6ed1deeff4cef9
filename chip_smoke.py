#!/usr/bin/env python3
"""Smoke run of clover_tpu_torch's retrieval-eval, retrieval-finetune,
pretrain, QA / FIB and ITM paths, its train / test entry points and its
serving bundles on one CUDA card.

    python3 chip_smoke.py [--profile] [--dp8]

Phases, in order; any failure raises and exits non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from clover_tpu_torch/csrc (nvcc, sm_90a);
3. hold each eval kernel against its plain PyTorch version at the shapes
   the Swin-B + BERT-base eval forward gives it (B=32 clips of 8 x 224^2,
   L=30), bf16, and time both with CUDA events; K2 at stage 2's shape also
   in one chunk of rows and in 3, bitwise the call in its plan's chunks;
4. drive the eval path -- make_embed_eval_step + run_retrieval_eval over a
   few batches of seeded random clips and captions, with seeded random
   weights -- and check the per-forward launch counts, finite embeddings
   and the R@K metrics (with --profile, trace its forwards);
5. run the same batches through the plain versions on the card, compare the
   embeddings (cosine per row) and print clips/s of both paths;
5b. the 32-frame retrieval eval (B=32 clips of 32 x 224^2: Swin-B's 8x7x7
   window, N=392, where every block runs the fused attention half-block
   K6): K6 against its plain version at the four stage shapes, unshifted
   and shifted, K2-K4 at the path's shapes; then the path itself through
   make_embed_eval_step + run_retrieval_eval, its launch counts, and the
   plain path on the same batches (cosine per row, clips/s, peak memory);
5c. the spatial block path and the other attention routes of
   SwinConfig.attention_impl / long_attn, each a retrieval eval against its
   plain path on the same weights and clips (launches, cosine per row,
   clips/s, peak memory): E8H, the 8-frame eval with attention_impl='pallas'
   (K9, the head-major attention with fp32 bias and mask, in every block);
   E8S, 'pallas_fused' (every stage spatial, K10 on the qkv grid in every
   block); E8P, B=4 clips of 8 x 256^2 whose every stage pads (token dims
   (4, 64, 64) ... (4, 8, 8)), under both; E32L, the 32-frame eval with
   fused_attn='off' and long_attn 'v7' (K11 on the flat qkv) and 'v6' (K11
   head-major after a relayout) in every block. First K9, K10 and K11
   against their plain versions at those paths' shapes, every stage,
   unshifted and shifted, with SDPA's time on the same q, k, v (and, with
   --profile, each path's forwards traced);
6. hold each train kernel (K1 at the 12-frame window, K5, K2's stash form)
   against its plain version at the shapes of the finetune step (B=16 clips
   of 12 x 224^2, L=30), and time both;
7. drive the train path -- make_retrieval_train_step (AdamW, cosine
   warmup, clip at 15) for a few steps from the same seeded weights on
   seeded batches -- and check the per-step launch counts and a finite
   gradient on every parameter;
8. run the same steps with the plain versions, compare step 1's loss,
   grad_norm and per-tensor gradient cosine, print clips/s and peak memory
   of both paths; with --profile, trace a few more steps of each path (and,
   in phase 5b, the kernel path's 32-frame forwards) with torch.profiler
   and print the device time by kernel family;
8b. the 32-frame finetune step (B=16 clips of 32 x 224^2: every Swin block
   at N=392 runs its attention half as the fused half-block in training --
   K6 with DropPath's per-window row scale forward, a backward that
   recomputes it through K1 and K5 at 25 key tiles): K1, K5 and K6 (with a
   row scale) against their plain versions at the four stage shapes,
   unshifted and shifted, and K2's stash form; then phases 7 and 8 at 32
   frames from the seeded weights again;
8c. the tri-modal pretrain step (bench.py's bench_train: Swin-B with the
   SimMIM mask token + BERT-base + the 3-layer fusion tower, B=8 clips of
   8 x 224^2 and L=30, the clean and masked passes batched to 2B=16; AdamW
   5e-5 with 10 warmup steps, clip 15): K1, K5 and K2's stash form at the
   16-clip Swin shapes and K3M (the masked post-LN FFN, the fusion tower's
   3616 rows under fused_mlp_train='auto') against their plain versions;
   then 5 steps of make_pretrain_train_step with the kernels and with the
   plain versions from one seed: launches per step, finite gradients, every
   loss key, step 1 compared, clips/s and peak memory (and, with
   --profile, 3 more steps of each path traced);
8d. the 32-frame pretrain step under the TPU's remat recipe (bench.py's
   BENCH_FRAMES=32 BENCH_REMAT=0,1: B=8 clips of 32 x 224^2, the blocks of
   Swin stages 0-1 rematerialised, the MLP stash off, every Swin MLP
   backward through K7, the recompute backward as GEMM passes): K7 at the
   four stage shapes against the plain recompute backward (dx within K2's
   limits; each fp32 output's error against the plain version run in fp32
   at most BWD_ERR_RATIO x the bf16 plain version's; two launches bitwise
   equal), K2's training form without the stash, K6, K1, K5 and K3M (13024
   fusion rows) at the path's shapes; then 5 steps with the kernels and
   with the plain versions as in 8c (and, with --profile, 3 more traced);
8e. the 8-frame pretrain step through the pair K8 (the erf GELU, every
   stage rematerialised, the stash off; K7's passes with the erf GELU): K8
   checked as K7, then 3 steps on each path as in 8c (and, with --profile,
   traced);
8f. the device preprocess of RGB frames alone at the RGB paths' batch
   shapes (ms per batch beside its bytes bound); R8, the 8-frame retrieval
   eval from uint8 RGB frames (B=32 clips of 8 x 224^2, the configs'
   test_canonical_size, so eval_preprocess only normalizes; the raw-clip
   'conv' embed, fold_normalize off) through run_retrieval_eval's RGB route
   with K1-K4: launches, finite R@K, cosine per row against its plain path
   and against the host-s2d eval8 path on the same frames and weights,
   clips/s with the preprocess, peak memory; then one batch of canonical
   256 frames through the centre crop and one through
   three_crop_preprocess (each clip's 3 crops mean-pooled), each against
   its plain path;
8g. F12R, the 12-frame finetune step from uint8 frames (B=16 clips at
   canonical 256, seeded random-resized crop boxes and flips, the model
   batch made on the card by to_model_batch, tools/train.py's route): 5
   steps with the kernels (K1, K5, K2S) and with the plain versions,
   checked as phase 8, clips/s over steps 3-5;
8h. E8F, the 8-frame eval under attention_impl='fused_block' (K6 at N=196
   in every block, unshifted and shifted, on the window-resident layout): K6 (and
   K4, whose norm1 calls K6 takes over) against its plain version at the
   four stage shapes, then the path against its plain path as phase 5c
   (24 K6 launches a forward, cosine per row, clips/s, peak memory);
8i. Q8M, the QA multiple-choice finetune step (configs/exp/finetune_lsmdc_mc.py:
   answer_cls, the MC head; 16 videos of 8 x 224^2, 5 candidates of L=30,
   each video's tokens repeated per candidate through the 3-layer fusion
   tower; AdamW 1.2e-5, clip 50): K1, K5 and K2's stash form at its Swin
   shapes, then 5 steps of make_qa_train_step with the kernels and with the
   plain versions, checked and timed as phase 8;
8j. Q8O, the open-ended QA eval (finetune_msrvttQA.py: answer_cls, 1500
   answers; 64 videos, one question of L=40 each) through make_qa_eval_step
   + run_qa_eval over 3 batches: K1-K4 at its shapes (the text and fusion
   towers' K3 / K4 calls too), launches per forward, per-row score cosine
   against the plain path, both accuracies, clips/s, peak memory;
8k. FIB (finetune_lsmdc_fib.py: the [MASK] readout, 1000 answers), one
   batch of Q8O's shape with one [MASK] a row, checked as 8j;
8l. ITM (bench.py's bench_itm): K3 and K4 at a score call's shapes, score
   calls of 128 cached-token pairs through make_itm_score_step (launches,
   the probabilities' largest gap from plain, pairs/s), then
   run_itm_retrieval_eval end to end over 64 videos x 64 texts on both
   paths (launches, both recall dicts);
8m. TR8, the config-driven trainer and evaluator through the port's entry
   points, in this process: clover_tpu_torch.tools.train on
   configs/exp/rehearsal_retrieval_fullsize.py (Swin-B + BERT-base, 224^2, 8
   frames, the synthetic MSRVTT-shaped split, bf16; 64 train videos in
   batches of 16, 64 val videos in batches of 32) for 2 epochs: exact
   launches (8 steps of K1 / K5 / K2S 24, 4 eval forwards of K1 24, K2 24,
   K3 12, K4 42), finite losses, the eval lines, best.json and the meta
   files; the latest checkpoint restored into a fresh model and optimizer,
   bitwise the trained state, and its eval equal to the trainer's; a
   --resume to 3 epochs (from epoch 2 to step 12); clover_tpu_torch.tools.test
   on the best step (metrics equal to the trainer's eval line); three
   train-loader epochs through one prefetch_to_device call, its pinned
   slots and the recycled host buffers both reused (bitwise the synchronous
   copies); train clips/s over epoch 2, eval
   clips/s, the checkpoints' seconds and bytes, the per-step metric sync's
   cost, peak memory; the temporary work dir removed whether it passes or
   not;
8m'. DP8, data parallel through the train entry: `torchrun --standalone
   --nproc_per_node=W` (W the visible cards) runs clover_tpu_torch.tools.train
   --distributed (NCCL, one process a card) on TR8's config and options,
   TR8's 8 steps of 16 global clips (W ranks of 16 / W) and one eval of
   64 videos at the end, the best checkpoint only; each rank counts its
   launches (a step K1 / K5 / K2S 24, an eval forward TR8's), then 2 more
   steps under torch.profiler for the NCCL time a step, and the gradient
   reduction alone (CUDA events). At W = 1 every
   step's loss and grad_norm bitwise TR8's and the eval line equal; at W >=
   2 step 1's (the one step from the same weights) within 1e-3 relative,
   every step's gap and the eval printed, the eval equal to the test entry's
   on rank 0's best checkpoint (one process, the same weights, at the ranks'
   eval batch), and the run again in fp32 through the model's plain
   versions (the kernels take bf16) on W ranks and on one: every step's loss
   and grad_norm within 1e-4 relative; the ranks' parameters equal after
   the steps; only rank 0's work dir holds metrics.jsonl and the checkpoint;
   clips/s beside TR8's, the NCCL ms a step beside the all-reduce's bound,
   the phase's seconds against its budget of 60 (torchrun's start-up
   included; printed, not a failure);
8n. SRV, serving bundles of the retrieval towers (clover_tpu_torch/serving.py):
   the dress rehearsal's main (tools/dress_rehearsal.py: its synthetic
   image-Swin-B and BERT-base state dicts converted by
   tools/convert_checkpoint.py with the 2D inflation, the patch embed
   against Conv3d, load_from, a bundle at B=2 served against the eager
   model), the converted checkpoint merged into eval8's model; video_tower_b32 (8 x
   224^2 uint8), text_tower_b32 (L=30) and similarity (1000 candidates)
   exported (torch.export: every kernel as its clover::* op, counted in the
   graphs), saved, then loaded and run in a subprocess that imports no
   model module (exact launches a forward); the served embeddings against
   the eager kernel path (bitwise) and the plain bf16 path (cosine per
   row), and no farther from the plain path in fp32 than the plain bf16
   path is, the similarity artifact against
   similarity_fn; artifact and eager clips/s, export seconds, bundle bytes,
   peak memory and K4's host cost a call through its op and direct; then
   the 32-frame towers of configs/exp/finetune_msrvtt_retrieval.py at B=8
   through `python -m clover_tpu_torch.tools.export` on the converted
   checkpoint, one batch against the eager model (K6 24, K2 24, K3 12, K4
   18). Every train phase also checks that no train step calls a registered
   op;
9. print the kernel table as one JSON line (one row per kernel and path:
   launches on the path's run, ms and plain ms summed per forward or step,
   the card's bound for the same work, and one PyTorch library call's time
   where one computes the same function), then the device line.

Bounds: the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s and its matrix products over
989 TFLOP/s bf16 (K4: its fp32 arithmetic over 67 TFLOP/s), per call at the
path's shapes, summed with the call counts. The softmax's exponentials are
not counted. K9 and K10 read the fp32 (nH, N, N) bias and, in shifted
blocks, the fp32 (nW, N, N) mask, each laid out in the order of the
kernels' mma accumulators (one 16-byte load per lane and 8-key tile; the
wrapper lays them out, the Swin model passes the forms it caches); their
rows time the public call with that layout and print the kernel on the
cached forms first. K1 and K11 read the bf16 bias in that order and the
region ids; K1's rows time the public call on the terms the model hands it
("ms": in eval on the cached bias's layout, made once; in training on the
terms gathered from the relative-position table, the gather timed with it
as a step runs it once per block forward) and with the wrapper's layout
("layout_ms"), both bitwise equal, with SDPA beside them. K4's rows time
the public call ("ms") and its launch alone, queued behind a sleep on the
card so that the host's time does not show ("alone_ms"), beside
F.layer_norm ("library_ms").

Nothing here imports JAX: the JAX package is the reference of the CPU tests.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

B, T, S, L = 32, 8, 224, 30     # bench.py's default eval batch
N_BATCHES = 3
SEED = 0
COS_MIN = 0.99                  # kernel-path vs plain-path embeddings, per row
# kernel vs plain, bf16: max|k - p| <= atol + rtol * max|p|. Both round to
# bf16 (2^-8 relative) at different points -- the kernels keep fp32 where
# the plain versions round (logits, pre-GELU hidden, MLP output) -- so
# disagreements of one to a few bf16 ulps of the largest values are expected.
TOL = {"K1": (2e-2, 1e-2), "K2": (2e-2, 2e-2), "K3": (2e-2, 2e-2), "K4": (1e-2, 1e-2),
       "K5": (2e-2, 2e-2), "K2S": (2e-2, 2e-2), "K6": (2e-2, 1e-2),
       # fp32 outputs, both sides in fp32 (summation order and rsqrtf apart):
       # ~1e-7 of max|p| observed; each limit must stay below the error of the
       # same values rounded to bf16 (checked), and rstd's below an eps of
       # 1e-6 for 1e-5 at unit variance (~4.5e-6)
       "K5 dbias": (0.0, 1e-5), "K2S mean": (0.0, 1e-5), "K2S rstd": (0.0, 2e-6),
       "K3M": (2e-2, 2e-2), "K2T": (2e-2, 2e-2), "K7": (2e-2, 2e-2), "K8": (2e-2, 2e-2),
       "K9": (2e-2, 1e-2), "K10": (2e-2, 1e-2), "K11": (2e-2, 1e-2), "K11h": (2e-2, 1e-2)}
# the 32-frame retrieval eval (bench.py's BENCH_FRAMES=32, B=32): every
# Swin block at N=392 through the fused half-block K6
T32, N32_BATCHES = 32, 2
COS32_MIN = 0.999               # kernel-path vs plain-path embeddings, per row
# K6's output is x + branch, bf16: besides the max-error limit in TOL, its
# mean |kernel - plain| must stay below the mean error of the same plain
# output with its branch rounded once more to bf16, bf16(x + bf16(p - x))
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12   # H100 SXM, dense
# the retrieval finetune (bench.py's bench_finetune): B=16 clips of 12 frames,
# and of 32 (BENCH_FRAMES=32, the DiDeMo recipe's frames)
TB, TT = 16, 12
TRAIN_STEPS = 5
# kernel launches per train step: at 12 frames the attention half is K1
# forward, K5 backward; at 32 (N=392) K6 forward, its backward's recompute
# K1 and K5; K2's stash form in every block; LayerNorm and the BERT FFN plain
# (here and in every launch table below, a kernel not named is launched 0 times)
TRAIN_LAUNCHES = {TT: {"K1": 24, "K5": 24, "K2S": 24},
                  T32: {"K6": 24, "K1": 24, "K5": 24, "K2S": 24}}
OPTIM = dict(base_lr=1.2e-5, total_steps=1000, warmup_steps=10)
GRAD_CLIP = 15.0
# kernel path vs plain path at train step 1 (same weights, batch and dropout
# draws): |loss_k - loss_p| / loss_p, the same for grad_norm, and the
# per-tensor gradient cosine (min over tensors with a nonzero gradient; the
# BERT key biases are left out: their gradient is zero in exact arithmetic,
# softmax does not see q.b_k, so both paths hold only rounding noise there)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_COS_MIN = 5e-3, 5e-3, 0.995
# the pretrain step (bench.py's bench_train): B=8 clips of 8 frames, whose
# clean and masked passes make the Swin's and the fusion tower's batch 2B=16;
# every Swin block at N=196 (K1 forward, K5 backward, K2's stash form), the
# fusion tower's FFN on the fused route (K3M: 16 x (4*49 + 30) = 3616 rows >=
# 2048 under fused_mlp_train='auto'), the text tower's 480 rows plain
PB, PT = 8, 8
PRETRAIN_ROWS = 2 * PB * (PT // 2 * 49 + L)
PRETRAIN_OPTIM = dict(base_lr=5e-5, total_steps=1000, warmup_steps=10)
PRETRAIN_LAUNCHES = {"K1": 24, "K5": 24, "K2S": 24, "K3M": 3}
# the TPU's 32-frame pretrain recipe (bench.py's BENCH_FRAMES=32 BENCH_REMAT=0,1,
# tools/hbm_audit.py's 32f-B8-remat01): B=8 clips of 32 x 224^2, the blocks of
# stages 0-1 rematerialised, the MLP stash off, every Swin MLP backward through
# K7 (mlp_bwd='onepass'); N=392 everywhere, so K6 runs each block's attention
# half, again in the 4 recomputed blocks; the fusion tower at 16 latent frames
# takes 16 x (16*49 + 30) = 13024 rows through K3M
PT32 = 32
PRETRAIN32_LAUNCHES = {"K6": 28, "K1": 24, "K5": 24, "K2T": 28, "K7": 24, "K3M": 3}
# the pair's path: the 8-frame pretrain step with the erf GELU, every Swin
# stage rematerialised, the stash off, mlp_bwd='pair' (K8, K7's passes with
# the erf GELU); K1 runs in each block's forward and again in its recompute
PRETRAIN_ERF_STEPS = 3
PRETRAIN_ERF_LAUNCHES = {"K1": 48, "K5": 24, "K2T": 48, "K8": 24, "K3M": 3}
# the recompute backward's fp32 outputs (dln_w, dln_b, dW1, db1, dW2, db2,
# drs) against the plain version run in fp32 on the same inputs: the kernel
# keeps z and dh in fp32 where the plain version rounds them to bf16, so each
# output's max error must be at most 1.5x the bf16 plain version's plus 1e-6
# of max|reference|, and its cosine with the plain version at least 0.9999
BWD_ERR_RATIO, BWD_ERR_FLOOR, BWD_COS_MIN = 1.5, 1e-6, 0.9999
# the spatial / long-window eval paths (phase 5c): SwinConfig fields, clips
# per batch, frames, clip size, batches, kernel launches per forward besides
# K2 24, K3 12, K4 42, the embedding cosine bound (0.999 on every path: K9
# and K10 keep the fp32 bias and mask of their plain versions)
PB8, PS = 4, 256
EVAL_COMMON = {"K2": 24, "K3": 12, "K4": 42}
SPATIAL_PATHS = {
    "E8H": (dict(attention_impl="pallas"), B, T, S, N_BATCHES, {"K9": 24}, COS32_MIN),
    "E8S": (dict(attention_impl="pallas_fused"), B, T, S, N_BATCHES, {"K10": 24}, COS32_MIN),
    "E8P-pallas": (dict(attention_impl="pallas"), PB8, T, PS, N_BATCHES, {"K9": 24},
                   COS32_MIN),
    "E8P-pallas_fused": (dict(attention_impl="pallas_fused"), PB8, T, PS, N_BATCHES,
                         {"K10": 24}, COS32_MIN),
    "E32L-v7": (dict(fused_attn="off", long_attn="v7"), B, T32, S, N32_BATCHES, {"K11": 24},
                COS32_MIN),
    "E32L-v6": (dict(fused_attn="off", long_attn="v6"), B, T32, S, N32_BATCHES, {"K11h": 24},
                COS32_MIN),
}
PRETRAIN_LOSSES = ("mlm_loss", "nce_loss", "rank_t_tm_loss", "v_nce_loss", "rank_v_vm_loss")
# the RGB-frame paths: R8, the 8-frame retrieval eval from uint8 frames at the
# configs' test_canonical_size of 224 (eval_preprocess's normalize-only
# route) with the raw-clip 'conv' embed and fold_normalize off, eval8's
# kernels and launches; then one batch of canonical 256 frames through the
# centre crop and one through three_crop_preprocess (3 crops a clip, their
# features mean-pooled). F12R, the 12-frame finetune step from uint8 frames at
# canonical 256: seeded random-resized crop boxes and flips through
# to_model_batch (tools/train.py's route), the 12-frame train launches,
# timed over steps 3-5 as phase 8
R8_BATCHES, CANON = 2, 256
R8_LAUNCHES = {"K1": 24, "K2": 24, "K3": 12, "K4": 42}
F12R_STEPS = TRAIN_STEPS
# E8F: the 8-frame eval under attention_impl='fused_block', K6 (N=196, LN1
# inside it) in every block; a SPATIAL_PATHS spec
E8F = (dict(attention_impl="fused_block"), B, T, S, 2, {"K6": 24, "K4": 18}, COS32_MIN)
# slice 4 (phases 8i-8l): the QA / multiple-choice / FIB finetune and the ITM
# rerank eval through the fusion tower, on configs/_base_/models/clover_base.py's
# towers (Swin-B, BERT-base, the 3-layer fusion tower over 4 x 49 video tokens).
# Q8M, configs/exp/finetune_lsmdc_mc.py: 16 videos of 8 frames, 5 candidates of
# L=30 each (each video's tokens repeated per candidate: 80 x (196 + 30) fusion
# rows), AdamW 1.2e-5, wd 0.01, betas (0.9, 0.98), clip 50; in training the
# fusion tower's FFN and norms are plain (fused_mlp_train '0')
QB, QN = 16, 5
Q8M_OPTIM = dict(base_lr=1.2e-5, total_steps=1000, warmup_steps=10, weight_decay=0.01,
                 betas=(0.9, 0.98))
Q8M_CLIP = 50.0
Q8M_LAUNCHES = {"K1": 24, "K5": 24, "K2S": 24}
# Q8O, configs/exp/finetune_msrvttQA.py (answer_cls, 1500 answers), and FIB,
# configs/exp/finetune_lsmdc_fib.py (answer_mask, 1000 answers): 64 videos of 8
# frames with one question of L=40 each; an eval forward runs eval8's Swin
# launches, the text tower's K3 12 and K4 13 and the fusion tower's K3 3 and K4 4
# (visual_norm on 64 x 196 rows, an attention_norm a layer on 64 x 236)
OB, OL, O_LABELS, O_BATCHES, FIB_LABELS = 64, 40, 1500, 3, 1000
QA_EVAL_LAUNCHES = {"K1": 24, "K2": 24, "K3": 15, "K4": 46}
# ITM, bench.py's bench_itm: a score call of 128 (cached (4, 49, 1024) bf16
# video tokens, L=30 ids) pairs through the text tower, the fusion tower and
# the ITM head; then run_itm_retrieval_eval over 2 batches of 32 clips (64
# videos x 64 texts, every pair, 128 pairs a call). The scores are match
# probabilities: kernel and plain within ITM_GAP_MAX of each other
ITM_PAIRS, ITM_CALLS, ITM_EVAL_BATCHES, ITM_GAP_MAX = 128, 8, 2, 2e-2
ITM_LAUNCHES = {"K3": 15, "K4": 17}
ITM_EMBED_LAUNCHES = {"K1": 24, "K2": 24, "K3": 12, "K4": 42}
# TR8 (phase 8m): the config-driven trainer and evaluator through the port's
# entry points (clover_tpu_torch.tools.train / .test) on
# configs/exp/rehearsal_retrieval_fullsize.py (Swin-B + BERT-base, 224^2, 8
# frames, L=30, the synthetic MSRVTT-shaped split, the raw-clip 'conv' embed
# from uint8 frames): 64 train videos in batches of 16 (4 steps an epoch, the
# pretrain and Q8M steps' 16-clip 8-frame Swin shapes), 64 val videos in
# batches of 32 (2 forwards an eval, eval8's shapes), bf16, 2 epochs, then a
# resume to 3. A step launches K1 / K5 / K2S 24, an eval forward K1 24, K2 24,
# K3 12, K4 42 (the text tower's 12 post-LN FFNs and 42 LayerNorms)
TR8_CONFIG = os.path.join("configs", "exp", "rehearsal_retrieval_fullsize.py")
TR8_VAL_BATCH = 32
TR8_OPTIONS = ("model.dtype=bfloat16", "total_epochs=2", "log_interval=1",
               "checkpoint.max_to_keep=1", "data.train.n_videos=64",
               "data.train_loader.batch_size=16", "data.val.n_videos=64",
               f"data.val_loader.batch_size={TR8_VAL_BATCH}")
TR8_CLIPS, TR8_STEPS_PER_EPOCH, TR8_FORWARDS_PER_EVAL = 16, 4, 2
TR8_STEP_LAUNCHES = {"K1": 24, "K5": 24, "K2S": 24}
TR8_FORWARD_LAUNCHES = {"K1": 24, "K2": 24, "K3": 12, "K4": 42}
# DP8 (phase 8m'): TR8's run through the train entry's --distributed under
# torchrun, one process a visible card: TR8's options and LR schedule (2
# epochs), the eval at the end only and the best checkpoint only (a save
# costs 3-7 s); each rank's batch 16 / W clips. Against TR8's first run:
# bitwise at W = 1; at W >= 2 step 1 within DP8_LOSS_RTOL (later steps drift:
# the bf16 GEMMs round differently at 16 / W rows, and AdamW amplifies it:
# 2.2e-3 by step 4 at W = 4 on the H100), the eval equal to the test entry's
# on the same weights at the ranks' eval batch (each forward the same
# shapes), and DP8_FP32_OPTIONS (fp32, the plain versions, no eval or save)
# on W ranks against one process, every step within DP8_FP32_RTOL. The gradient
# all-reduce's bound: 2 (W - 1) / W x the fp32 gradient bytes over one
# card's NVLink rate, 450 GB/s each way (H100 SXM, NVLink 4: 18 links)
DP8_OPTIONS = TR8_OPTIONS + ("evaluation.interval=2", "checkpoint.interval=3")
DP8_FP32_OPTIONS = DP8_OPTIONS + ("model.dtype=float32", "evaluation.interval=3")
DP8_FP32_RTOL = 1e-4
DP8_LOSS_RTOL, DP8_PROFILE_STEPS, DP8_SECONDS_MAX, NVLINK_BYTES = 1e-3, 2, 60.0, 450e9
# SRV (phase 8n): serving bundles of the retrieval towers (serving.py). The
# dress rehearsal (tools/dress_rehearsal.py, its main at a batch of 2): its
# synthetic image-Swin-B and BERT-base state dicts in their published key
# schemas, converted by tools/convert_checkpoint.py (the 2D inflation),
# exported and served. The converted checkpoint merged into eval8's model
# (kernels, bf16): video_tower_b32
# (32 clips of 8 x 224^2 uint8, host_s2d swapped to s2d), text_tower_b32
# (L=30) and similarity (1000 candidates) exported, saved, loaded and run in a
# subprocess that imports no model module, SRV_BATCHES batches after one
# untimed. The two towers launch eval8's kernels, through their ops: the
# video graph K1 24, K2 24, K4 29, the text graph K3 12, K4 13. Then the
# 32-frame towers of configs/exp/finetune_msrvtt_retrieval.py (its test
# split's 32 frames, every Swin block through K6) at B=8 through the export
# entry on the converted checkpoint, one batch against the eager model.
SRV_B, SRV_CANDIDATES, SRV_BATCHES = B, 1000, 3
SRV_ROUNDS, SRV_PASSES = 2, 3   # the artifact / eager A B B A rounds
SRV_LAUNCHES = {"K1": 24, "K2": 24, "K3": 12, "K4": 42}
SRV_OPS = {"video": {"k1_window_attention": 24, "k2_ln_mlp_residual": 24, "k4_layer_norm": 29},
           "text": {"k3_mlp_postln": 12, "k4_layer_norm": 13}}
SRV32_B, SRV32_CONFIG = 8, os.path.join("configs", "exp", "finetune_msrvtt_retrieval.py")
SRV32_LAUNCHES = {"K6": 24, "K2": 24, "K3": 12, "K4": 18}
SRV32_OPS = {"video": {"k6_window_attn_block": 24, "k2_ln_mlp_residual": 24, "k4_layer_norm": 5},
             "text": {"k3_mlp_postln": 12, "k4_layer_norm": 13}}
# the served embeddings against the eager kernel path (the same ops, run
# eagerly: bitwise expected), against the plain bf16 path (min cosine per
# row; read 0.999982-0.999983 video, 0.999885-0.999921 text on the H100,
# by the projection head's seeded init) and against the plain path in fp32:
# no farther from it than the plain bf16 path is, less SRV_FP32_MARGIN
# (read video / text 0.999879-0.999898 / 0.999895-0.999920 served,
# 0.999884-0.999895 / 0.999892-0.999913 plain bf16)
SRV_GAP_MAX, SRV_COS_MIN, SRV_FP32_MARGIN = 1e-3, 0.9998, 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]


def peak_memory(dev) -> str:
    """The device memory peak since the last reset: allocated (whole
    allocator blocks, as max_memory_allocated counts them) and requested
    (the bytes the tensors asked for, which the allocator's rounding does
    not move)."""
    import torch

    st = torch.cuda.memory_stats(dev)
    return (f"{st['allocated_bytes.all.peak'] / 2**30:.2f} GiB "
            f"(requested {st['requested_bytes.all.peak'] / 2**20:.1f} MiB)")


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def path_shapes(cfg, frames=T, clips=B, text_len=L):
    """Per-forward kernel calls of the eval path at ``frames`` frames over
    ``clips`` clips, one text of ``text_len`` tokens each: {kernel: [(args,
    count)]}. A block whose window has N >= 384 tokens runs
    LN1 + attention + proj as K6 (SwinConfig.fused_attn 'auto'), and so does
    every block under attention_impl='fused_block' (no stage here pads);
    else LN1 as K4 and the attention as K1. A QA model's fusion tower adds
    its calls (fusion_shapes)."""
    from clover_tpu_torch.models.swin3d import (_shift_region_ids, effective_window,
                                                fused_attn_enabled)

    sw = cfg.swin
    dims = (frames // sw.patch_size[0], S // sw.patch_size[1], S // sw.patch_size[2])
    shift = tuple(s // 2 for s in sw.window_size)
    calls = {"K1": [], "K2": [], "K3": [], "K4": [], "K6": []}
    calls["K4"].append(((clips * int(np.prod(dims)), sw.embed_dim), 1))      # patch norm
    for i, depth in enumerate(sw.depths):
        C, nH = sw.embed_dim * 2 ** i, sw.num_heads[i]
        rows = clips * int(np.prod(dims))
        window, sh = effective_window(dims, sw.window_size, shift)
        N = int(np.prod(window))
        ids = _shift_region_ids(dims, window, sh)
        n_shifted = depth // 2 if ids is not None else 0
        fused = fused_attn_enabled(sw.fused_attn, N) or sw.attention_impl == "fused_block"
        check(not any(d % w for d, w in zip(dims, window)), f"stage {i} pads")
        attn = "K6" if fused else "K1"
        calls[attn].append(((rows // N, N, nH, None), depth - n_shifted))
        if n_shifted:
            calls[attn].append(((rows // N, N, nH, ids), n_shifted))
        calls["K2"].append(((rows, C), depth))
        if not fused:
            calls["K4"].append(((rows, C), depth))                           # norm1
        if i < len(sw.depths) - 1:
            dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
            calls["K4"].append(((clips * int(np.prod(dims)), 4 * C), 1))     # merging
    calls["K4"].append(((clips * int(np.prod(dims)), sw.num_features), 1))   # final norm
    for extra in (text_shapes(cfg, clips, text_len),
                  fusion_shapes(cfg, clips, text_len) if cfg.qa else {}):
        for k, v in extra.items():
            calls[k] += v
    return calls


def text_shapes(cfg, texts, text_len):
    """The BERT text tower's K3 / K4 calls over ``texts`` texts of
    ``text_len`` tokens: the FFN halves, the embedding and attention norms."""
    bt = cfg.text_bert
    rows = texts * text_len
    return {"K3": [((rows, bt.hidden_size), bt.num_hidden_layers)],
            "K4": [((rows, bt.hidden_size), 1 + bt.num_hidden_layers)]}


def fusion_shapes(cfg, texts, text_len):
    """The fusion tower's K3 / K4 calls over ``texts`` texts of ``text_len``
    tokens, each with its video's T x S tokens: the FFN halves and the
    attention norms on (T S + text_len) rows a text, visual_norm on T S."""
    fu = cfg.fusion
    vis = fu.num_frames * fu.spatial_tokens
    rows, layers = texts * (vis + text_len), fu.bert.num_hidden_layers
    return {"K3": [((rows, fu.hidden_size), layers)],
            "K4": [((texts * vis, fu.hidden_size), 1), ((rows, fu.hidden_size), layers)]}


def bound_ms(flops=0.0, nbytes=0.0, fp32_ops=0.0):
    """(operations, bytes) lower bounds in ms of one call on the card."""
    return ((flops / PEAK_BF16 + fp32_ops / PEAK_FP32) * 1e3, nbytes / PEAK_BYTES * 1e3)


def attention_work(Bn, N, nH, ids, products=2, row_widths=4, dbias=False, bias_bytes=4,
                   mask_bytes=0):
    """Window attention's bound: ``products`` N x N x 32 matrix products per
    (window, head); ``row_widths`` x C bf16 activations per token (K1: qkv
    in, out; K5: qkv and g in, dqkv out); the bias at ``bias_bytes`` an
    entry (and the fp32 dbias), the region ids, ``mask_bytes`` of mask."""
    C = nH * 32
    nbytes = (Bn * N * row_widths * C * 2 + nH * N * N * (bias_bytes + (4 if dbias else 0))
              + (0 if ids is None else ids.size * 4) + mask_bytes)
    return bound_ms(flops=products * 2 * Bn * nH * N * N * 32, nbytes=nbytes)


def attn_block_work(Bn, N, C, nH, ids, extra_bytes=0):
    """K6's bound: the qkv, attention and proj products; x in, out, the fp32
    weights and biases, the fp32 bias, the region ids."""
    return bound_ms(flops=2 * Bn * N * (4 * C * C + 2 * N * C),
                    nbytes=4 * Bn * N * C + 16 * C * C + 24 * C + 4 * nH * N * N
                    + (0 if ids is None else ids.size * 4) + extra_bytes)


def mlp_work(rows, C, H, extra_bytes=0):
    """The MLP half's bound: two rows x C x H products; x in, out, the fp32
    weights and biases."""
    return bound_ms(flops=4 * rows * C * H,
                    nbytes=4 * rows * C + 8 * C * H + 4 * (H + 3 * C) + extra_bytes)


def sdpa_ms(qkv, bias, nH, N, scale, reps, grad=None):
    """One F.scaled_dot_product_attention call on the same q, k, v (laid out
    (Bn, nH, N, 32) outside the timing) with the bias as a broadcast float
    mask; with ``grad``, its backward with the mask requiring grad."""
    import torch
    import torch.nn.functional as F

    Bn = qkv.shape[0] // N
    q, k, v = qkv.view(Bn, N, 3, nH, 32).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
    mask = bias.to(qkv.dtype)[None]
    if grad is None:
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                              scale=scale), reps)
    q, k, v, mask = (t.detach().requires_grad_() for t in (q, k, v, mask))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    g = grad.view(Bn, N, nH, 32).permute(0, 2, 1, 3)
    return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v, mask), g, retain_graph=True),
                   reps)


def sdpa_heads_ms(q, k, v, bias, mask, scale, reps):
    """One F.scaled_dot_product_attention call on head-major q, k, v (Bn,
    nH, N, 32) with bias + mask as one float mask: window b's (nW, nH) pair
    is a head of a (Bn / nW, nW * nH) batch, so the (nW, nH, N, N) mask
    broadcasts as the kernels read it."""
    import torch.nn.functional as F

    Bn, nH, N, hd = q.shape
    nW = 1 if mask is None else mask.shape[0]
    fm = bias[None] if mask is None else bias[None] + mask[:, None]
    fm = fm.to(q.dtype).reshape(1, nW * nH, N, N)
    q4, k4, v4 = (t.view(Bn // nW, nW * nH, N, hd) for t in (q, k, v))
    return cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=fm, scale=scale),
                   reps)


def spatial_shapes(sw, clips, frames, size):
    """The attention calls of one eval forward on the spatial / flat paths
    of B=``clips`` clips of ``frames`` x ``size``^2: [(stage, padded dims,
    window, shift or None, heads, calls)] per stage, unshifted and shifted
    (the padded dims are the token dims rounded up to whole windows)."""
    from clover_tpu_torch.models.swin3d import effective_window

    dims = (frames // sw.patch_size[0], size // sw.patch_size[1], size // sw.patch_size[2])
    shift = tuple(w // 2 for w in sw.window_size)
    out = []
    for i, depth in enumerate(sw.depths):
        window, sh = effective_window(dims, sw.window_size, shift)
        padded = tuple(-(-d // w) * w for d, w in zip(dims, window))
        n_shifted = depth // 2 if any(sh) else 0
        out.append((i, padded, window, None, sw.num_heads[i], depth - n_shifted))
        if n_shifted:
            out.append((i, padded, window, sh, sw.num_heads[i], n_shifted))
        dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
    return out


def spatial_kernel_phase(sw, dev, seed=SEED + 11):
    """K9, K10 and K11 against their plain versions at the shapes of the
    phase-5c paths (every stage, unshifted and shifted), bf16, with the
    bound and SDPA's time on the same q, k, v (bias + mask as a float mask;
    K11: bias + the region mask); K9 and K10 also on the bias and mask laid
    out before, as the model passes them. -> {path: results}, times per
    forward."""
    import torch

    from clover_tpu_torch import ops
    from clover_tpu_torch.models.swin3d import _shift_region_ids, shift_attn_mask

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    scale = 32 ** -0.5
    out = {}
    for path, (clips, frames, size, keys) in {
            "E8H": (B, T, S, ("K9",)), "E8S": (B, T, S, ("K10",)),
            "E8P": (PB8, T, PS, ("K9", "K10")), "E32L": (B, T32, S, ("K11", "K11h"))}.items():
        results = out.setdefault(path, {})
        record = recorder(results, "forward")
        for stage, padded, window, shift, nH, count in spatial_shapes(sw, clips, frames, size):
            N = int(np.prod(window))
            grid = tuple(p // w for p, w in zip(padded, window))
            Bn = clips * int(np.prod(grid))
            label = (f"stage {stage} B={clips} grid={padded} Bn={Bn} N={N} nH={nH} "
                     f"mask={'yes' if shift else 'no'}")
            bias = randn(nH, N, N, dtype=torch.float32)
            if "K11" in keys:
                ids = None if shift is None else _shift_region_ids(padded, window, shift)
                rid = None if ids is None else torch.from_numpy(ids).to(dev)
                qkv = randn(Bn * N, 3 * nH * 32)
                q, k, v = ops.window_attention.heads_from_flat(qkv, nH, N)
                fm = None if rid is None else ops.window_attention.region_mask(rid, torch.float32)
                lib = sdpa_heads_ms(q, k, v, bias.bfloat16().float(), fm, scale, 3)
                p = lambda: ops.window_attention_flat_flash_plain(   # noqa: E731
                    qkv, bias, rid, scale, nH, N)
                ref, t_p = p(), cuda_ms(p, 2)
                work = attention_work(Bn, N, nH, ids, bias_bytes=2)
                for key, name, fn in (
                        ("K11", "flat_flash_window_attention",
                         lambda: ops.flat_flash_window_attention(qkv, bias, rid, scale, nH, N)),
                        ("K11h", "flash_window_attention",
                         lambda: ops.flash_window_attention(q, k, v, bias, rid, scale))):
                    got = fn()
                    got = got if key == "K11" else ops.window_attention.flat_from_heads(got)
                    record(key, name, label, got, ref, cuda_ms(fn, 3), t_p, count, work=work,
                           lib=lib)
                del qkv, q, k, v, ref
                continue
            mask = None if shift is None else torch.from_numpy(
                shift_attn_mask(padded, window, shift)).to(dev)
            work = attention_work(Bn, N, nH, None,
                                  mask_bytes=0 if mask is None else mask.numel() * 4)
            qkv5 = randn(clips, *padded, 3, nH, 32)
            q, k, v = (t.contiguous() for t in ops.window_attention.spatial_heads(qkv5, window))
            lib = sdpa_heads_ms(q, k, v, bias, mask, scale, 3)
            # the bias and mask in accumulator order, as the model caches them
            terms = (ops.window_attention.bias_terms(bias, N),
                     None if mask is None else ops.window_attention.mask_terms(mask, N))
            if "K9" in keys:
                kf = lambda: ops.fused_window_attention(q, k, v, bias, mask, scale)   # noqa: E731
                cf = lambda: ops.fused_window_attention(   # noqa: E731
                    q, k, v, bias, mask, scale, terms)
                pf = lambda: ops.window_attention_heads_plain(   # noqa: E731
                    q, k, v, bias, mask, scale)
                print(f"K9 {label}: kernel on the cached terms {cuda_ms(cf, 3):.4f} ms x{count}")
                record("K9", "fused_window_attention", label, kf(), pf(), cuda_ms(kf, 3),
                       cuda_ms(pf, 2), count, work=work, lib=lib)
            if "K10" in keys:
                grid_mask = None if mask is None else mask.view(*grid, N, N)
                kf = lambda: ops.spatial_window_attention(   # noqa: E731
                    qkv5, bias, grid_mask, window, scale)
                cf = lambda: ops.spatial_window_attention(   # noqa: E731
                    qkv5, bias, grid_mask, window, scale, terms)
                pf = lambda: ops.spatial_window_attention_plain(   # noqa: E731
                    qkv5, bias, grid_mask, window, scale)
                print(f"K10 {label}: kernel on the cached terms {cuda_ms(cf, 3):.4f} ms x{count}")
                record("K10", "spatial_window_attention", label, kf(), pf(), cuda_ms(kf, 3),
                       cuda_ms(pf, 2), count, work=work, lib=lib)
            del qkv5, q, k, v, terms
        torch.cuda.empty_cache()
    return out


def kernel_phase(cfg, dev, frames=T, seed=SEED, keys=("K1", "K2", "K3", "K4", "K6"), clips=B,
                 text_len=L, calls=None):
    """Each kernel of ``keys`` against its plain version at the path's
    shapes (``calls``, path_shapes(cfg, frames, clips, text_len) by
    default), with its bound and (K1, K4) one library call's time at the
    same shapes."""
    import torch
    import torch.nn.functional as F

    from clover_tpu_torch import ops
    from clover_tpu_torch.models.swin3d import _shift_region_ids
    from clover_tpu_torch.ops.heads_sweep import queued_ms

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    results = {}
    calls = calls or path_shapes(cfg, frames, clips, text_len)
    calls = {k: v if k in keys else [] for k, v in calls.items()}
    if frames == T and calls["K1"]:
        # the region mask at nH=32 too (stage 3 has no shifted block at 8 frames)
        ids_extra = _shift_region_ids((4, 14, 14), (4, 7, 7), (0, 3, 3))[:1]
        calls["K1"].append(((clips, 196, 32, ids_extra), 0))

    record = recorder(results, "forward")
    scale = 32 ** -0.5
    library = {}   # K1's library call per unshifted shape, for its shifted calls too

    for (Bn, N, nH, ids), count in calls["K1"]:
        C = nH * 32
        qkv = randn(Bn * N, 3 * C)
        bias = randn(nH, N, N, dtype=torch.float32)
        rid = None if ids is None else torch.from_numpy(ids).to(dev)
        k, kl, _ = k1_calls(qkv, bias, rid, scale, nH, N)
        p = lambda: ops.window_attention_plain(qkv, bias, rid, scale, nH, N)   # noqa: E731
        if ids is None:
            library[(Bn, N, nH)] = sdpa_ms(qkv, bias, nH, N, scale, 5)
        record("K1", "flat2_window_attention", f"Bn={Bn} N={N} nH={nH} "
               f"mask={'yes' if ids is not None else 'no'}", k1_checked(k, kl), p(),
               cuda_ms(k, 5), cuda_ms(p, 5), count, work=attention_work(Bn, N, nH, ids),
               lib=library.get((Bn, N, nH), 0.0), layout=cuda_ms(kl, 5))

    for (Bn, N, nH, ids), count in calls["K6"]:
        C = nH * 32
        x, w = randn(Bn * N, C), attn_block_weights(randn, C)
        bias = randn(nH, N, N, dtype=torch.float32)
        rid = None if ids is None else torch.from_numpy(ids).to(dev)
        args = (x, w[0], w[1], w[2], w[3], bias, rid, w[4], w[5], scale, nH, N)
        k = lambda: ops.fused_window_attn_block(*args)   # noqa: E731
        p = lambda: ops.window_attn_block_plain(*args)   # noqa: E731
        record("K6", "fused_window_attn_block", f"Bn={Bn} N={N} C={C} nH={nH} "
               f"mask={'yes' if ids is not None else 'no'}", k(), p(), cuda_ms(k, 3),
               cuda_ms(p, 2), count, work=attn_block_work(Bn, N, C, nH, ids))
        del x, bias, args

    for (rows, C), count in calls["K2"]:
        x, w = randn(rows, C), mlp_weights(randn, C, 4 * C)
        k = lambda: ops.fused_ln_mlp_residual(x, *w, 1e-5, cfg.swin.gelu)   # noqa: E731
        p = lambda: ops.ln_mlp_residual_plain(x, *w, 1e-5, cfg.swin.gelu)   # noqa: E731
        out = k()
        record("K2", "fused_ln_mlp_residual", f"rows={rows} C={C}", out, p(),
               cuda_ms(k, 5), cuda_ms(p, 5), count, work=mlp_work(rows, C, 4 * C))
        if frames == T and C == 4 * cfg.swin.embed_dim:
            k2_chunks_check(k, out, rows, C)

    for (rows, C), count in calls["K3"]:
        H = cfg.text_bert.intermediate_size   # the fusion tower's too
        x, w = randn(rows, C), mlp_weights(randn, C, H)
        eps = cfg.text_bert.layer_norm_eps
        k = lambda: ops.fused_mlp_postln(x, *w, eps)   # noqa: E731
        p = lambda: ops.mlp_postln_plain(x, *w, eps)   # noqa: E731
        record("K3", "fused_mlp_postln", f"rows={rows} C={C}", k(), p(),
               cuda_ms(k, 20), cuda_ms(p, 20), count, work=mlp_work(rows, C, H))

    for (rows, C), count in calls["K4"]:
        x = randn(rows, C)
        w = 1 + randn(C, std=0.1, dtype=torch.float32)
        b = randn(C, std=0.1, dtype=torch.float32)
        wb, bb = w.bfloat16(), b.bfloat16()
        k = lambda: ops.fused_layer_norm(x, w, b, 1e-5)   # noqa: E731
        p = lambda: ops.layer_norm_plain(x, w, b, 1e-5)   # noqa: E731
        lib = cuda_ms(lambda: F.layer_norm(x, (C,), wb, bb, 1e-5), 10)
        record("K4", "fused_layer_norm", f"rows={rows} C={C}", k(), p(),
               cuda_ms(k, 10), cuda_ms(p, 10), count,
               work=bound_ms(fp32_ops=8 * rows * C, nbytes=4 * rows * C + 8 * C), lib=lib,
               alone=queued_ms(k, 10))
    return results


def k1_calls(qkv, bias, rid, scale, nH, N):
    """K1's public call on the terms the model hands it (the bias laid out
    in accumulator order once, as the eval cache's and the table gather's
    are) and with the wrapper's layout; -> (on terms, with layout, terms)."""
    import torch

    from clover_tpu_torch import ops
    from clover_tpu_torch.ops import window_attention as wa

    terms = wa.fragment_bias(bias.to(torch.bfloat16), N, wa.key_tiles(N))
    return (lambda: ops.flat2_window_attention(qkv, bias, rid, scale, nH, N, terms),
            lambda: ops.flat2_window_attention(qkv, bias, rid, scale, nH, N), terms)


def k1_checked(k, kl):
    """K1's output on the model's terms, checked bitwise against a second
    call and against the call with the wrapper's layout."""
    import torch

    out, again, laid = k(), k(), kl()
    torch.cuda.synchronize()
    check(torch.equal(out, again), "K1: two calls on the same inputs differ")
    check(torch.equal(out, laid), "K1: the model's terms and the wrapper's layout differ")
    return out


def k2_chunks_check(k, planned, rows, C):
    """K2 at one eval shape run again with its chunk caps set so that the
    passes take the rows in one chunk and in 3: each bitwise the call in
    the plan's chunks, and two calls bitwise equal."""
    import torch

    from clover_tpu_torch.ops import mlp_block as mb

    H = 4 * C
    again = k()
    caps = mb._K2_CHUNK_BYTES, mb._K2_HIDDEN_OVER_X
    outs, counts = [], []
    try:
        mb._K2_HIDDEN_OVER_X = H // C
        for cap in (caps[0], -(-rows // (3 * mb._K2_TILE)) * mb._K2_TILE * 2 * (C + H)):
            mb._K2_CHUNK_BYTES = cap
            counts.append(len(mb.k2_plan(rows, C, H, mb._K2_HIDDEN_OVER_X)))
            outs.append(k())
    finally:
        mb._K2_CHUNK_BYTES, mb._K2_HIDDEN_OVER_X = caps
    torch.cuda.synchronize()
    same = torch.equal(again, planned)
    same1, same3 = (torch.equal(o, planned) for o in outs)
    print(f"K2 rows={rows} C={C}: two calls bitwise equal {same}; the plan's "
          f"{len(mb.k2_plan(rows, C, H, caps[1]))} chunks bitwise {counts[0]} chunk {same1} "
          f"and {counts[1]} chunks {same3}", flush=True)
    check(counts == [1, 3] and same and same1 and same3,
          f"K2 rows={rows} C={C}: chunks change the bits")


def recorder(results, per):
    """record(key, name, label, out, ref, t_k, t_p, count, part, work, lib, err,
    layout, alone): check one kernel output against its plain version
    (``err`` given: an error the caller has checked against its own limits),
    print it, and add the times (count calls per ``per``) to results[key]:
    kernel and plain ms, the bound (``work``: (operations ms, bytes ms) of
    one call), the library call's ms (``lib``; None where no PyTorch call
    computes the function), K1's public call with the wrapper's layout
    (``layout``) and K4's launch alone, queued behind a sleep on the card
    so that the host's time does not show (``alone``)."""
    import torch

    def record(key, name, label, out, ref, t_k, t_p, count, part=None, work=None, lib=None,
               err=None, layout=None, alone=None):
        checked = err is not None   # the caller held the output to its own limits
        if not checked:
            err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        atol, rtol = TOL[f"{key} {part}" if f"{key} {part}" in TOL else key] if not checked else (
            float("inf"), 0.0)
        tol = atol + rtol * scale
        ok = err <= tol and bool(torch.isfinite(out).all())
        control = ""
        if ref.dtype == torch.float32 and not checked:
            # the same values rounded to bf16: a limit above this would pass
            # an output stored or summed in bf16
            ctrl = (ref.bfloat16().float() - ref).abs().max().item()
            control = f" bf16 control={ctrl:.3e}"
            check(tol < ctrl, f"{key} {label}: limit {tol:.3e} does not separate a bf16 output "
                              f"({ctrl:.3e})")
        label = label if part is None else f"{label} {part}"
        extra = ""
        if work is not None:
            extra = f" bound={max(work):.4f} ms ({'operations' if work[0] >= work[1] else 'bytes'})"
        if lib is not None:
            extra += f" library={lib:.4f} ms"
        if layout is not None:
            extra += f" with the wrapper's layout={layout:.4f} ms"
        if alone is not None:
            extra += f" launch alone={alone:.4f} ms"
        print(f"{key} {name} {label}: max_abs_err={err:.3e} max|plain|={scale:.3e} "
              f"rel={err / max(scale, 1e-30):.2e} tol={tol:.3e}{control} "
              f"kernel={t_k:.4f} ms plain={t_p:.4f} ms{extra} x{count}/{per} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        r = results.setdefault(key, {"name": name, "err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                     "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                                     "library_ms": None})
        r["err"] = max(r["err"], err)
        r["ms"] += t_k * count
        r["plain_ms"] += t_p * count
        if work is not None:
            r["bound_ms"] += max(work) * count
            r["ops_ms"] += work[0] * count
            r["bytes_ms"] += work[1] * count
        if lib is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib * count
        if layout is not None:
            r["layout_ms"] = r.get("layout_ms", 0.0) + layout * count
        if alone is not None:
            r["alone_ms"] = r.get("alone_ms", 0.0) + alone * count
        check(ok, f"{key} {label}: kernel disagrees with its plain version")

    return record


def attn_block_weights(randn, C):
    """LN1 scale / bias, qkv (3C, C) and its bias, proj (C, C) and its bias,
    fp32, in torch Linear layout."""
    import torch

    f = torch.float32
    return (1 + randn(C, std=0.1, dtype=f), randn(C, std=0.1, dtype=f),
            randn(3 * C, C, std=C ** -0.5, dtype=f), randn(3 * C, std=0.1, dtype=f),
            randn(C, C, std=C ** -0.5, dtype=f), randn(C, std=0.1, dtype=f))


def train_path_shapes(cfg, frames=TT):
    """Per-step kernel calls of a train step of TB clips at ``frames`` frames:
    {kernel: [(args, count)]} (K1: (args, count, K5's count, window, the
    table gathers of its terms, one a block forward)). K1 and K5 run
    once per Swin block at the same shapes (below N=384 K1 in the forward;
    at N >= 384 in the recompute of K6's backward, K6 in the forward). The
    MLP half runs K2's stash form once per block, or with the stash off K2's
    training form and the recompute backward (K7, or K8).
    A block of a rematerialised stage runs its forward twice (K1 below
    N=384, K6, K2). LayerNorm and the BERT FFN stay plain in training."""
    from clover_tpu_torch.models.swin3d import (_shift_region_ids, effective_window,
                                                fused_attn_enabled)

    sw = cfg.swin
    dims = (frames // sw.patch_size[0], S // sw.patch_size[1], S // sw.patch_size[2])
    shift = tuple(s // 2 for s in sw.window_size)
    calls = {"K1": [], "K2S": [], "K6": [], "K2T": [], "K7": [], "K8": []}
    for i, depth in enumerate(sw.depths):
        C, nH = sw.embed_dim * 2 ** i, sw.num_heads[i]
        rows = TB * int(np.prod(dims))
        window, sh = effective_window(dims, sw.window_size, shift)
        N = int(np.prod(window))
        ids = _shift_region_ids(dims, window, sh)
        n_shifted = depth // 2 if ids is not None else 0
        fwd = 2 if sw.remat_stage(i) else 1
        fused = fused_attn_enabled(sw.fused_attn, N)
        for mask, n in ((None, depth - n_shifted), (ids, n_shifted)):
            if n:
                calls["K1"].append(((rows // N, N, nH, mask), n if fused else fwd * n, n,
                                    window, fwd * n))
                if fused:
                    calls["K6"].append(((rows // N, N, nH, mask), fwd * n))
        if sw.mlp_stash:
            calls["K2S"].append(((rows, C), depth))
        else:
            calls["K2T"].append(((rows, C), fwd * depth))
            calls["K7" if sw.mlp_bwd == "onepass" else "K8"].append(((rows, C), depth))
        dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
    return calls


def train_kernel_phase(cfg, dev, results, frames=TT, seed=SEED + 1):
    """K1, K5, K2's stash form (or, with the stash off, its training form and
    K7 or K8) and, at 32 frames, K6 with a row scale against their
    plain versions at the shapes of a train step of TB clips; times per
    train step."""
    import torch

    from clover_tpu_torch import ops
    from clover_tpu_torch.models.swin3d import (_shift_region_ids, bias_from_table,
                                                k1_terms_from_table, table_ext)
    from clover_tpu_torch.ops.bwd_sweep import launch_ms
    from clover_tpu_torch.ops import window_attention as wa

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    record = recorder(results, "step")
    calls = train_path_shapes(cfg, frames)
    if frames == TT:
        # the region mask at nH=32 too (stage 3 has no shifted block at 12 frames)
        ids_extra = _shift_region_ids((6, 14, 14), (6, 7, 7), (0, 3, 3))[:1]
        calls["K1"].append(((TB, 294, 32, ids_extra), 0, 0, (6, 7, 7), 0))
    scale = 32 ** -0.5
    full = tuple(cfg.swin.window_size)
    library = {}   # SDPA forward and backward per unshifted shape
    for (Bn, N, nH, ids), count, count5, window, gathers in calls["K1"]:
        C = nH * 32
        qkv, grad = randn(Bn * N, 3 * C), randn(Bn * N, C)
        table = randn(int(np.prod([2 * w - 1 for w in full])), nH, dtype=torch.float32)
        bias = bias_from_table(table, full, window, nH)
        rid = None if ids is None else torch.from_numpy(ids).to(dev)
        label = f"Bn={Bn} N={N} nH={nH} mask={'yes' if ids is not None else 'no'}"
        if ids is None:
            library[Bn, N, nH] = (sdpa_ms(qkv, bias, nH, N, scale, 5),
                                  sdpa_ms(qkv, bias, nH, N, scale, 3, grad))
        lib_f, lib_b = library.get((Bn, N, nH), (0.0, 0.0))
        # K1 on the terms gathered from the table in the same call, as a
        # block's forward runs it (K6's recompute at N >= 384 reads the
        # terms of its forward: the gathers past one a K1 call are added)
        ext = table_ext(table)   # the module's kept buffer
        gather = lambda: k1_terms_from_table(table, full, window, ext)   # noqa: E731
        terms = gather()
        check(torch.equal(terms, wa.fragment_bias(bias.bfloat16(), N, wa.key_tiles(N))),
              f"K1 {label}: the table's gather differs from the wrapper's layout")
        k = lambda: ops.flat2_window_attention(qkv, bias, rid, scale, nH, N,   # noqa: E731
                                               gather())
        kl = lambda: ops.flat2_window_attention(qkv, bias, rid, scale, nH, N)   # noqa: E731
        p = lambda: ops.window_attention_plain(qkv, bias, rid, scale, nH, N)   # noqa: E731
        t_gather, t_k = cuda_ms(gather, 5), cuda_ms(k, 5)
        print(f"K1 {label}: the table gather {t_gather:.4f} ms x{gathers}/step", flush=True)
        record("K1", "flat2_window_attention", label, k1_checked(k, kl), p(),
               t_k + (gathers - count) * t_gather / max(count, 1), cuda_ms(p, 3), count,
               work=attention_work(Bn, N, nH, ids), lib=lib_f, layout=cuda_ms(kl, 5))
        # K5 on the terms the model gathers (its transposed form gathered
        # from them), as the step runs it; bitwise the call that lays both
        # out itself
        kb = lambda: ops.flat2_window_attention_bwd(   # noqa: E731
            qkv, bias, rid, grad, scale, nH, N, terms)
        pb = lambda: ops.window_attention_bwd_plain(   # noqa: E731
            qkv, bias, rid, grad, scale, nH, N)
        (dqkv, dbias), (rdqkv, rdbias) = kb(), pb()
        laid = ops.flat2_window_attention_bwd(qkv, bias, rid, grad, scale, nH, N)
        check(torch.equal(dqkv, laid[0]) and torch.equal(dbias, laid[1]),
              f"K5 {label}: the model's terms and the wrapper's layout differ")
        del laid
        t_k, t_p = cuda_ms(kb, 5), cuda_ms(pb, 2)
        print(f"K5 launches {label} (device ms per call, torch.profiler): " + "; ".join(
            f"{n} {t:.4f}" for n, t in launch_ms(kb, 3).items()), flush=True)
        record("K5", "flat2_window_attention_bwd", label, dqkv, rdqkv, t_k, t_p, count5, "dqkv",
               work=attention_work(Bn, N, nH, ids, products=5, row_widths=7, dbias=True),
               lib=lib_b)
        record("K5", "flat2_window_attention_bwd", label, dbias, rdbias, 0.0, 0.0, 0, "dbias")
        del qkv, grad, dqkv, dbias, rdqkv, rdbias

    for (Bn, N, nH, ids), count in calls["K6"]:
        # DropPath's per-window row scale, one factor per sample: every
        # fourth sample's windows 0, the rest 1/0.9
        C = nH * 32
        keep = torch.where(torch.arange(TB, device=dev) % 4 == 1, 0.0, 1 / 0.9)
        rs = keep.repeat_interleave(Bn // TB)
        x, w = randn(Bn * N, C), attn_block_weights(randn, C)
        bias = randn(nH, N, N, dtype=torch.float32)
        rid = None if ids is None else torch.from_numpy(ids).to(dev)
        args = (x, w[0], w[1], w[2], w[3], bias, rid, w[4], w[5], scale, nH, N, 1e-5, rs)
        k = lambda: ops.fused_window_attn_block(*args)   # noqa: E731
        p = lambda: ops.window_attn_block_plain(*args)   # noqa: E731
        out = k()
        for b in (rs == 0).nonzero().flatten().tolist():
            check(torch.equal(out.view(Bn, N, C)[b], x.view(Bn, N, C)[b]),
                  f"K6 row scale: dropped window {b} does not pass x through")
        record("K6", "fused_window_attn_block", f"Bn={Bn} N={N} C={C} nH={nH} "
               f"mask={'yes' if ids is not None else 'no'} row_scale=yes", out, p(),
               cuda_ms(k, 3), cuda_ms(p, 2), count, work=attn_block_work(Bn, N, C, nH, ids, 4 * Bn))
        del x, bias, args, out

    for (rows, C), count in calls["K2S"]:
        x, w = randn(rows, C), mlp_weights(randn, C, 4 * C)
        # DropPath's per-sample factor, repeated over each sample's tokens; the
        # step runs every block but the first with one, so it is timed with
        keep = (torch.rand(TB, generator=g, device=dev) < 0.9).float() / 0.9
        for rs in (None, keep.repeat_interleave(rows // TB)):
            label = f"rows={rows} C={C} row_scale={'yes' if rs is not None else 'no'}"
            k = lambda: ops.fused_ln_mlp_residual_stash(   # noqa: E731
                x, *w, 1e-5, cfg.swin.gelu, rs)
            p = lambda: ops.ln_mlp_residual_plain(   # noqa: E731
                x, *w, 1e-5, cfg.swin.gelu, row_scale=rs, want_stash=True)
            (out, stash), (ref, rstash) = k(), p()
            t_k, t_p = (cuda_ms(k, 5), cuda_ms(p, 5)) if rs is not None else (0.0, 0.0)
            n = count if rs is not None else 0
            # the stash: z (rows, 4C) bf16, mean and rstd fp32; the row scale
            work = mlp_work(rows, C, 4 * C, extra_bytes=8 * rows * C + 12 * rows)
            record("K2S", "fused_ln_mlp_residual_stash", label, out, ref, t_k, t_p, n, "out",
                   work=work)
            for part, a, b in zip(("z", "mean", "rstd"), stash, rstash):
                record("K2S", "fused_ln_mlp_residual_stash", label, a, b, 0.0, 0.0, 0, part)

    for (rows, C), count in calls["K2T"]:
        x, w = randn(rows, C), mlp_weights(randn, C, 4 * C)
        rs = sample_scale(g, dev, rows)
        k = lambda: ops.fused_ln_mlp_residual_train(x, *w, 1e-5, cfg.swin.gelu, rs)   # noqa: E731
        p = lambda: ops.ln_mlp_residual_plain(x, *w, 1e-5, cfg.swin.gelu, rs)   # noqa: E731
        record("K2T", "fused_ln_mlp_residual_train", f"rows={rows} C={C} row_scale=yes", k(), p(),
               cuda_ms(k, 5), cuda_ms(p, 5), count, work=mlp_work(rows, C, 4 * C, 4 * rows))
        del x

    for key in ("K7", "K8"):
        for (rows, C), count in calls[key]:
            # block 0 (stage 0) has DropPath rate 0: no row scale there
            scales = (None, sample_scale(g, dev, rows)) if C == cfg.swin.embed_dim else (
                sample_scale(g, dev, rows),)
            for rs in scales:
                n = (1 if rs is None else count - 1) if len(scales) == 2 else count
                mlp_bwd_check(record, key, rows, C, cfg.swin.gelu, rs, n, randn)


def sample_scale(g, dev, rows):
    """DropPath's per-sample factor keep / 0.9 (a seeded keep-0.9 draw per
    clip), repeated over each of the TB clips' rows."""
    import torch

    return ((torch.rand(TB, generator=g, device=dev) < 0.9).float() / 0.9).repeat_interleave(
        rows // TB)


def mlp_bwd_check(record, key, rows, C, gelu, rs, count, randn):
    """K7 (key 'K7') or K8 ('K8', the erf GELU) against the plain recompute
    backward at one shape: dx within K2's limits of the plain version; each
    fp32 output against the plain version run in fp32 (BWD_ERR_*); two
    launches bitwise equal; kernel and plain times, the bound (the
    function's products: z, u, dh's W2 product folded into u, dy, dW1, dW2
    = 10 rows C H flops)."""
    import torch

    from clover_tpu_torch import ops

    H = 4 * C
    x, grad = randn(rows, C), randn(rows, C)
    # bf16-exact weights, so the fp32 reference sees the kernel's operands
    w = [t.bfloat16().float() for t in mlp_weights(randn, C, H)]
    args = (x, *w, rs, 1e-5, gelu, grad)
    ref = ops.ln_mlp_residual_bwd_recompute(x.float(), *w, rs, 1e-5, gelu, grad.float())
    plain = ops.ln_mlp_residual_bwd_recompute(*args)
    fn = {"K7": ops.ln_mlp_residual_bwd_onepass, "K8": ops.ln_mlp_residual_bwd_pair}[key]
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    label = f"rows={rows} C={C} gelu={gelu} row_scale={'yes' if rs is not None else 'no'}"
    check(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again)),
          f"{key} {label}: two launches on the same inputs differ")
    names = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2", "drs")
    for name, k, p, r in list(zip(names, got, plain, ref))[1:]:
        if r is None:
            check(k is None, f"{key} {label}: drs without a row scale")
            continue
        r = r.float()
        err_k, err_p = (k - r).abs().max().item(), (p - r).abs().max().item()
        limit = BWD_ERR_RATIO * err_p + BWD_ERR_FLOOR * r.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(k.flatten(), p.flatten(), 0).item()
        print(f"{key} {label} {name}: max_abs_err vs fp32 kernel={err_k:.3e} plain={err_p:.3e} "
              f"(limit {limit:.3e}) cosine kernel/plain={cos:.7f}", flush=True)
        check(err_k <= limit and cos >= BWD_COS_MIN and bool(torch.isfinite(k).all()),
              f"{key} {label} {name}: kernel off its reference")
    t_p = cuda_ms(lambda: ops.ln_mlp_residual_bwd_recompute(*args), 3)
    # bytes: x and g in, dx out (bf16), the fp32 weights in and the fp32
    # parameter gradients out, the row scale in and drs out
    rsb = 0 if rs is None else 8 * rows
    work = bound_ms(flops=10 * rows * C * H, nbytes=6 * rows * C + 16 * C * H + rsb)
    record(key, fn.__name__, label, got[0], plain[0], cuda_ms(lambda: fn(*args), 3), t_p, count,
           "dx", work=work)


def mlp_weights(randn, C, H):
    import torch

    return (1 + randn(C, std=0.1, dtype=torch.float32), randn(C, std=0.1, dtype=torch.float32),
            randn(H, C, std=C ** -0.5, dtype=torch.float32),
            randn(H, std=0.1, dtype=torch.float32),
            randn(C, H, std=H ** -0.5, dtype=torch.float32),
            randn(C, std=0.1, dtype=torch.float32))


def make_train_batches(cfg, dev, frames_per_clip=TT):
    """Seeded host-s2d uint8 clips (TB, 1, frames/2, 56, 56, 96) and captions
    of varied length, on the card."""
    import torch

    from clover_tpu_torch.ops.preprocess import space_to_depth_host

    rng = np.random.default_rng(SEED + 2 if frames_per_clip == TT else SEED + 5)
    batches = []
    for _ in range(TRAIN_STEPS):
        frames = rng.integers(0, 256, size=(TB, frames_per_clip, S, S, 3), dtype=np.uint8)
        lengths = rng.integers(8, L + 1, size=TB)
        tok = rng.integers(1000, cfg.text_bert.vocab_size, size=(TB, L))
        tok[:, 0] = 101                                   # [CLS]
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
        batches.append({
            "imgs": torch.from_numpy(space_to_depth_host(frames, cfg.swin.patch_size)[:, None]),
            "token_ids": torch.from_numpy(tok * mask), "input_mask": torch.from_numpy(mask)})
    return [{k: v.to(dev) for k, v in b.items()} for b in batches]


def make_train_step(model, dev):
    """The finetune step as a user builds it: make_optimizer + TrainState +
    make_retrieval_train_step. -> (state, step, dropout generator)."""
    import torch

    from clover_tpu_torch.engine import TrainState, make_optimizer, make_retrieval_train_step

    optimizer, schedule = make_optimizer(model, **OPTIM)
    state = TrainState.create(model, optimizer, schedule)
    step = make_retrieval_train_step(model, grad_clip_norm=GRAD_CLIP)
    return state, step, torch.Generator(device=dev).manual_seed(SEED)


def drive_train_path(model, batches, dev, make=make_train_step):
    """A train path (``make``: the finetune step, or the pretrain step) for
    TRAIN_STEPS steps. -> (metrics per step, step 1's gradients, seconds per
    step, the peak memory as text)."""
    import torch

    from clover_tpu_torch.ops import library

    state, step, generator = make(model, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    library.reset_call_counts()
    metrics, seconds, grads1 = [], [], None
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step(state, batch, generator)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append({k: v.item() for k, v in m.items()})
        for name, p in model.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"step {state.step}: {name} has no finite gradient")
        if grads1 is None:
            grads1 = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
    peak = peak_memory(dev)
    # the registered ops are the eval forward's: no train step calls one
    called = {k: n for k, n in library.call_counts().items() if n}
    check(not called, f"a train step called registered ops: {called}")
    model.zero_grad(set_to_none=True)
    del state
    return metrics, grads1, seconds, peak


PROFILE_FAMILIES = (   # (family, substrings of the kernel name), first match wins
    ("K5 window-attention backward", ("wa_bwd_",)),   # row pass, key pass, finish
    ("K6 LN1 + qkv", ("k6_ln_rows", "k6_qkv_pass")),
    ("K6 attention", ("k6flat",)),   # K11's kernel under K6's layout type
    ("K6 proj + residual", ("k6_proj_pass",)),
    ("K11 key-tiled window attention", ("flash_window_attention_kernel",)),
    ("K9 / K10 head-major, grid attention", ("window_attention_heads_kernel",)),
    ("K1 window attention", ("k1_walk_kernel",)),
    ("K2 / K3 MLP LN rows + fc1 GEMM", ("mlp_ln_rows", "mlp_fc1_pass")),
    ("K2 / K3 MLP fc2 GEMM + K3 finish", ("mlp_fc2_pass", "postln_finish")),
    ("K7 / K8 recompute MLP backward, passes", ("k7_",)),
    ("K4 LayerNorm", ("layer_norm_kernel",)),
    ("NCCL collectives", ("nccl",)),
    ("GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90", "sm80")),
    ("optimizer and clip (foreach)", ("multi_tensor", "foreach")),
    ("reductions, softmax, norms", ("reduce", "softmax", "norm")),
    ("copies, casts, gathers, elementwise", ("",)),
)


def profile_runs(runs, wall_ms: float, label: str, unit: str) -> None:
    """Device time by kernel family: torch.profiler over ``runs`` (one
    callable per step or forward, after the caller's warm-up), against the
    unprofiled time wall_ms of one (idle share = 1 - busy / wall)."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for run in runs:
            run()
        torch.cuda.synchronize()
    by_name = {}   # kernel name -> [ms per unit, launches per unit]
    for evt in prof.events():
        # kernels only: user annotations (the optimizer's step range) also
        # show on the device timeline but overlap the kernels
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
            continue
        acc = by_name.setdefault(evt.name, [0.0, 0.0])
        acc[0] += evt.time_range.elapsed_us() / 1e3 / len(runs)
        acc[1] += 1 / len(runs)
    per_family = {}
    for name, (t, _) in by_name.items():
        fam = next(f for f, keys in PROFILE_FAMILIES if any(k in name.lower() for k in keys))
        per_family[fam] = per_family.get(fam, 0.0) + t
    busy = sum(per_family.values())
    print(f"profile, {label}, {len(runs)} {unit}s: device busy {busy:.2f} ms per {unit}, "
          f"unprofiled wall {wall_ms:.2f} ms (idle share {max(0.0, 1 - busy / wall_ms):.3f}), "
          f"{round(sum(n for _, n in by_name.values()))} launches per {unit}", flush=True)
    for fam, t in sorted(per_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:40s} {t:9.3f} ms  {100 * t / busy:5.1f}%")
    print(f"  largest kernels (ms per {unit}, calls per {unit}, name):")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t:9.3f} {round(n):5d}  {name[:110]}")


def profile_train_path(model, batches, dev, wall_ms: float, label: str,
                       make=make_train_step) -> None:
    """The train step's device time by kernel family, over the batches
    after two warm-up steps."""
    state, step, generator = make(model, dev)
    for batch in batches[:2]:
        state, _ = step(state, batch, generator)

    def run(batch):
        nonlocal state
        state, _ = step(state, batch, generator)

    profile_runs([lambda b=b: run(b) for b in batches[2:]], wall_ms, f"{label} train path",
                 "step")
    model.zero_grad(set_to_none=True)


def profile_eval_path(model, cfg, batches, dev, wall_ms: float, label: str) -> None:
    """An eval forward's device time by kernel family: each batch's forward
    through the eval step after one warm-up forward, inputs on the card."""
    import torch

    from clover_tpu_torch.engine import make_embed_eval_step
    from clover_tpu_torch.models import swin_bias_cache

    step = make_embed_eval_step(model)
    cache = swin_bias_cache(model.backbone, cfg.swin, batches[0]["imgs"].shape[2:5])
    on_dev = [tuple(torch.as_tensor(b[k]).to(dev) for k in ("imgs", "token_ids", "input_mask"))
              for b in batches]
    step(*on_dev[0], cache)
    profile_runs([lambda a=a: step(*a, cache) for a in on_dev], wall_ms, label, "forward")


def launch_counts():
    """Every kernel wrapper's launches since the last reset, by kernel key."""
    from clover_tpu_torch import ops

    wrappers = {"K1": ops.flat2_window_attention, "K2": ops.fused_ln_mlp_residual,
                "K3": ops.fused_mlp_postln, "K4": ops.fused_layer_norm,
                "K5": ops.flat2_window_attention_bwd, "K2S": ops.fused_ln_mlp_residual_stash,
                "K6": ops.fused_window_attn_block, "K3M": ops.fused_mlp_postln_dropout,
                "K2T": ops.fused_ln_mlp_residual_train, "K7": ops.ln_mlp_residual_bwd_onepass,
                "K8": ops.ln_mlp_residual_bwd_pair,
                "K9": ops.fused_window_attention, "K10": ops.spatial_window_attention,
                "K11": ops.flat_flash_window_attention, "K11h": ops.flash_window_attention}
    return {k: fn.launches for k, fn in wrappers.items()}


def check_launches(tag: str, counts, per_run, runs: int, unit: str) -> None:
    """Every kernel launched per_run[k] times per forward or step over
    ``runs`` of them, a kernel not in per_run never."""
    print(f"{tag} launches over {runs} {unit}s: {counts} (expected per {unit}: {per_run})",
          flush=True)
    for k, n in counts.items():
        want = per_run.get(k, 0) * runs
        check(n == want, f"{tag} {k}: {n} launches, expected {want}")


def train_phase(model, plain, cfg, dev, card, profile: bool, frames=TT):
    """Drive the finetune path at ``frames`` frames with the kernels and with
    the plain versions from the same weights; check launches, gradients and
    the agreement; with ``profile``, then trace each path's steps. -> the
    launch counts of the kernel path's run."""
    return compare_train_paths(model, plain, make_train_batches(cfg, dev, frames), dev, card,
                               profile, f"train ({frames} frames)", TRAIN_LAUNCHES[frames],
                               f"B={TB}, {frames}x{S}^2, L={L}", TB, make_train_step)


def compare_train_paths(model, plain, batches, dev, card, profile: bool, tag: str, per_step,
                        shape: str, clips: int, make, exact_zero=("attention.key.bias",)):
    """The train step built by ``make`` on the kernel model and on the plain
    one, one step per batch on each: launches per step, finite metrics and
    gradients, step 1's loss, grad_norm and gradient cosines (but of the
    tensors named ``exact_zero``, whose gradient is zero in exact
    arithmetic), clips/s from step 3 on and peak memory. -> the kernel
    path's counts."""
    import torch

    from clover_tpu_torch import ops

    steps = len(batches)
    ops.reset_launch_counts()
    k_metrics, k_grads, k_sec, k_peak = drive_train_path(model, batches, dev, make)
    counts = launch_counts()
    check_launches(tag, counts, per_step, steps, "step")

    ops.reset_launch_counts()
    p_metrics, p_grads, p_sec, p_peak = drive_train_path(plain, batches, dev, make)
    check(all(fn.launches == 0 for fn in ops.KERNELS), f"the plain {tag} path launched a kernel")
    for i, (km, pm) in enumerate(zip(k_metrics, p_metrics)):
        print(f"{tag} step {i + 1}: kernels {km} plain {pm}")
        check(all(np.isfinite(v) for v in km.values()), f"step {i + 1}: non-finite metric {km}")
    k1, p1 = k_metrics[0], p_metrics[0]
    loss_rel = abs(k1["loss"] - p1["loss"]) / abs(p1["loss"])
    gnorm_rel = abs(k1["grad_norm"] - p1["grad_norm"]) / abs(p1["grad_norm"])
    cos = {}
    for name, g in k_grads.items():
        if name.endswith(exact_zero):
            continue
        gp = p_grads[name]
        if gp.norm() > 0 and g.norm() > 0:
            cos[name] = torch.nn.functional.cosine_similarity(g.reshape(1, -1),
                                                              gp.reshape(1, -1)).item()
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    print(f"{tag} step 1, kernels vs plain: loss rel {loss_rel:.3e} (bound {TRAIN_LOSS_RTOL}), "
          f"grad_norm rel {gnorm_rel:.3e} (bound {TRAIN_GNORM_RTOL}), min gradient cosine "
          f"{worst[0][1]:.6f} over {len(cos)} tensors (bound {TRAIN_COS_MIN}); lowest {worst}",
          flush=True)
    check(loss_rel <= TRAIN_LOSS_RTOL, f"{tag} loss differs: {loss_rel:.3e}")
    check(gnorm_rel <= TRAIN_GNORM_RTOL, f"{tag} grad_norm differs: {gnorm_rel:.3e}")
    check(worst[0][1] >= TRAIN_COS_MIN, f"{tag} gradients differ: {worst}")
    steady = lambda sec: clips * (len(sec) - 2) / sum(sec[2:])   # noqa: E731  (2 warm-up steps)
    print(f"{tag} clips/s ({shape}, steps 3-{steps}): kernels "
          f"{steady(k_sec):.2f} plain {steady(p_sec):.2f}; step seconds kernels "
          f"{[round(t, 4) for t in k_sec]} plain {[round(t, 4) for t in p_sec]}; peak memory "
          f"kernels {k_peak} plain {p_peak} on {card}",
          flush=True)
    if profile:
        profile_train_path(model, batches, dev, clips * 1e3 / steady(k_sec), f"kernel {tag}",
                           make)
        profile_train_path(plain, batches, dev, clips * 1e3 / steady(p_sec), f"plain {tag}",
                           make)
    return counts


def pretrain_config(frames=PT, **swin):
    """bench_train's configuration (bench.py:402-416) at ``frames`` frames
    with the fused FFN route on ('auto', the JAX CLOVER_BERT_MLP_TRAIN):
    Swin-B with the mask token and the raw-clip embed (and the ``swin``
    fields given: remat, the MLP route), BERT-base, the 3-layer fusion tower
    at frames / 2 latent frames."""
    from clover_tpu_torch.models import BertConfig, FusionConfig, PretrainConfig, SwinConfig

    return PretrainConfig(
        swin=SwinConfig.base(mask_token=True, embed_impl="conv", **swin),
        text_bert=BertConfig(fused_mlp_train="auto"),
        fusion=FusionConfig(bert=BertConfig(num_hidden_layers=3, fused_mlp_train="auto"),
                            img_in_size=1024, num_frames=frames // 2, spatial_tokens=49))


def pretrain32_config():
    """The TPU's 32-frame remat recipe: stages 0-1 rematerialised, the MLP
    stash off, the MLP backward through K7."""
    return pretrain_config(PT32, use_checkpoint=(0, 1), mlp_stash=False, mlp_bwd="onepass")


def pretrain_erf_config():
    """The pair's path: 8 frames, the erf GELU, every stage rematerialised,
    the stash off, the MLP backward through K8."""
    return pretrain_config(PT, gelu="erf", use_checkpoint=True, mlp_stash=False, mlp_bwd="pair")


def pretrain_rows(frames):
    """The batched fusion pass's rows: 2B clips x (frames/2 x 49 + L) tokens."""
    return 2 * PB * (frames // 2 * 49 + L)


def pretrain_kernel_phase(cfg, dev, results, seed=SEED + 7, rows=PRETRAIN_ROWS):
    """K3M against its plain version at the fusion tower's shape, a seeded
    mask at keep 0.9; times per pretrain step (one call per fusion layer)."""
    import torch

    from clover_tpu_torch import ops

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    bt = cfg.fusion.bert
    C, H = bt.hidden_size, bt.intermediate_size
    x, w = randn(rows, C), mlp_weights(randn, C, H)
    mask = (torch.rand(rows, C, generator=g, device=dev) < 0.9).float() / 0.9
    eps = bt.layer_norm_eps
    k = lambda: ops.fused_mlp_postln_dropout(x, *w, mask, eps)   # noqa: E731
    p = lambda: ops.mlp_postln_mask_plain(x, *w, mask, eps)   # noqa: E731
    # the fp32 mask is read once besides K3's x, out and weights
    recorder(results, "step")("K3M", "fused_mlp_postln_dropout", f"rows={rows} C={C} keep=0.9",
                              k(), p(), cuda_ms(k, 20), cuda_ms(p, 20), bt.num_hidden_layers,
                              work=mlp_work(rows, C, H, extra_bytes=4 * rows * C))


def make_pretrain_batches(dev, frames=PT, steps=TRAIN_STEPS, seed=SEED + 6):
    """bench_train's seeded batches (bench.py:418-431), on the card: clips
    normal * 0.5 (PB, frames, 224, 224, 3), ids in [1000, 30000) with
    position 3 masked to 103 and its label kept, an all-ones attention mask,
    a random 0/1 (PB, 7, 7) video mask."""
    import torch

    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        tok = rng.integers(1000, 30000, size=(PB, L))
        label = np.full((PB, L), -100)
        label[:, 3] = tok[:, 3]
        tok[:, 3] = 103
        batches.append({
            "imgs": torch.from_numpy(rng.normal(size=(PB, frames, S, S, 3)).astype(np.float32)
                                     * 0.5),
            "token_ids": torch.from_numpy(tok), "input_mask": torch.ones(PB, L, dtype=torch.long),
            "mlm_label": torch.from_numpy(label),
            "v_token_mask": torch.from_numpy(rng.integers(0, 2, size=(PB, 7, 7)))})
    return [{k: v.to(dev) for k, v in b.items()} for b in batches]


def make_pretrain_step(model, dev):
    """The pretrain step as a user builds it (bench_train's optimizer and
    clip). -> (state, step, dropout generator)."""
    import torch

    from clover_tpu_torch.engine import TrainState, make_optimizer, make_pretrain_train_step

    optimizer, schedule = make_optimizer(model, **PRETRAIN_OPTIM)
    state = TrainState.create(model, optimizer, schedule)
    step = make_pretrain_train_step(model, grad_clip_norm=GRAD_CLIP)

    def step_checked(state, batch, generator):
        state, metrics = step(state, batch, generator)
        check(set(metrics) == set(PRETRAIN_LOSSES) | {"loss", "grad_norm"},
              f"pretrain metrics {sorted(metrics)}")
        return state, metrics

    return state, step_checked, torch.Generator(device=dev).manual_seed(SEED)


def pretrain_phase(dev, card, profile: bool, cfg=None, frames=PT, launches=PRETRAIN_LAUNCHES,
                   steps=TRAIN_STEPS, tag=None):
    """The pretrain step (``cfg``, bench_train's by default, at ``frames``
    frames) from one seed with the kernels and with the plain versions, as
    compare_train_paths checks it. -> the kernel path's counts."""
    import torch

    from clover_tpu_torch.models import CloverPretrain, init_params

    cfg = cfg or pretrain_config()
    check(2 * PB == TB and cfg.fusion.num_frames * cfg.fusion.spatial_tokens + L
          == pretrain_rows(frames) // (2 * PB), "pretrain shapes")
    model = CloverPretrain(cfg, dtype=torch.bfloat16, kernels=True)
    init_params(model, torch.Generator().manual_seed(SEED))
    plain = CloverPretrain(cfg, dtype=torch.bfloat16, kernels=False)
    plain.load_state_dict(model.state_dict())
    check(all(p.device == dev for p in model.parameters()), "the pretrain model is not on the card")
    counts = compare_train_paths(model, plain, make_pretrain_batches(dev, frames, steps), dev,
                                 card, profile, tag or f"pretrain ({frames} frames)", launches,
                                 f"B={PB}, {frames}x{S}^2, L={L}", PB, make_pretrain_step)
    del model, plain
    torch.cuda.empty_cache()
    return counts


def make_batches(cfg, frames_per_clip=T, n_batches=N_BATCHES, seed=SEED, clips=B, size=S,
                 rgb=False):
    """Seeded host-s2d uint8 clips (clips, 1, T/2, size/4, size/4, 96) (with
    ``rgb``, the same frames as (clips, 1, T, size, size, 3)) and captions
    of varied length, as the retrieval loader gives them."""
    from clover_tpu_torch.ops.preprocess import space_to_depth_host

    rng = np.random.default_rng(seed)
    batches = []
    for i in range(n_batches):
        frames = rng.integers(0, 256, size=(clips, frames_per_clip, size, size, 3),
                              dtype=np.uint8)
        lengths = rng.integers(8, L + 1, size=clips)
        tok = rng.integers(1000, cfg.text_bert.vocab_size, size=(clips, L))
        tok[:, 0] = 101                                   # [CLS]
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
        index = np.arange(i * clips, (i + 1) * clips)
        batches.append({
            "imgs": frames[:, None] if rgb else space_to_depth_host(frames,
                                                                   cfg.swin.patch_size)[:, None],
            "token_ids": tok * mask, "input_mask": mask, "index": index, "video_index": index,
        })
    return batches


def drive_main_path(model, cfg, batches, **loop):
    """The port's main path, as a user runs it: the eval step through the
    retrieval loop (``loop``: its out_size and dtype for RGB batches), bias
    cache built at the first batch. -> R@K metrics."""
    import torch

    from clover_tpu_torch.engine import make_embed_eval_step, run_retrieval_eval
    from clover_tpu_torch.models import swin_bias_cache

    n = sum(len(b["index"]) for b in batches)
    dataset = types.SimpleNamespace(text_video_ids=[[i] for i in range(n)])
    metrics = run_retrieval_eval(
        make_embed_eval_step(model), model, dataset, iter(batches),
        bias_cache=lambda m, dims: swin_bias_cache(m.backbone, cfg.swin, dims), **loop)
    torch.cuda.synchronize()
    return metrics


def timed_embeddings(model, cfg, batches, dev):
    """The same forwards on batches already on the card, timed with a host
    clock around work that ends in a synchronize. -> (v, t, clips/s)."""
    import torch

    from clover_tpu_torch.engine import make_embed_eval_step
    from clover_tpu_torch.models import swin_bias_cache

    step = make_embed_eval_step(model)
    cache = swin_bias_cache(model.backbone, cfg.swin, batches[0]["imgs"].shape[2:5])
    on_dev = [tuple(torch.as_tensor(b[k]).to(dev) for k in ("imgs", "token_ids", "input_mask"))
              for b in batches]
    torch.cuda.synchronize()
    vs, ts = [], []
    t0 = time.perf_counter()
    for imgs, tok, mask in on_dev:
        v, t = step(imgs, tok, mask, cache)
        vs.append(v)
        ts.append(t)
    torch.cuda.synchronize()
    clips_per_s = sum(a[0].shape[0] for a in on_dev) / (time.perf_counter() - t0)
    return torch.cat(vs).float(), torch.cat(ts).float(), clips_per_s


def eval32_phase(model, plain, cfg, dev, card, profile: bool):
    """The 32-frame retrieval eval: the path through the kernels (K6 in every
    Swin block) and through the plain versions on the same batches; with
    ``profile``, then trace the kernel path's forwards. -> the launch
    counts of the kernel path's run."""
    import torch

    from clover_tpu_torch import ops

    batches = make_batches(cfg, T32, N32_BATCHES, SEED + 3)
    ops.reset_launch_counts()
    metrics = drive_main_path(model, cfg, batches)
    counts = launch_counts()
    check_launches("32-frame", counts, {"K6": 24, "K2": 24, "K3": 12, "K4": 18}, N32_BATCHES,
                   "forward")
    torch.cuda.reset_peak_memory_stats(dev)
    v, t, cps = timed_embeddings(model, cfg, batches, dev)
    k_peak = peak_memory(dev)
    check(v.shape == (B * N32_BATCHES, cfg.vts_embed_dim) and t.shape == v.shape,
          f"32-frame embedding shapes {tuple(v.shape)}, {tuple(t.shape)}")
    check(bool(torch.isfinite(v).all() and torch.isfinite(t).all()),
          "32-frame: non-finite embedding")
    check(set(metrics) >= {"Recall@1", "Recall@5", "Recall@10", "MR"}, f"metrics {metrics}")
    print(f"32-frame kernel path R@K: {metrics}", flush=True)

    ops.reset_launch_counts()
    p_metrics = drive_main_path(plain, cfg, batches)
    torch.cuda.reset_peak_memory_stats(dev)
    pv, pt, p_cps = timed_embeddings(plain, cfg, batches, dev)
    p_peak = peak_memory(dev)
    check(all(fn.launches == 0 for fn in ops.KERNELS), "the plain 32-frame path launched a kernel")
    cos_v = torch.nn.functional.cosine_similarity(v, pv, dim=-1).min().item()
    cos_t = torch.nn.functional.cosine_similarity(t, pt, dim=-1).min().item()
    print(f"32-frame plain path R@K: {p_metrics}")
    print(f"32-frame kernel vs plain embeddings: min cosine video {cos_v:.6f} text {cos_t:.6f} "
          f"(bound {COS32_MIN})", flush=True)
    check(cos_v >= COS32_MIN and cos_t >= COS32_MIN,
          f"32-frame kernel path disagrees with the plain path: min cosine video {cos_v:.6f} "
          f"text {cos_t:.6f}, bound {COS32_MIN}")
    print(f"32-frame clips/s (B={B}, {T32}x{S}^2, L={L}, {N32_BATCHES} batches, forward only): "
          f"kernels {cps:.2f} plain {p_cps:.2f}; peak memory kernels {k_peak} plain {p_peak} "
          f"on {card}", flush=True)
    if profile:
        profile_eval_path(model, cfg, batches, dev, B * 1e3 / cps, "kernel 32-frame eval path")
    return counts


def spatial_path_phase(path, weights, dev, card, profile: bool, spec=None):
    """One phase-5c path (SPATIAL_PATHS, or ``spec`` in its form): the
    retrieval eval of Swin-B with the path's SwinConfig fields + BERT-base
    on ``weights`` (the eval model's state dict: the parameter tree does not
    depend on the layout),
    with the kernels and with the plain versions on the same batches;
    launches per forward, finite embeddings and R@K, cosine per row,
    clips/s, peak memory; with ``profile``, the kernel path's forwards
    traced. -> the launch counts of the kernel path's run."""
    import torch

    from clover_tpu_torch import ops
    from clover_tpu_torch.models import BertConfig, CloverFinetune, FinetuneConfig, SwinConfig

    fields, clips, frames, size, n_batches, own, cos_min = spec or SPATIAL_PATHS[path]
    cfg = FinetuneConfig(swin=SwinConfig.base(fold_normalize=True, **fields),
                         text_bert=BertConfig())
    model = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=True).eval()
    model.load_state_dict(weights)
    plain = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=False).eval()
    plain.load_state_dict(weights)
    batches = make_batches(cfg, frames, n_batches, SEED + 12, clips, size)
    shape = f"B={clips}, {frames}x{size}^2, L={L}, {n_batches} batches, forward only"

    ops.reset_launch_counts()
    metrics = drive_main_path(model, cfg, batches)
    counts = launch_counts()
    check_launches(f"{path} {fields}", counts, {**EVAL_COMMON, **own}, n_batches, "forward")
    torch.cuda.reset_peak_memory_stats(dev)
    v, t, cps = timed_embeddings(model, cfg, batches, dev)
    k_peak = peak_memory(dev)
    check(v.shape == (clips * n_batches, cfg.vts_embed_dim) and t.shape == v.shape,
          f"{path} embedding shapes {tuple(v.shape)}, {tuple(t.shape)}")
    check(bool(torch.isfinite(v).all() and torch.isfinite(t).all()),
          f"{path}: non-finite embedding")
    check(set(metrics) >= {"Recall@1", "Recall@5", "Recall@10", "MR"}, f"metrics {metrics}")
    print(f"{path} kernel path R@K: {metrics}", flush=True)

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    pv, pt, p_cps = timed_embeddings(plain, cfg, batches, dev)
    p_peak = peak_memory(dev)
    check(all(fn.launches == 0 for fn in ops.KERNELS), f"the plain {path} path launched a kernel")
    cos_v = torch.nn.functional.cosine_similarity(v, pv, dim=-1).min().item()
    cos_t = torch.nn.functional.cosine_similarity(t, pt, dim=-1).min().item()
    print(f"{path} kernel vs plain embeddings: min cosine video {cos_v:.6f} text {cos_t:.6f} "
          f"(bound {cos_min})", flush=True)
    check(cos_v >= cos_min and cos_t >= cos_min,
          f"{path} kernel path disagrees with the plain path: min cosine video {cos_v:.6f} "
          f"text {cos_t:.6f}, bound {cos_min}")
    print(f"{path} clips/s ({shape}): kernels {cps:.2f} plain {p_cps:.2f}; peak memory kernels "
          f"{k_peak} plain {p_peak} on {card}", flush=True)
    if profile:
        profile_eval_path(model, cfg, batches, dev, clips * 1e3 / cps, f"kernel {path} eval path")
    del model, plain, v, t, pv, pt
    torch.cuda.empty_cache()
    return counts


def timed_rgb_embeddings(model, cfg, batches, dev, views=1):
    """RGB batches (uint8 frames already on the card) through the device
    preprocess and the eval step, timed with a host clock around work that
    ends in a synchronize, after one untimed forward: ``eval_preprocess``
    to 224 (``views`` 3: ``three_crop_preprocess``, each clip's 3 crops
    mean-pooled by the model). -> (v, t, clips/s)."""
    import torch

    from clover_tpu_torch.engine import make_embed_eval_step
    from clover_tpu_torch.models import swin_bias_cache
    from clover_tpu_torch.models.swin3d import embed_dims
    from clover_tpu_torch.ops.preprocess import eval_preprocess, three_crop_preprocess

    step = make_embed_eval_step(model)
    cache = swin_bias_cache(model.backbone, cfg.swin,
                            embed_dims(cfg.swin, (batches[0]["imgs"].shape[2], S, S)))
    on_dev = [tuple(torch.as_tensor(b[k]).to(dev) for k in ("imgs", "token_ids", "input_mask"))
              for b in batches]

    def forward(frames, tok, mask):
        clips = frames.flatten(0, 1)
        if views == 3:
            imgs = three_crop_preprocess(clips, S, torch.bfloat16).unflatten(0, (-1, 3))
        else:
            imgs = eval_preprocess(clips, S, torch.bfloat16).unflatten(0, frames.shape[:2])
        return step(imgs, tok, mask, cache)

    forward(*on_dev[0])   # an untimed warm-up forward
    torch.cuda.synchronize()
    vs, ts = [], []
    t0 = time.perf_counter()
    for frames, tok, mask in on_dev:
        v, t = forward(frames, tok, mask)
        vs.append(v)
        ts.append(t)
    torch.cuda.synchronize()
    clips_per_s = sum(a[0].shape[0] for a in on_dev) / (time.perf_counter() - t0)
    return torch.cat(vs).float(), torch.cat(ts).float(), clips_per_s


def min_cosines(a, b):
    """(video, text) min per-row cosine of two paths' embeddings."""
    import torch.nn.functional as F

    return tuple(F.cosine_similarity(x, y, dim=-1).min().item() for x, y in zip(a, b))


def preprocess_phase(dev, card):
    """The device preprocess alone at the RGB paths' batch shapes (CUDA
    events): R8's normalize-only eval batch, the centre crop and the three
    crops of a canonical-256 batch, F12R's random-resized crops with flips;
    beside each, its bytes over the card's rate (uint8 in, bf16 out). ->
    {route: ms per batch}."""
    import torch

    from clover_tpu_torch.ops.preprocess import (eval_preprocess, preprocess_clips,
                                                 random_resized_crop_params,
                                                 three_crop_preprocess)

    g = torch.Generator(device=dev).manual_seed(SEED + 17)

    def frames(*shape):
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)

    f224, f256, train = frames(B, T, S, S, 3), frames(B, T, CANON, CANON, 3), frames(
        TB, TT, CANON, CANON, 3)
    rng = np.random.default_rng(SEED + 17)
    boxes = np.stack([random_resized_crop_params(rng, CANON) for _ in range(TB)])
    flips = rng.random(TB) < 0.5
    out = {}
    for name, fn, x, n_out in (
            ("R8 eval_preprocess (normalize only)", lambda: eval_preprocess(f224, S), f224, B),
            ("eval_preprocess (centre crop 256 -> 224)", lambda: eval_preprocess(f256, S), f256, B),
            ("three_crop_preprocess (256 -> 3 x 224)", lambda: three_crop_preprocess(f256, S),
             f256, 3 * B),
            ("F12R preprocess_clips (random crops, flips)",
             lambda: preprocess_clips(train, boxes, flips, S), train, TB)):
        y = fn()
        check(y.dtype == torch.bfloat16 and y.shape == (n_out, x.shape[1], S, S, 3)
              and bool(torch.isfinite(y).all()), f"{name}: output {tuple(y.shape)}")
        out[name] = cuda_ms(fn, 5)
        bound = (x.numel() + 2 * y.numel()) / PEAK_BYTES * 1e3
        print(f"preprocess {name} {tuple(x.shape)} -> {tuple(y.shape)}: {out[name]:.4f} ms per "
              f"batch (bytes bound {bound:.4f} ms) on {card}", flush=True)
    return out


def rgb_eval_phase(weights, dev, card):
    """R8: the 8-frame retrieval eval from uint8 RGB frames through
    run_retrieval_eval's RGB route, with the kernels and with the plain
    versions on ``weights``; launches per forward, finite R@K, cosine per
    row against the plain path and against the host-s2d eval8 path
    (fold_normalize) on the same frames and weights, clips/s with the
    preprocess, peak memory; then one canonical-256 batch through the centre
    crop and one through the three crops, each against its plain path. ->
    the launch counts of R8's run."""
    import torch

    from clover_tpu_torch import ops
    from clover_tpu_torch.models import BertConfig, CloverFinetune, FinetuneConfig, SwinConfig

    cfg = FinetuneConfig(swin=SwinConfig.base(embed_impl="conv"), text_bert=BertConfig())
    model = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=True).eval()
    model.load_state_dict(weights)
    plain = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=False).eval()
    plain.load_state_dict(weights)
    batches = make_batches(cfg, T, R8_BATCHES, SEED + 14, B, S, rgb=True)
    check(batches[0]["imgs"].shape == (B, 1, T, S, S, 3), "R8 batch shape")

    ops.reset_launch_counts()
    metrics = drive_main_path(model, cfg, batches, dtype=torch.bfloat16)
    counts = launch_counts()
    check_launches("R8", counts, R8_LAUNCHES, R8_BATCHES, "forward")
    torch.cuda.reset_peak_memory_stats(dev)
    v, t, cps = timed_rgb_embeddings(model, cfg, batches, dev)
    k_peak = peak_memory(dev)
    check(v.shape == (B * R8_BATCHES, cfg.vts_embed_dim) and t.shape == v.shape,
          f"R8 embedding shapes {tuple(v.shape)}, {tuple(t.shape)}")
    check(bool(torch.isfinite(v).all() and torch.isfinite(t).all()), "R8: non-finite embedding")
    check(set(metrics) >= {"Recall@1", "Recall@5", "Recall@10", "MR"}, f"metrics {metrics}")
    print(f"R8 kernel path R@K: {metrics}", flush=True)
    ops.reset_launch_counts()
    pv, pt, p_cps = timed_rgb_embeddings(plain, cfg, batches, dev)
    check(all(fn.launches == 0 for fn in ops.KERNELS), "the plain R8 path launched a kernel")

    s2d_cfg = FinetuneConfig(swin=SwinConfig.base(fold_normalize=True), text_bert=BertConfig())
    s2d = CloverFinetune(s2d_cfg, dtype=torch.bfloat16, kernels=True).eval()
    s2d.load_state_dict(weights)
    s2d_batches = make_batches(s2d_cfg, T, R8_BATCHES, SEED + 14, B, S)
    sv, st, _ = timed_embeddings(s2d, s2d_cfg, s2d_batches, dev)
    del s2d
    for what, other in (("plain R8 path", (pv, pt)), ("host-s2d eval8 path", (sv, st))):
        cos_v, cos_t = min_cosines((v, t), other)
        print(f"R8 kernel path vs the {what}: min cosine video {cos_v:.6f} text {cos_t:.6f} "
              f"(bound {COS_MIN})", flush=True)
        check(cos_v >= COS_MIN and cos_t >= COS_MIN, f"R8 disagrees with the {what}")
    print(f"R8 clips/s (B={B}, {T}x{S}^2 uint8 frames, L={L}, {R8_BATCHES} batches, preprocess "
          f"+ forward): kernels {cps:.2f} plain {p_cps:.2f}; peak memory kernels {k_peak} on "
          f"{card}", flush=True)

    big = make_batches(cfg, T, 1, SEED + 15, B, CANON, rgb=True)
    ops.reset_launch_counts()
    drive_main_path(model, cfg, big, dtype=torch.bfloat16)
    check_launches(f"R8 centre crop {CANON} -> {S}", launch_counts(), R8_LAUNCHES, 1, "forward")
    for views in (1, 3):
        route = "centre crop" if views == 1 else "three crops"
        ops.reset_launch_counts()
        kv, kt, k_cps = timed_rgb_embeddings(model, cfg, big, dev, views)
        # the warm-up forward and the timed one
        check_launches(f"R8 {route}", launch_counts(), R8_LAUNCHES, 2, "forward")
        pv3, pt3, _ = timed_rgb_embeddings(plain, cfg, big, dev, views)
        check(kv.shape == (B, cfg.vts_embed_dim) and bool(torch.isfinite(kv).all()
                                                          and torch.isfinite(kt).all()),
              f"R8 {route}: embeddings {tuple(kv.shape)}")
        cos_v, cos_t = min_cosines((kv, kt), (pv3, pt3))
        print(f"R8 {route} ({B} clips of {T}x{CANON}^2, {views * B} views a forward): kernel vs "
              f"plain min cosine video {cos_v:.6f} text {cos_t:.6f} (bound {COS_MIN}); clips/s "
              f"{k_cps:.2f} on {card}", flush=True)
        check(cos_v >= COS_MIN and cos_t >= COS_MIN, f"R8 {route}: kernel path disagrees")
    del model, plain
    torch.cuda.empty_cache()
    return counts


def rgb_train_phase(dev, card, profile: bool):
    """F12R: the 12-frame finetune step from uint8 frames (canonical 256,
    seeded random-resized crop boxes and flips, made into the model batch on
    the card by to_model_batch; the raw-clip 'conv' embed) with the kernels
    and with the plain versions from the seeded weights, as
    compare_train_paths checks a train path. -> the kernel path's counts."""
    import torch

    from clover_tpu_torch.engine import to_model_batch
    from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig, SwinConfig,
                                         init_params)
    from clover_tpu_torch.ops.preprocess import random_resized_crop_params

    cfg = FinetuneConfig(swin=SwinConfig.base(embed_impl="conv"), text_bert=BertConfig())
    model = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=True).train()
    init_params(model, torch.Generator().manual_seed(SEED))
    plain = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=False).train()
    plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(SEED + 16)
    batches = []
    for _ in range(F12R_STEPS):
        lengths = rng.integers(8, L + 1, size=TB)
        tok = rng.integers(1000, cfg.text_bert.vocab_size, size=(TB, L))
        tok[:, 0] = 101                                   # [CLS]
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
        host = {"imgs": rng.integers(0, 256, (TB, 1, TT, CANON, CANON, 3), dtype=np.uint8),
                "crop_boxes": np.stack([random_resized_crop_params(rng, CANON)
                                        for _ in range(TB)]),
                "flip": rng.random(TB) < 0.5, "token_ids": tok * mask, "input_mask": mask}
        batch = to_model_batch(host, S, torch.bfloat16, dev)
        check(set(batch) == {"imgs", "token_ids", "input_mask"}
              and batch["imgs"].shape == (TB, 1, TT, S, S, 3), "F12R model batch")
        batches.append(batch)
    counts = compare_train_paths(model, plain, batches, dev, card, profile,
                                 f"train from RGB frames ({TT} frames)", TRAIN_LAUNCHES[TT],
                                 f"B={TB}, {TT}x{CANON}^2 uint8 -> {S}^2, L={L}", TB,
                                 make_train_step)
    del model, plain, batches
    torch.cuda.empty_cache()
    return counts


def qa_config(**fields):
    """configs/_base_/models/clover_base.py's towers with the host-s2d embed
    and the experiment's FinetuneConfig fields (``fields``)."""
    from clover_tpu_torch.models import (BertConfig, FinetuneConfig, FusionConfig,
                                         SwinConfig)

    return FinetuneConfig(swin=SwinConfig.base(fold_normalize=True), text_bert=BertConfig(),
                          fusion=FusionConfig(), **fields)


def qa_models(cfg):
    """(kernel model, plain model) of ``cfg`` on the card from one seed, bf16."""
    import torch

    from clover_tpu_torch.models import CloverFinetune, init_params

    model = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=True)
    init_params(model, torch.Generator().manual_seed(SEED))
    plain = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=False)
    plain.load_state_dict(model.state_dict())
    return model, plain


def make_qa_batches(cfg, n_batches, videos, n_cand, text_len, seed, labels, mask_token=False):
    """Seeded host-s2d uint8 clips (videos, 1, T/2, 56, 56, 96), token ids and
    mask (videos, n_cand, text_len) of varied length ([CLS] first; with
    ``mask_token`` one [MASK] a row at a seeded position before its
    padding), labels in [0, labels) and dataset indices, as numpy."""
    from clover_tpu_torch.models import MASK_TOKEN_ID
    from clover_tpu_torch.ops.preprocess import space_to_depth_host

    rng = np.random.default_rng(seed)
    batches = []
    for i in range(n_batches):
        frames = rng.integers(0, 256, size=(videos, T, S, S, 3), dtype=np.uint8)
        lengths = rng.integers(8, text_len + 1, size=(videos, n_cand))
        tok = rng.integers(1000, cfg.text_bert.vocab_size, size=(videos, n_cand, text_len))
        tok[..., 0] = 101                                   # [CLS]
        if mask_token:
            np.put_along_axis(tok, rng.integers(1, lengths)[..., None], MASK_TOKEN_ID, axis=-1)
        mask = (np.arange(text_len) < lengths[..., None]).astype(np.int64)
        batches.append({"imgs": space_to_depth_host(frames, cfg.swin.patch_size)[:, None],
                        "token_ids": tok * mask, "input_mask": mask,
                        "label": rng.integers(0, labels, size=videos),
                        "index": np.arange(i * videos, (i + 1) * videos)})
    return batches


def make_qa_step(model, dev):
    """The QA finetune step as a user builds it (finetune_lsmdc_mc.py's
    optimizer and clip). -> (state, step, dropout generator)."""
    import torch

    from clover_tpu_torch.engine import TrainState, make_optimizer, make_qa_train_step

    optimizer, schedule = make_optimizer(model, **Q8M_OPTIM)
    state = TrainState.create(model, optimizer, schedule)
    step = make_qa_train_step(model, grad_clip_norm=Q8M_CLIP)

    def step_checked(state, batch, generator):
        state, metrics = step(state, batch, generator)
        check(set(metrics) == {"qa_loss", "loss", "grad_norm"}, f"QA metrics {sorted(metrics)}")
        return state, metrics

    return state, step_checked, torch.Generator(device=dev).manual_seed(SEED)


def q8m_phase(dev, card, profile: bool):
    """Q8M, the QA-MC finetune step: K1, K5 and K2's stash form at its Swin
    shapes (16 clips of 8 frames) against their plain versions, then 5
    steps with the kernels and with the plain versions from one seed,
    checked as phase 8 (the MC head's output bias aside: a shift shared by
    a video's candidates, its gradient is zero in exact arithmetic). ->
    (kernel results, launch counts)."""
    import torch

    check(QB == TB, "Q8M's Swin batch is the train phases'")
    cfg = qa_config(task="video_qa", answer_cls=True, qa_head="mc")
    results = {}
    train_kernel_phase(cfg, dev, results, T, SEED + 16)
    model, plain = qa_models(cfg)
    keys = ("imgs", "token_ids", "input_mask", "label")
    batches = [{k: torch.as_tensor(b[k]).to(dev) for k in keys}
               for b in make_qa_batches(cfg, TRAIN_STEPS, QB, QN, L, SEED + 17, QN)]
    counts = compare_train_paths(
        model, plain, batches, dev, card, profile, "Q8M (QA-MC train, 8 frames)", Q8M_LAUNCHES,
        f"B={QB} videos x {QN} candidates, {T}x{S}^2, L={L}", QB, make_qa_step,
        exact_zero=("attention.key.bias", "qa_head.fc2.bias"))
    del model, plain, batches
    torch.cuda.empty_cache()
    return results, counts


def timed_qa_scores(model, batches, dev):
    """The QA eval step on batches already on the card, with the bias cache
    the eval loop builds, timed with a host clock around work that ends in a
    synchronize, after one untimed forward. -> (scores, clips/s)."""
    import torch

    from clover_tpu_torch.engine import make_qa_eval_step
    from clover_tpu_torch.models import swin_bias_cache

    step = make_qa_eval_step(model)
    cache = swin_bias_cache(model.backbone, model.config.swin, batches[0]["imgs"].shape[2:5])
    on_dev = [tuple(torch.as_tensor(b[k]).to(dev) for k in ("imgs", "token_ids", "input_mask"))
              for b in batches]
    step(*on_dev[0], cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = [step(*a, cache) for a in on_dev]
    torch.cuda.synchronize()
    return torch.cat(scores).float(), sum(len(a[0]) for a in on_dev) / (time.perf_counter() - t0)


def drive_qa_eval(model, batches):
    """The QA eval as a user runs it: make_qa_eval_step through run_qa_eval,
    bias cache built at the first batch. -> {'acc'}."""
    import torch

    from clover_tpu_torch.engine import make_qa_eval_step, run_qa_eval
    from clover_tpu_torch.models import swin_bias_cache

    metrics = run_qa_eval(
        make_qa_eval_step(model), model, types.SimpleNamespace(), iter(batches),
        bias_cache=lambda m, dims: swin_bias_cache(m.backbone, m.config.swin, dims))
    torch.cuda.synchronize()
    return metrics


def qa_eval_phase(tag, cfg, n_batches, seed, dev, card, profile: bool, mask_token=False):
    """A QA eval path (Q8O, FIB): OB videos of 8 frames, one question of OL
    tokens each, through make_qa_eval_step + run_qa_eval with the kernels
    and with the plain versions on one seed's weights: launches per
    forward, finite (OB, answers) scores, per-row score cosine, the
    accuracy of both, clips/s, peak memory. -> the kernel path's counts."""
    import torch

    from clover_tpu_torch import ops

    model, plain = (m.eval() for m in qa_models(cfg))
    batches = make_qa_batches(cfg, n_batches, OB, 1, OL, seed, cfg.num_labels, mask_token)
    ops.reset_launch_counts()
    metrics = drive_qa_eval(model, batches)
    counts = launch_counts()
    check_launches(tag, counts, QA_EVAL_LAUNCHES, n_batches, "forward")
    torch.cuda.reset_peak_memory_stats(dev)
    scores, cps = timed_qa_scores(model, batches, dev)
    k_peak = peak_memory(dev)
    check(scores.shape == (OB * n_batches, cfg.num_labels) and bool(torch.isfinite(scores).all()),
          f"{tag} scores {tuple(scores.shape)}")
    ops.reset_launch_counts()
    p_metrics = drive_qa_eval(plain, batches)
    torch.cuda.reset_peak_memory_stats(dev)
    p_scores, p_cps = timed_qa_scores(plain, batches, dev)
    p_peak = peak_memory(dev)
    check(all(fn.launches == 0 for fn in ops.KERNELS), f"the plain {tag} path launched a kernel")
    cos = torch.nn.functional.cosine_similarity(scores, p_scores, dim=-1).min().item()
    gap = (scores - p_scores).abs().max().item()
    print(f"{tag} kernel vs plain scores: min cosine {cos:.6f} (bound {COS32_MIN}), max abs gap "
          f"{gap:.4e} (max|plain| {p_scores.abs().max().item():.4e}); accuracy kernels "
          f"{metrics['acc']:.4f} plain {p_metrics['acc']:.4f}", flush=True)
    check(cos >= COS32_MIN, f"{tag} kernel path disagrees with the plain path: cosine {cos:.6f}")
    print(f"{tag} clips/s (B={OB}, {T}x{S}^2, L={OL}, {cfg.num_labels} answers, {n_batches} "
          f"batches, forward only): kernels {cps:.2f} plain {p_cps:.2f}; peak memory kernels "
          f"{k_peak} plain {p_peak} on {card}", flush=True)
    if profile:
        profile_eval_path(model, cfg, batches, dev, OB * 1e3 / cps, f"kernel {tag} eval path")
    del model, plain
    torch.cuda.empty_cache()
    return counts


def itm_shapes(cfg, pairs, text_len):
    """The K3 / K4 calls of an ITM score call over ``pairs`` pairs."""
    calls = {"K1": [], "K2": [], "K3": [], "K4": [], "K6": []}
    for extra in (text_shapes(cfg, pairs, text_len), fusion_shapes(cfg, pairs, text_len)):
        for k, v in extra.items():
            calls[k] += v
    return calls


def itm_phase(dev, card, profile: bool):
    """ITM: K3 and K4 at a score call's shapes against their plain versions;
    ITM_CALLS score calls of ITM_PAIRS cached-token pairs (make_itm_score_step)
    with the kernels and with the plain versions (launches per call, the
    probabilities' largest gap, pairs/s); then run_itm_retrieval_eval end to
    end on both. -> (kernel results, the score calls' launch counts)."""
    import torch

    from clover_tpu_torch import ops
    from clover_tpu_torch.engine import (make_itm_embed_step, make_itm_score_step,
                                         run_itm_retrieval_eval)
    from clover_tpu_torch.models import swin_bias_cache

    cfg = qa_config(task="retrieval", use_itm_head=True)
    results = kernel_phase(cfg, dev, seed=SEED + 18, keys=("K3", "K4"),
                           calls=itm_shapes(cfg, ITM_PAIRS, L))
    model, plain = (m.eval() for m in qa_models(cfg))
    fu = cfg.fusion
    rng = np.random.default_rng(SEED + 19)
    tokens = torch.from_numpy(rng.normal(size=(ITM_CALLS, ITM_PAIRS, fu.num_frames,
                                               fu.spatial_tokens, fu.img_in_size))
                              .astype(np.float32)).to(dev).bfloat16()
    ids = torch.from_numpy(rng.integers(1000, 30000, size=(ITM_CALLS, ITM_PAIRS, L))).to(dev)
    mask = torch.ones(ITM_PAIRS, L, dtype=torch.long, device=dev)

    def score_calls(m):
        step = make_itm_score_step(m)
        step(tokens[0], ids[0], mask)   # an untimed warm-up call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = torch.stack([step(tokens[i], ids[i], mask) for i in range(ITM_CALLS)])
        torch.cuda.synchronize()
        return out, ITM_CALLS * ITM_PAIRS / (time.perf_counter() - t0)

    ops.reset_launch_counts()
    scores, pps = score_calls(model)
    counts = launch_counts()
    check_launches("ITM score", counts, ITM_LAUNCHES, ITM_CALLS + 1, "call")
    ops.reset_launch_counts()
    p_scores, p_pps = score_calls(plain)
    check(all(fn.launches == 0 for fn in ops.KERNELS), "the plain ITM path launched a kernel")
    check(scores.dtype == torch.float32 and scores.shape == (ITM_CALLS, ITM_PAIRS)
          and bool(((scores >= 0) & (scores <= 1)).all()), "ITM scores are not probabilities")
    gap = (scores - p_scores).abs().max().item()
    print(f"ITM score ({ITM_PAIRS} pairs a call of cached ({fu.num_frames}, {fu.spatial_tokens}, "
          f"{fu.img_in_size}) bf16 tokens, L={L}, {ITM_CALLS} calls): pairs/s kernels {pps:.2f} "
          f"plain {p_pps:.2f}; largest gap from plain {gap:.4e} (bound {ITM_GAP_MAX}) on {card}",
          flush=True)
    check(gap <= ITM_GAP_MAX, f"ITM scores disagree with the plain path: {gap:.4e}")
    if profile:
        step = make_itm_score_step(model)
        profile_runs([lambda i=i: step(tokens[i], ids[i], mask) for i in range(ITM_CALLS)],
                     ITM_PAIRS * 1e3 / pps, "kernel ITM score", "call")

    batches = make_batches(cfg, T, ITM_EVAL_BATCHES, SEED + 20)
    n = ITM_EVAL_BATCHES * B
    calls = -(-n * n // ITM_PAIRS)
    dataset = types.SimpleNamespace(text_video_ids=[[i] for i in range(n)])
    for m, path in ((model, "kernel"), (plain, "plain")):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        recall = run_itm_retrieval_eval(
            make_itm_embed_step(m), make_itm_score_step(m), m, dataset, iter(batches),
            bias_cache=lambda mm, dims: swin_bias_cache(mm.backbone, mm.config.swin, dims),
            pair_batch=ITM_PAIRS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # the embed step once a batch, the score step once a pair batch
        want = {k: (ITM_EVAL_BATCHES * v + calls * ITM_LAUNCHES.get(k, 0)
                    if m is model else 0) for k, v in ITM_EMBED_LAUNCHES.items()}
        check_launches(f"ITM retrieval eval, {path} path", launch_counts(), want, 1, "eval")
        check(set(recall) == {"Recall@1", "Recall@5", "Recall@10", "MR", "Recall@all"}
              and all(np.isfinite(v) for v in recall.values()), f"ITM recall {recall}")
        print(f"ITM retrieval eval, {path} path ({n} videos x {n} texts, every pair, {calls} "
              f"score calls of {ITM_PAIRS}): {recall} in {seconds:.2f} s", flush=True)
    del model, plain, tokens
    torch.cuda.empty_cache()
    return results, counts


def tr8_launches(epochs: int):
    """The kernel launches of ``epochs`` epochs of TR8: 4 steps and one
    eval of 2 forwards each."""
    steps, forwards = epochs * TR8_STEPS_PER_EPOCH, epochs * TR8_FORWARDS_PER_EVAL
    return {k: steps * TR8_STEP_LAUNCHES.get(k, 0) + forwards * TR8_FORWARD_LAUNCHES.get(k, 0)
            for k in set(TR8_STEP_LAUNCHES) | set(TR8_FORWARD_LAUNCHES)}


def read_json(path):
    with open(path) as f:
        return json.load(f)


def tr8_lines(work_dir):
    """metrics.jsonl's train and eval lines (the eval lines by step)."""
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return ([r for r in rows if "loss" in r],
            {r["step"]: r for r in rows if "Recall@1" in r})


def state_tensors(state):
    """Every tensor of a train state (parameters, buffers, AdamW state, EMA)."""
    out = {"param " + n: p.detach() for n, p in state.model.named_parameters()}
    out.update({"buffer " + n: b for n, b in state.model.named_buffers()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adamw {i} {k}": v for k, v in st.items()})
    out.update({"ema " + n: e for n, e in (state.ema_params or {}).items()})
    return out


def tr8_phase(dev, card):
    """TR8: the config-driven trainer and evaluator at full width through
    the port's entry points, in this process, in a temporary work dir that is
    removed at the end whether the phase passes or not. The train entry for
    2 epochs (exact launches, metrics.jsonl, best.json and the meta files);
    the latest checkpoint restored into a fresh model and optimizer (bitwise
    the trained state); the train entry again with --resume to 3 epochs (it
    starts at epoch 2 and ends at step 12); the test entry on the best step
    (its metrics equal the trainer's eval line); three train-loader epochs
    through one prefetch_to_device call, its pinned slots and the recycled
    host buffers both reused (bitwise the synchronous copies); the per-step metric sync's cost on a staged batch.
    -> the first run's launch counts and its metrics.jsonl lines (train
    lines, eval lines by step)."""
    import shutil
    import tempfile

    import torch

    from clover_tpu_torch import ops
    from clover_tpu_torch.builder import build_dataset, build_loader, build_model
    from clover_tpu_torch.config import load_config, parse_cfg_options
    from clover_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from clover_tpu_torch.engine import CheckpointManager, to_model_batch
    from clover_tpu_torch.tools import test as test_entry
    from clover_tpu_torch.tools import train as train_entry
    from clover_tpu_torch.utils.logging import get_logger

    # the entries log their parameter table and every step at INFO: kept in
    # the work dir's metrics.jsonl, summarised here
    logger = get_logger()
    level = logger.level
    logger.setLevel("WARNING")
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), TR8_CONFIG)
    options = ["--cfg-options", *TR8_OPTIONS]
    cfg = load_config(config, overrides=parse_cfg_options(list(TR8_OPTIONS)))
    work = tempfile.mkdtemp(prefix="clover_tr8_")
    ckpt = os.path.join(work, "checkpoints")
    parts = {}
    t_phase = time.perf_counter()
    try:
        # 1. two epochs through the train entry
        ops.reset_launch_counts()
        torch.empty(0, device=dev)   # the allocator up, so that its peak can be reset
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer = train_entry.main([config, "--work-dir", work, *options])
        torch.cuda.synchronize()
        parts["train entry, 2 epochs"] = time.perf_counter() - t0
        counts = launch_counts()
        peak = peak_memory(dev)
        check_launches("TR8 train entry (8 steps, 2 evals of 2 forwards)", counts,
                       tr8_launches(2), 1, "run")
        train, evals = tr8_lines(work)
        first = (train, evals)
        check(len(train) == 2 * TR8_STEPS_PER_EPOCH
              and [r["step"] for r in train] == list(range(1, 9))
              and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in train),
              f"TR8 train lines {train}")
        check(sorted(evals) == [4, 8] and all(
            {"Recall@1", "Recall@5", "Recall@10", "Recall@all"} <= set(r) for r in evals.values()),
            f"TR8 eval lines {evals}")
        mgr = CheckpointManager(ckpt)
        best = read_json(os.path.join(ckpt, "best.json"))
        kept = mgr.all_steps()
        check(kept[-1] == 8 and best["step"] in kept and all(
            os.path.exists(os.path.join(ckpt, f"meta_{st:010d}.json")) for st in kept),
            f"TR8 checkpoints {kept}, best {best}")
        saves = trainer.ckpt.saves
        for r in train:
            print(f"TR8 step {r['step']} (epoch {int(r['epoch'])}): loss {r['loss']:.4f} "
                  f"grad_norm {r['grad_norm']:.4f} steps/s {r['steps_per_sec']:.4f}")
        shown = {st: {k: v for k, v in r.items() if k != "time"} for st, r in evals.items()}
        print(f"TR8 train entry: {len(train)} steps, evals {shown}; checkpoints kept {kept}, "
              f"best {best}; peak memory {peak} on {card}", flush=True)
        epoch2 = [TR8_CLIPS * r["steps_per_sec"] for r in train if r["epoch"] == 1]
        print(f"TR8 train clips/s over epoch 2 (logged steps_per_sec x {TR8_CLIPS}; the first "
              f"step's time holds epoch 1's eval and checkpoint saves): "
              f"{[round(c, 2) for c in epoch2]}, steps 2-4 mean "
              f"{np.mean(epoch2[1:]):.2f} on {card}", flush=True)

        # 2. the latest checkpoint into a freshly built model and optimizer
        t0 = time.perf_counter()
        model, _ = build_model(cfg.model, device=dev)
        fresh = train_entry.make_train_state(cfg, model, TR8_STEPS_PER_EPOCH)
        check(mgr.restore(fresh) is fresh, "TR8: no checkpoint to restore")
        torch.cuda.synchronize()
        parts["restore"] = time.perf_counter() - t0
        got, want = state_tensors(fresh), state_tensors(trainer.state)
        check(got.keys() == want.keys() and fresh.step == trainer.state.step == 8,
              f"TR8 restore: step {fresh.step}, {len(got)} of {len(want)} tensors")
        differ = [k for k in want if not (got[k].dtype == want[k].dtype
                                          and torch.equal(got[k], want[k]))]
        check(not differ, f"TR8 restore differs from the trained state: {differ[:5]}")
        print(f"TR8 restore: step 8, {len(want)} tensors bitwise the trained state "
              f"({sum(1 for k in want if k.startswith('adamw'))} AdamW entries) in "
              f"{parts['restore']:.2f} s", flush=True)
        # the eval on the restored weights, timed: clips/s of one eval call
        val = build_dataset(cfg.data.val, None)
        eval_fn = train_entry.build_eval_fn(cfg, model, val, build_loader(
            val, cfg.data.val_loader, test=True), cfg.img_size)
        model.eval()
        eval_fn(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored_metrics = eval_fn(model)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        want_eval = {k: v for k, v in evals[8].items() if k not in ("step", "time")}
        check(restored_metrics == want_eval,
              f"TR8 eval of the restored weights {restored_metrics}, trainer {want_eval}")
        print(f"TR8 eval clips/s ({len(val)} clips of 8 x 224^2 from uint8 frames, the loader, "
              f"preprocess and bias cache included): {len(val) / eval_s:.2f} "
              f"({eval_s:.3f} s) on {card}", flush=True)
        del model, fresh, got, want, trainer
        torch.cuda.empty_cache()

        # 3. resume to 3 epochs
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        resumed = train_entry.main([config, "--work-dir", work, "--resume", *options,
                                    "total_epochs=3"])
        torch.cuda.synchronize()
        parts["train entry, --resume to 3 epochs"] = time.perf_counter() - t0
        check(resumed.start_epoch == 2 and resumed.state.step == 12,
              f"TR8 resume: start epoch {resumed.start_epoch}, step {resumed.state.step}")
        check_launches("TR8 resume (4 steps, 1 eval)", launch_counts(), tr8_launches(1), 1, "run")
        train, evals = tr8_lines(work)
        check([r["step"] for r in train][-4:] == [9, 10, 11, 12] and 12 in evals,
              f"TR8 resumed lines {train[-4:]}")
        saves += resumed.ckpt.saves

        # the per-step metric sync (float() of every metric, as the JAX
        # trainer does): 3 steps on a staged batch with it and 3 without
        ds = build_dataset(cfg.data.train, None)
        loader = DataLoader(ds, batch_size=TR8_CLIPS, num_workers=2, seed=0)
        staged = to_model_batch(next(iter(loader)), cfg.img_size, torch.bfloat16, dev)
        step = resumed.train_steps[0]
        gen = torch.Generator(device=dev).manual_seed(1)
        timed = {}
        for mode in ("sync", "nosync", "sync", "nosync"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                _, metrics = step(resumed.state, staged, gen)
                if mode == "sync":
                    metrics = {k: float(v) for k, v in metrics.items()}
            torch.cuda.synchronize()
            timed.setdefault(mode, []).append((time.perf_counter() - t0) / 3)
        # the train loader alone (its 2 thread workers, no device work): s a batch
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in loader.epoch(2))
        loader_s = (time.perf_counter() - t0) / n_batches
        logged = [1 / r["steps_per_sec"] for r in train
                  if r["epoch"] >= 1 and r["step"] % TR8_STEPS_PER_EPOCH != 1]
        print(f"TR8 s a step: on a staged batch with the per-step float() of every metric "
              f"{[round(t, 4) for t in timed['sync']]}, without (one sync after 3) "
              f"{[round(t, 4) for t in timed['nosync']]}; the train loader alone "
              f"{loader_s:.4f} s a batch; the trainer's logged steps (epochs 2-3, each "
              f"epoch's first left out) {[round(t, 4) for t in logged]} on {card}", flush=True)
        del resumed, staged
        torch.cuda.empty_cache()

        # 4. the test entry on the best step
        best = read_json(os.path.join(ckpt, "best.json"))["step"]
        t0 = time.perf_counter()
        metrics = test_entry.main([config, "--ckpt-dir", ckpt, "--step", str(best), *options])
        parts["test entry"] = time.perf_counter() - t0
        want_eval = {k: v for k, v in evals[best].items() if k not in ("step", "time")}
        check(metrics == want_eval, f"TR8 test entry {metrics}, trainer's eval line {want_eval}")
        print(f"TR8 test entry on the best step {best}: {metrics}, the trainer's eval line's",
              flush=True)

        # 5. three train-loader epochs through one prefetch_to_device call:
        # 12 batches through 3 pinned slots (size=1) and a 5-deep recycled
        # host ring, so both rings wrap; nothing syncs until every batch is
        # in, then each kept device batch is held against its synchronous copy
        epochs = (1, 2, 3)

        def chained(loader):
            return (b for e in epochs for b in loader.epoch(e))

        pooled = DataLoader(ds, batch_size=TR8_CLIPS, num_workers=2, seed=0, reuse_buffers=5)
        plain = DataLoader(ds, batch_size=TR8_CLIPS, num_workers=2, seed=0)
        t0 = time.perf_counter()
        kept_batches = list(prefetch_to_device(chained(pooled), dev, size=1))
        torch.cuda.synchronize()
        parts["prefetch 3 epochs"] = time.perf_counter() - t0
        want = list(chained(plain))
        check(len(kept_batches) == len(want) == len(epochs) * TR8_STEPS_PER_EPOCH,
              f"TR8 prefetch gave {len(kept_batches)} batches of {len(want)}")
        for got_b, host in zip(kept_batches, want):
            check(got_b.keys() == host.keys() and all(
                torch.equal(got_b[k], torch.as_tensor(np.asarray(v)).to(dev))
                for k, v in host.items()), "TR8 prefetched batch differs from its synchronous copy")
        print(f"TR8 prefetch_to_device: {len(kept_batches)} batches of {len(epochs)} epochs "
              f"through 3 pinned slots and reuse_buffers=5, bitwise the synchronous copies",
              flush=True)
        del kept_batches, want
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
        logger.setLevel(level)
    parts["phase"] = time.perf_counter() - t_phase
    print(f"TR8 seconds: {{{', '.join(f'{k}: {v:.2f}' for k, v in parts.items())}}}; "
          f"checkpoint saves, host snapshot + write s: "
          f"{[(round(sv['snapshot_s'], 3), round(sv['write_s'], 3)) for sv in saves]} of "
          f"{saves[0]['bytes'] / 2**30:.3f} GiB each on {card}", flush=True)
    return counts, first


# DP8's rank program, run under torchrun from a temporary file: sys.argv[1:]
# = the repo root, rank 0's work dir, the profiled steps (0: none), "plain"
# for the model's plain versions (else "kernels"), the config, its options
DP8_RANK = """
import json, os, sys, time
t_start, wall_start = time.perf_counter(), time.time()
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
root, work, steps, route, config, *options = sys.argv[1:]
steps = int(steps)
sys.path.insert(0, root)
from chip_smoke import launch_counts
from clover_tpu_torch import ops
from clover_tpu_torch.config import load_config, parse_cfg_options
from clover_tpu_torch.engine import to_model_batch
from clover_tpu_torch.parallel import all_reduce_grads, mesh
from clover_tpu_torch.tools import train as train_entry
from clover_tpu_torch.utils.logging import get_logger

if route == "plain":
    # the fp32 run: the kernels take bf16 only, so the model runs its plain
    # PyTorch versions; the data-parallel code is the same
    import functools
    from clover_tpu_torch import builder
    builder.CloverFinetune = functools.partial(builder.CloverFinetune, kernels=False)
torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke's main sets for TR8
torch.backends.cudnn.allow_tf32 = False
rank = int(os.environ["RANK"])
get_logger().setLevel("WARNING" if rank else "INFO")
# rank 0 in the work dir, every other rank in one of its own: only rank 0 may write
mine = work if rank == 0 else os.path.join(work, "rank" + str(rank))
ops.reset_launch_counts()
t0 = time.perf_counter()
import_s = t0 - t_start
trainer = train_entry.main([config, "--distributed", "--work-dir", mine, "--cfg-options",
                            *options])
torch.cuda.synchronize()
t1 = time.perf_counter()
counts = launch_counts()
params = list(trainer.state.model.parameters())
out = {"rank": mesh.rank(), "world": mesh.world(), "import_s": import_s, "train_s": t1 - t0,
       "wall_start": wall_start, "launches": counts,
       "grad_bytes": sum(p.numel() * p.element_size() for p in params)}
if steps:
    # the NCCL device time a step: the trainer's (warm) step on this rank's first
    # batch, `steps` steps under torch.profiler (the device's activity only:
    # a step's ~10k host ops would take seconds to collect)
    cfg = load_config(config, overrides=parse_cfg_options(options))
    dev = torch.device("cuda", torch.cuda.current_device())
    batch = to_model_batch(next(iter(trainer.train_loaders[0].epoch(0))), cfg.img_size,
                           torch.bfloat16, dev)
    step, state, gen = trainer.train_steps[0], trainer.state, trainer.generator
    mesh.barrier()   # the ranks start the window together: no NCCL wait for a late rank
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(state, batch, gen)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    # the gradient reduction alone (its flat buckets' copies and NCCL), the ranks
    # started together: a step's NCCL kernels above also hold the wait for the
    # slowest rank's backward
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    mesh.barrier()
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        all_reduce_grads(params, mesh.data_group())
    end.record()
    torch.cuda.synchronize()
    out.update(nccl_ms=sum(e.time_range.elapsed_us() for e in nccl) / 1e3 / steps,
               nccl_launches=len(nccl) / steps, reduce_ms=start.elapsed_time(end) / steps,
               busy_ms=sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
# every rank's parameters after the steps, one fp64 sum a tensor: the replicas
# must hold the same bits (one reduction, one update)
sums = torch.stack([p.detach().double().sum() for p in params]).cpu().tolist()
every = [None] * mesh.world()
dist.all_gather_object(every, sums)
out.update(replicas_equal=all(e == every[0] for e in every),
           profile_s=time.perf_counter() - t1)
primary = mesh.is_primary()
trainer.metrics.close()
dist.destroy_process_group()
if primary:
    out["wall_end"] = time.time()
    print("DP8 " + json.dumps(out), flush=True)
"""


def dp8_torchrun(root, work, name, world, steps, route, options):
    """``torchrun --standalone --nproc_per_node=world`` of DP8's rank program
    (written in ``work``) with rank 0's work dir ``work/name``, in a session of
    its own so that a timeout ends torchrun and its ranks. -> (rank 0's
    result, its work dir, the seconds from the launch to torchrun's exit)."""
    import signal

    script, run_dir = os.path.join(work, "dp8_rank.py"), os.path.join(work, name)
    if not os.path.exists(script):
        with open(script, "w") as f:
            f.write(DP8_RANK)
    t0, wall0 = time.perf_counter(), time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={world}", script, root, run_dir, str(steps), route,
         os.path.join(root, TR8_CONFIG), *options],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"DP8 {name}: torchrun exited {proc.returncode}:\n{log[-6000:]}")
    found = [line[line.index("DP8 {") + 4:] for line in log.splitlines() if "DP8 {" in line]
    check(len(found) == 1, f"DP8 {name} printed no result:\n{log[-6000:]}")
    res = json.loads(found[0])
    res["start_s"] = res["wall_start"] - wall0
    check(res["world"] == world, f"DP8 {name} ran {res['world']} ranks, not {world}")
    check(res["replicas_equal"], f"DP8 {name}: the ranks' parameters differ after the steps")
    return res, run_dir, seconds


def step_gaps(tag, lines, want_lines):
    """Each train line's (loss, grad_norm) relative gaps to ``want_lines``'
    at the same step, printed. -> [(step, loss gap, grad_norm gap)]."""
    check([r["step"] for r in lines] == [r["step"] for r in want_lines] == list(range(1, 9)),
          f"{tag} steps {[r['step'] for r in lines]} against {[r['step'] for r in want_lines]}")
    out = []
    for r, want in zip(lines, want_lines):
        gaps = [abs(r[k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm")]
        print(f"{tag} step {r['step']}: loss {r['loss']!r} grad_norm {r['grad_norm']!r}; "
              f"against {want['loss']!r} {want['grad_norm']!r} (gaps {gaps[0]:.3e}, "
              f"{gaps[1]:.3e})", flush=True)
        out.append((r["step"], *gaps))
    return out


def dp8_phase(card, tr8_first):
    """DP8: TR8's run as a data-parallel job, ``torchrun --standalone
    --nproc_per_node=W`` of the train entry with --distributed (NCCL) on
    every visible card, in a temporary work dir removed at the end. Rank 0's
    metrics.jsonl against TR8's first run (``tr8_first``: its train lines,
    its eval lines by step): bitwise at W = 1, step 1 within DP8_LOSS_RTOL
    at W >= 2; launches a step and an eval forward as TR8's; the ranks'
    parameters equal; the other ranks' work dirs empty. At W >= 2 also the
    eval against the test entry's on the same weights, and the fp32 run on
    W ranks against one process (``DP8_FP32_OPTIONS``). -> rank 0's launch
    counts."""
    import shutil
    import tempfile

    import torch

    from clover_tpu_torch.tools import test as test_entry

    world = torch.cuda.device_count()
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="clover_dp8_")
    t0 = time.perf_counter()
    try:
        res, run_dir, seconds = dp8_torchrun(root, work, "run", world, DP8_PROFILE_STEPS,
                                             "kernels", DP8_OPTIONS)
        print(f"DP8 seconds: torchrun {seconds:.2f} (torchrun and a rank's start "
              f"{res['start_s']:.2f}, rank 0's imports {res['import_s']:.2f}, its "
              f"train entry {res['train_s']:.2f}, its profiled steps "
              f"{res['profile_s']:.2f}, then torchrun's exit {time.time() - res['wall_end']:.2f}; "
              f"{'within' if seconds <= DP8_SECONDS_MAX else 'over'} the phase's budget of "
              f"{DP8_SECONDS_MAX:.0f}) on {card}", flush=True)
        counts = {k: res["launches"][k] for k in launch_counts()}
        check_launches(f"DP8 train entry, --distributed at W={world} (rank 0: 8 steps, "
                       "1 eval of 2 forwards)", counts,
                       {k: 8 * TR8_STEP_LAUNCHES.get(k, 0) + TR8_FORWARDS_PER_EVAL
                        * TR8_FORWARD_LAUNCHES.get(k, 0)
                        for k in set(TR8_STEP_LAUNCHES) | set(TR8_FORWARD_LAUNCHES)}, 1, "run")
        train, evals = tr8_lines(run_dir)
        tr8_train, tr8_evals = tr8_first
        check(sorted(evals) == [8], f"DP8 eval lines at steps {sorted(evals)}")
        gaps = step_gaps(f"DP8 at W={world} against TR8,", train, tr8_train)
        got = {k: v for k, v in evals[8].items() if k not in ("step", "time")}
        want = {k: v for k, v in tr8_evals[8].items() if k not in ("step", "time")}
        if world == 1:
            check(all(r[k] == w[k] for r, w in zip(train, tr8_train)
                      for k in ("loss", "grad_norm")), f"DP8 at W=1 differs from TR8: {gaps}")
            check(got == want, f"DP8 eval {got}, TR8's at step 8 {want}")
        else:
            # the one step from the same weights: the bf16 GEMMs' rounding at 16 / W
            # rows a rank, which every later AdamW step amplifies
            check(max(gaps[0][1:]) <= DP8_LOSS_RTOL,
                  f"DP8 step 1 gaps {gaps[0][1:]} > {DP8_LOSS_RTOL}")
        ckpt = os.path.join(run_dir, "checkpoints")
        others = sorted(d for d in os.listdir(run_dir) if d.startswith("rank"))
        check(os.path.exists(os.path.join(ckpt, "step_0000000008"))
              and os.path.exists(os.path.join(ckpt, "best.json"))
              and others == [f"rank{r}" for r in range(1, world)]
              and all(os.listdir(os.path.join(run_dir, d)) == ["checkpoints"]
                      and not os.listdir(os.path.join(run_dir, d, "checkpoints"))
                      for d in others),
              f"DP8 artifacts: {sorted(os.listdir(ckpt))}, other ranks {others}")
        cps = [TR8_CLIPS * r["steps_per_sec"] for r in train if r["epoch"] == 1][1:]
        tr8_cps = [TR8_CLIPS * r["steps_per_sec"] for r in tr8_train if r["epoch"] == 1][1:]
        ar_bytes = 2 * (world - 1) / world * res["grad_bytes"]
        print(f"DP8 at W={world}: eval {got}, TR8's at step 8 {want}; train clips/s (16 "
              f"global clips a step, epoch 2 but its first step) "
              f"{[round(c, 2) for c in cps]}, mean {np.mean(cps):.2f}, "
              f"TR8's {[round(c, 2) for c in tr8_cps]}, mean {np.mean(tr8_cps):.2f} on {card}",
              flush=True)
        print(f"DP8 NCCL a step (rank 0, {DP8_PROFILE_STEPS} profiled steps): "
              f"{res['nccl_ms']:.3f} ms in {res['nccl_launches']:.1f} kernels of "
              f"{res['busy_ms']:.2f} ms busy; the gradient reduction alone (CUDA events, "
              f"the ranks started together) {res['reduce_ms']:.3f} ms; its bound "
              f"{ar_bytes / NVLINK_BYTES * 1e3:.3f} ms ({ar_bytes / 1e9:.3f} GB of "
              f"{res['grad_bytes'] / 1e9:.3f} GB fp32 gradients over {NVLINK_BYTES / 1e9:.0f} "
              f"GB/s); peak {res['peak_gib']:.2f} GiB on {card}", flush=True)
        if world > 1:
            # the eval's gathers and loader shards: one process on the same
            # weights, each forward at the ranks' shapes, equal metrics
            t1 = time.perf_counter()
            per_rank = -(-TR8_VAL_BATCH // world)
            one = test_entry.main([os.path.join(root, TR8_CONFIG), "--ckpt-dir", ckpt,
                                   "--step", "8", "--cfg-options", *DP8_OPTIONS,
                                   f"data.val_loader.batch_size={per_rank}"])
            print(f"DP8 eval at W={world} {got}; the test entry in one process on rank 0's "
                  f"step 8, {per_rank} clips a forward, {one} "
                  f"({time.perf_counter() - t1:.2f} s)", flush=True)
            check(one == got, f"DP8 eval at W={world} {got}, one process {one}")
            gc.collect()
            torch.cuda.empty_cache()   # the fp32 run at W = 1 shares this card
            # the contract without the bf16 rounding: fp32 through the plain
            # versions, W ranks against one process, every step
            fp32 = {}
            for n in (world, 1):
                r, d, sec = dp8_torchrun(root, work, f"fp32_w{n}", n, 0, "plain",
                                         DP8_FP32_OPTIONS)
                check(not any(r["launches"].values()),
                      f"DP8 fp32 at W={n} launched kernels: {r['launches']}")
                fp32[n] = tr8_lines(d)[0]
                print(f"DP8 fp32 (plain versions) at W={n}: {sec:.2f} s", flush=True)
            gaps = step_gaps(f"DP8 fp32 at W={world} against W=1,", fp32[world], fp32[1])
            worst = max(max(g[1:]) for g in gaps)
            print(f"DP8 fp32 at W={world}: largest gap {worst:.3e} (limit {DP8_FP32_RTOL})",
                  flush=True)
            check(worst <= DP8_FP32_RTOL,
                  f"DP8 fp32 at W={world}: gaps {gaps} > {DP8_FP32_RTOL}")
        print(f"DP8 seconds: phase {time.perf_counter() - t0:.2f} on {card}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


SRV_SERVE = """
import json, sys, time
import torch
from clover_tpu_torch import ops
from clover_tpu_torch.serving import load_bundle
work = sys.argv[1]
fns = load_bundle(work + "/srv_bundle")
models = sorted(m for m in sys.modules if m.startswith("clover_tpu_torch.models"))
inputs = torch.load(work + "/inputs.pt", weights_only=True)
video, text = fns["video_tower_b%d" % inputs["B"]], fns["text_tower_b%d" % inputs["B"]]
dev = torch.device("cuda", 0)
batches = [tuple(t.to(dev) for t in b) for b in inputs["batches"]]
with torch.inference_mode():
    video(batches[0][0]), text(*batches[0][1:])   # untimed: the graphs' first run
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.library.reset_call_counts()
    out_v, out_t = [], []
    t0 = time.perf_counter()
    for frames, ids, mask in batches:
        out_v.append(video(frames))
        out_t.append(text(ids, mask))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, calls = ops.launch_counts(), ops.library.call_counts()
    sim = fns["similarity"](*(t.to(dev) for t in inputs["sim"]))
torch.save({"video": torch.cat(out_v).cpu(), "text": torch.cat(out_t).cpu(), "sim": sim.cpu()},
           work + "/served.pt")
print(json.dumps({"models": models, "seconds": seconds, "launches": launches, "calls": calls,
                  "peak": torch.cuda.max_memory_allocated(dev)}))
"""


def graph_ops(ep):
    """{op: nodes} of an exported graph's clover ops and softmax calls."""
    found = {}
    for node in ep.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and ("clover." in name or "softmax" in name):
            key = name.split(".")[1] if name.startswith("clover.") else name
            found[key] = found.get(key, 0) + 1
    return found


def check_graphs(exports, tag, B, want):
    """The video and text graphs hold exactly ``want``'s clover ops, and the
    video graph no softmax (no plain attention)."""
    for tower, ops_want in want.items():
        got = graph_ops(exports[f"{tower}_tower_b{B}"])
        print(f"{tag} {tower}_tower_b{B} graph: {got}", flush=True)
        check({k: n for k, n in got.items() if "softmax" not in k} == ops_want,
              f"{tag} {tower} graph's ops {got}, expected {ops_want}")
        if tower == "video":
            check(not any("softmax" in k for k in got), f"{tag}: plain attention in {got}")


def dispatch_us(dev, rows, C, reps=200):
    """Host microseconds a call of K4 through its op and through the direct
    wrapper (A B B A rounds, each timing ``reps`` calls queued without a
    synchronize, after one), on (rows, C) bf16."""
    import torch

    from clover_tpu_torch.ops import fused_layer_norm, library

    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    x = torch.randn(rows, C, generator=g, device=dev).bfloat16()
    w, b = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    forms = {"op": lambda: library.k4_layer_norm(x, w, b, 1e-5),
             "direct": lambda: fused_layer_norm(x, w, b, 1e-5)}
    us = {k: [] for k in forms}
    with torch.inference_mode():
        check(torch.equal(forms["op"](), forms["direct"]()), "K4's op differs from its wrapper")
        for name in ("op", "direct", "direct", "op"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                forms[name]()
            us[name].append((time.perf_counter() - t0) * 1e6 / reps)
            torch.cuda.synchronize()
    return {k: round(min(v), 2) for k, v in us.items()}


def srv_phase(dev, card):
    """SRV: the dress rehearsal's main (tools/dress_rehearsal.py: convert,
    load_from, export, serve, its gates); then eval8's towers on the
    converted checkpoint exported, saved, loaded in a process that
    imports no model module and served (exact ops in the graphs, exact
    launches a forward, embeddings against the eager kernel path and the
    plain path, the similarity artifact against similarity_fn, clips/s
    against the eager path, export seconds, bundle bytes, peak memory, the
    ops' host cost a call); then the 32-frame towers through the export
    entry. The temporary work dir is removed whether it passes or not. ->
    (launch counts over the 8-frame serve, over the 32-frame batch)."""
    import shutil
    import tempfile

    import torch

    from clover_tpu_torch import ops
    from clover_tpu_torch.builder import build_model
    from clover_tpu_torch.config import load_config
    from clover_tpu_torch.engine import CheckpointManager, restore_or_init
    from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig, SwinConfig,
                                         swin_bias_cache)
    from clover_tpu_torch.models.swin3d import embed_dims, space_to_depth
    from clover_tpu_torch.ops.preprocess import eval_preprocess
    from clover_tpu_torch.serving import (export_retrieval_towers, load_bundle, save_bundle,
                                          similarity_fn)
    from clover_tpu_torch.tools import dress_rehearsal as dress

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="clover_srv_")
    try:
        # 1. the dress rehearsal end to end (its synthetic published
        # checkpoints converted, its gates), then the converted checkpoint
        # merged into eval8's model
        rehearsal = dress.main(["--work", work])
        t_rehearsal = time.perf_counter() - t_phase
        gc.collect()   # the rehearsal's exported modules hold reference cycles
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated(dev)
        converted_dir = rehearsal["converted"]
        cfg = FinetuneConfig(swin=SwinConfig.base(fold_normalize=True), text_bert=BertConfig())
        model = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=True).eval()
        loaded, fresh = restore_or_init(model, CheckpointManager(converted_dir).restore_params(),
                                        torch.Generator().manual_seed(SEED))
        check(loaded == ["backbone", "text_backbone"], f"SRV merged {loaded}, fresh {fresh}")
        t_convert = time.perf_counter() - t_phase
        print(f"SRV dress rehearsal {t_rehearsal:.1f} s (patch embed against Conv3d max abs err "
              f"{rehearsal['patch_embed_err']:.2e}, served vs eager {rehearsal['gap']:.3e}); "
              f"eval8's model merged {loaded} (fresh {fresh}); {t_convert:.1f} s; the card "
              f"held {left} bytes after the rehearsal", flush=True)

        # 2. export and save
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        exports = export_retrieval_towers(model, batch_sizes=(SRV_B,), frames=T, image_size=S,
                                          text_len=L, sim_candidates=SRV_CANDIDATES)
        export_s = time.perf_counter() - t0
        export_peak = peak_memory(dev)
        check_graphs(exports, "SRV", SRV_B, SRV_OPS)
        t0 = time.perf_counter()
        # a directory of its own: a bundle is every artifact in its directory
        bundle = save_bundle(exports, os.path.join(work, "srv_bundle"))
        save_s = time.perf_counter() - t0
        manifest = read_json(os.path.join(bundle, "manifest.json"))
        nbytes = {k: m["nbytes"] for k, m in manifest.items()}
        check(all(m["device"] == "cuda" for m in manifest.values())
              and nbytes[f"text_tower_b{SRV_B}"] < nbytes[f"video_tower_b{SRV_B}"],
              f"SRV manifest {manifest}")
        del exports

        # 3. served in a process without the model modules
        rng = np.random.default_rng(SEED + 40)
        batches = []
        for _ in range(SRV_BATCHES):
            lengths = rng.integers(8, L + 1, size=SRV_B)
            tok = rng.integers(1000, cfg.text_bert.vocab_size, size=(SRV_B, L))
            tok[:, 0] = 101
            mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
            batches.append((torch.from_numpy(rng.integers(0, 256, (SRV_B, T, S, S, 3),
                                                          dtype=np.uint8)),
                            torch.from_numpy(tok * mask), torch.from_numpy(mask)))
        sim_in = tuple(torch.from_numpy(rng.normal(size=(SRV_CANDIDATES, cfg.vts_embed_dim))
                                        .astype(np.float32)) for _ in range(2))
        torch.save({"B": SRV_B, "batches": batches, "sim": sim_in},
                   os.path.join(work, "inputs.pt"))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (os.getcwd(), os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", SRV_SERVE, work], capture_output=True,
                              text=True, env=env, timeout=600)
        serve_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"SRV serving process failed:\n{proc.stderr[-3000:]}")
        served_run = json.loads(proc.stdout.strip().splitlines()[-1])
        check(served_run["models"] == [], f"the serving process imported {served_run['models']}")
        counts = {k: served_run["launches"][fn.__name__] for k, fn in (
            ("K1", ops.flat2_window_attention), ("K2", ops.fused_ln_mlp_residual),
            ("K3", ops.fused_mlp_postln), ("K4", ops.fused_layer_norm),
            ("K6", ops.fused_window_attn_block))}
        check_launches("SRV (served in a process without the models)",
                       {**{k: 0 for k in launch_counts()}, **counts}, SRV_LAUNCHES, SRV_BATCHES,
                       "forward")
        check(sum(served_run["launches"].values()) == sum(counts.values()),
              f"SRV launched another kernel: {served_run['launches']}")
        served = torch.load(os.path.join(work, "served.pt"), weights_only=True)
        served_cps = SRV_B * SRV_BATCHES / served_run["seconds"]

        # 4. against the eager kernel path, the plain path and similarity_fn
        cache = swin_bias_cache(model.backbone, cfg.swin, embed_dims(cfg.swin, (T, S, S)))
        on_dev = [tuple(t.to(dev) for t in b) for b in batches]

        def eager(m, frames, ids, mask):
            imgs = space_to_depth(eval_preprocess(frames, S, m.dtype, normalize=False),
                                  cfg.swin.patch_size)
            return m.forward_video(imgs[:, None], cache).float(), m.forward_text(ids,
                                                                                 mask).float()

        # artifact against eager clips/s in this process: SRV_ROUNDS A B B A
        # rounds, each form timed over SRV_PASSES passes of the batches
        fns = load_bundle(bundle)
        forms = {"artifact": lambda frames, ids, mask: (fns[f"video_tower_b{SRV_B}"](frames),
                                                        fns[f"text_tower_b{SRV_B}"](ids, mask)),
                 "eager": lambda *b: eager(model, *b)}
        cps, kept = {k: [] for k in forms}, {}
        with torch.inference_mode():
            for name in forms:
                forms[name](*on_dev[0])
            for name in ("artifact", "eager", "eager", "artifact") * SRV_ROUNDS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SRV_PASSES):
                    kept[name] = [forms[name](*b) for b in on_dev]
                torch.cuda.synchronize()
                cps[name].append(SRV_B * SRV_BATCHES * SRV_PASSES / (time.perf_counter() - t0))
        here = [torch.cat([o[i] for o in kept["artifact"]]).cpu() for i in (0, 1)]
        check(torch.equal(here[0], served["video"]) and torch.equal(here[1], served["text"]),
              "SRV: the bundle loaded here differs from the serving process's")
        ev, et = (torch.cat([o[i] for o in kept["eager"]]).cpu() for i in (0, 1))
        del fns, forms, kept
        gap = max(float((served["video"] - ev).abs().max()),
                  float((served["text"] - et).abs().max()))
        plain = {}
        for dtype in (torch.bfloat16, torch.float32):
            ref = CloverFinetune(cfg, dtype=dtype, kernels=False).eval()
            ref.load_state_dict(model.state_dict())
            with torch.inference_mode():
                pv, pt = zip(*(eager(ref, *b) for b in on_dev))
            plain[dtype] = (torch.cat(pv).cpu(), torch.cat(pt).cpu())
            del ref, pv, pt
        cos_v, cos_t = min_cosines((served["video"], served["text"]), plain[torch.bfloat16])
        fp32_served = min_cosines((served["video"], served["text"]), plain[torch.float32])
        fp32_plain = min_cosines(plain[torch.bfloat16], plain[torch.float32])
        sim_gap = float((served["sim"] - similarity_fn(*sim_in)).abs().max())
        print(f"SRV served vs eager kernel path: max abs gap {gap:.3e} (bound {SRV_GAP_MAX}); "
              f"vs plain path: min cosine video {cos_v:.6f} text {cos_t:.6f} (bound "
              f"{SRV_COS_MIN}); against the fp32 plain path: served {fp32_served[0]:.6f} / "
              f"{fp32_served[1]:.6f}, bf16 plain {fp32_plain[0]:.6f} / {fp32_plain[1]:.6f} "
              f"(served no lower than bf16 plain less {SRV_FP32_MARGIN}); "
              f"similarity vs similarity_fn max abs {sim_gap:.3e}", flush=True)
        check(bool(torch.isfinite(served["video"]).all() and torch.isfinite(served["text"]).all()),
              "SRV: non-finite served embedding")
        check(gap <= SRV_GAP_MAX, f"SRV served embeddings differ from the eager path: {gap}")
        check(cos_v >= SRV_COS_MIN and cos_t >= SRV_COS_MIN,
              f"SRV served embeddings disagree with the plain path: {cos_v}, {cos_t}")
        check(all(s >= p - SRV_FP32_MARGIN for s, p in zip(fp32_served, fp32_plain)),
              f"SRV served embeddings are farther from the fp32 plain path ({fp32_served}) "
              f"than the bf16 plain path is ({fp32_plain})")
        check(sim_gap <= 1e-5, f"SRV similarity differs from similarity_fn: {sim_gap}")

        # 5. the ops' host cost a call: K4 at eval8's Swin stage-0 and text shapes
        dispatch = {shape: dispatch_us(dev, *shape)
                    for shape in ((B * T // 2 * 56 * 56, cfg.swin.embed_dim),
                                  (B * L, cfg.text_bert.hidden_size))}
        del model, cache, on_dev, served, ev, et
        torch.cuda.empty_cache()

        # 6. the 32-frame towers at B=8 through the export entry, one batch
        # against the eager model of the same config and checkpoint
        t0 = time.perf_counter()
        b32 = os.path.join(work, "bundle32")
        proc = subprocess.run([sys.executable, "-m", "clover_tpu_torch.tools.export", SRV32_CONFIG,
                               "--out", b32, "--ckpt-dir", converted_dir, "--batch-sizes",
                               str(SRV32_B), "--text-len", str(L), "--sim-candidates",
                               str(SRV32_B)], capture_output=True, text=True, env=env,
                              timeout=600)
        entry_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"SRV32 export entry failed:\n{proc.stderr[-3000:]}")
        print("SRV32 export entry log:\n  " + "\n  ".join(
            ln.split(" clover_tpu_torch ", 1)[-1] for ln in proc.stdout.splitlines()
            if " INFO " in ln or " WARNING " in ln), flush=True)
        # the export entry's weights: the same build, restore and seed
        scfg = load_config(SRV32_CONFIG)
        smodel, _ = build_model(scfg.model, device=dev)
        restore_or_init(smodel, CheckpointManager(converted_dir).restore_params(),
                        torch.Generator().manual_seed(0))
        smodel.eval()
        eps = {name: torch.export.load(os.path.join(b32, f"{name}.pt2"))
               for name in (f"video_tower_b{SRV32_B}", f"text_tower_b{SRV32_B}")}
        check_graphs(eps, "SRV32", SRV32_B, SRV32_OPS)
        fns = {name: ep.module().requires_grad_(False) for name, ep in eps.items()}
        del eps
        frames = torch.from_numpy(rng.integers(0, 256, (SRV32_B, T32, S, S, 3),
                                               dtype=np.uint8)).to(dev)
        ids, mask = (t[:SRV32_B].to(dev) for t in batches[0][1:])
        with torch.inference_mode():
            ops.reset_launch_counts()
            got_v, got_t = fns[f"video_tower_b{SRV32_B}"](frames), fns[f"text_tower_b{SRV32_B}"](
                ids, mask)
            torch.cuda.synchronize()
            counts32 = launch_counts()
            cache32 = swin_bias_cache(smodel.backbone, smodel.config.swin,
                                      embed_dims(smodel.config.swin, (T32, S, S)))
            want_v = smodel.forward_video(eval_preprocess(frames, S, smodel.dtype)[:, None],
                                          cache32).float()
            want_t = smodel.forward_text(ids, mask).float()
        check_launches("SRV32 (32-frame towers from the export entry)", counts32, SRV32_LAUNCHES,
                       1, "forward")
        gap32 = max(float((got_v - want_v).abs().max()), float((got_t - want_t).abs().max()))
        print(f"SRV32 served vs eager kernel path: max abs gap {gap32:.3e} (bound "
              f"{SRV_GAP_MAX})", flush=True)
        check(gap32 <= SRV_GAP_MAX and bool(torch.isfinite(got_v).all()),
              f"SRV32 served embeddings differ from the eager path: {gap32}")
        del smodel, fns, frames, got_v, got_t, want_v, want_t, cache32
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    ratio = float(np.median(cps["artifact"]) / np.median(cps["eager"]))
    print(f"SRV clips/s (B={SRV_B}, {T}x{S}^2 uint8 + L={L} text, {SRV_BATCHES} batches x "
          f"{SRV_PASSES} a reading): artifact {[round(c, 2) for c in cps['artifact']]} eager "
          f"{[round(c, 2) for c in cps['eager']]} in A B B A rounds (artifact_vs_eager of the "
          f"medians {ratio:.4f}); the serving process {served_cps:.2f}; export "
          f"{export_s:.2f} s (peak {export_peak}), save "
          f"{save_s:.2f} s, bundle bytes {nbytes}, the serving process {serve_s:.2f} s (peak "
          f"{served_run['peak'] / 2**30:.2f} GiB); the export entry at 32 frames {entry_s:.2f} s; "
          f"K4 host us a call (op, direct) {dispatch}; the phase "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return ({**{k: 0 for k in launch_counts()}, **counts}, counts32)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of clover_tpu_torch on one CUDA card.")
    ap.add_argument("--profile", action="store_true",
                    help="trace the kernel path's 8- and 32-frame eval forwards, the "
                         "forwards of each phase-5c path (E8H, E8S, E8P, E32L) and each "
                         "path's 12- and 32-frame finetune steps and pretrain steps (P32 and "
                         "P8E too), F12R's steps, E8F's forwards, Q8M's steps, Q8O's and FIB's "
                         "forwards and the ITM score calls with torch.profiler and print the "
                         "device time by kernel family")
    ap.add_argument("--dp8", action="store_true",
                    help="build the kernels and run TR8 and DP8 alone (DP8 holds TR8's run): "
                         "the data-parallel check, on every visible card")
    args = ap.parse_args(argv)
    profile = args.profile
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    try:
        from clover_tpu_torch import ops
        from clover_tpu_torch.models import (BertConfig, CloverFinetune, FinetuneConfig,
                                             SwinConfig, init_params)
        from clover_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a clover_tpu checkout ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0:.1f} s, "
          f"{_build.library_path().name})", flush=True)
    ok = json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}})
    if args.dp8:
        _, tr8_first = tr8_phase(dev, card)
        print(card_line(), flush=True)
        dp8_phase(card, tr8_first)
        print(ok)
        return 0

    cfg = FinetuneConfig(swin=SwinConfig.base(fold_normalize=True), text_bert=BertConfig())
    results = kernel_phase(cfg, dev)

    # built on the card (CloverFinetune's default device)
    model = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=True).eval()
    init_params(model, torch.Generator().manual_seed(SEED))
    plain = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=False).eval()
    plain.load_state_dict(model.state_dict())
    check(all(p.device == dev for p in model.parameters()), "the model is not on the card")
    batches = make_batches(cfg)

    ops.reset_launch_counts()
    metrics = drive_main_path(model, cfg, batches)
    counts = launch_counts()
    check_launches("8-frame", counts, {"K1": 24, "K2": 24, "K3": 12, "K4": 42}, N_BATCHES,
                   "forward")
    v, t, cps = timed_embeddings(model, cfg, batches, dev)
    check(v.shape == (B * N_BATCHES, cfg.vts_embed_dim) and t.shape == v.shape,
          f"embedding shapes {tuple(v.shape)}, {tuple(t.shape)}")
    check(bool(torch.isfinite(v).all() and torch.isfinite(t).all()), "non-finite embedding")
    check(set(metrics) >= {"Recall@1", "Recall@5", "Recall@10", "MR"}, f"metrics {metrics}")
    print(f"kernel path R@K: {metrics}", flush=True)
    if profile:
        profile_eval_path(model, cfg, batches, dev, B * 1e3 / cps, "kernel 8-frame eval path")

    ops.reset_launch_counts()
    p_metrics = drive_main_path(plain, cfg, batches)
    pv, pt, p_cps = timed_embeddings(plain, cfg, batches, dev)
    check(all(fn.launches == 0 for fn in ops.KERNELS), "the plain path launched a kernel")
    cos_v = torch.nn.functional.cosine_similarity(v, pv, dim=-1).min().item()
    cos_t = torch.nn.functional.cosine_similarity(t, pt, dim=-1).min().item()
    print(f"plain path R@K: {p_metrics}")
    print(f"kernel vs plain embeddings: min cosine video {cos_v:.6f} text {cos_t:.6f} "
          f"(bound {COS_MIN})")
    check(cos_v >= COS_MIN and cos_t >= COS_MIN,
          f"kernel path disagrees with the plain path: min cosine video {cos_v:.6f} "
          f"text {cos_t:.6f}, bound {COS_MIN}")
    print(f"clips/s (B={B}, {T}x{S}^2, L={L}, {N_BATCHES} batches, forward only): "
          f"kernels {cps:.2f} plain {p_cps:.2f} on {card}", flush=True)

    # the 32-frame eval, same models
    del v, t, pv, pt
    results32 = kernel_phase(cfg, dev, T32, SEED + 3)
    counts32 = eval32_phase(model, plain, cfg, dev, card, profile)

    # the spatial block path and the attention_impl / long_attn routes, on
    # the eval model's weights
    spatial = spatial_kernel_phase(cfg.swin, dev)
    weights = model.state_dict()
    spatial_counts = {path: spatial_path_phase(path, weights, dev, card, profile)
                      for path in SPATIAL_PATHS}
    del weights

    # the finetune step; the eval models' weights are still the seeded ones
    train = {}
    train_kernel_phase(cfg, dev, train)
    model.train()
    plain.train()
    train_counts = train_phase(model, plain, cfg, dev, card, profile)

    # the 32-frame finetune step, both paths from the seeded weights again
    train32 = {}
    train_kernel_phase(cfg, dev, train32, T32, SEED + 4)
    init_params(model, torch.Generator().manual_seed(SEED))
    plain.load_state_dict(model.state_dict())
    train32_counts = train_phase(model, plain, cfg, dev, card, profile, T32)

    # the pretrain step, on its own models from the same seed
    del model, plain
    torch.cuda.empty_cache()
    print(card_line(), flush=True)
    pre = {}
    pcfg = pretrain_config()
    train_kernel_phase(pcfg, dev, pre, PT, SEED + 6)
    pretrain_kernel_phase(pcfg, dev, pre)
    pre_counts = pretrain_phase(dev, card, profile)

    # the 32-frame pretrain step under the TPU's remat recipe (K7)
    print(card_line(), flush=True)
    pre32 = {}
    p32cfg = pretrain32_config()
    train_kernel_phase(p32cfg, dev, pre32, PT32, SEED + 8)
    pretrain_kernel_phase(p32cfg, dev, pre32, SEED + 9, pretrain_rows(PT32))
    pre32_counts = pretrain_phase(dev, card, profile, p32cfg, PT32, PRETRAIN32_LAUNCHES,
                                  tag=f"pretrain ({PT32} frames, remat 0-1, K7)")

    # the 8-frame pretrain step through the pair (K8)
    print(card_line(), flush=True)
    pre_erf = {}
    ecfg = pretrain_erf_config()
    train_kernel_phase(ecfg, dev, pre_erf, PT, SEED + 10)
    pre_erf_counts = pretrain_phase(dev, card, profile, ecfg, PT, PRETRAIN_ERF_LAUNCHES,
                                    PRETRAIN_ERF_STEPS, f"pretrain ({PT} frames, erf, remat, K8)")

    # the RGB-frame paths and 'fused_block', on the eval model's seeded weights
    print(card_line(), flush=True)
    model = CloverFinetune(cfg, dtype=torch.bfloat16, kernels=True)
    init_params(model, torch.Generator().manual_seed(SEED))
    weights = model.state_dict()
    del model
    preprocess_phase(dev, card)
    r8_counts = rgb_eval_phase(weights, dev, card)
    f12r_counts = rgb_train_phase(dev, card, profile)
    fcfg = FinetuneConfig(swin=SwinConfig.base(fold_normalize=True, **E8F[0]),
                          text_bert=BertConfig())
    e8f = kernel_phase(fcfg, dev, T, SEED + 13, keys=("K6", "K4"))
    e8f_counts = spatial_path_phase("E8F", weights, dev, card, profile, E8F)
    del weights

    # slice 4: the QA / MC / FIB finetune and the ITM rerank, through the fusion tower
    print(card_line(), flush=True)
    q8m, q8m_counts = q8m_phase(dev, card, profile)
    q8o_cfg = qa_config(task="video_qa", answer_cls=True, qa_head="oe", num_labels=O_LABELS)
    q8o = kernel_phase(q8o_cfg, dev, T, SEED + 21, keys=("K1", "K2", "K3", "K4"), clips=OB,
                       text_len=OL)
    q8o_counts = qa_eval_phase("Q8O (QA-OE eval)", q8o_cfg, O_BATCHES, SEED + 22, dev, card,
                               profile)
    fib_cfg = qa_config(task="FIB", answer_mask=True, qa_head="oe", num_labels=FIB_LABELS)
    fib_counts = qa_eval_phase("FIB (answer_mask eval)", fib_cfg, 1, SEED + 23, dev, card,
                               profile, mask_token=True)
    itm, itm_counts = itm_phase(dev, card, profile)

    # TR8: the config-driven trainer and evaluator through the port's entry points
    print(card_line(), flush=True)
    tr8_counts, tr8_first = tr8_phase(dev, card)

    # DP8: TR8's run data parallel under torchrun, one process a visible card
    print(card_line(), flush=True)
    dp8_counts = dp8_phase(card, tr8_first)

    # SRV: serving bundles of the retrieval towers (eval8's kernels; the
    # 32-frame towers' K6-K4 at B=8 timed here)
    print(card_line(), flush=True)
    srv32 = kernel_phase(cfg, dev, T32, SEED + 31, keys=("K6", "K2", "K3", "K4"), clips=SRV32_B)
    srv_counts, srv32_counts = srv_phase(dev, card)

    # one row per kernel and path: launches over the path's run, ms summed
    # over one eval forward or one train step (K1 runs on two paths)
    sources = {"K1": ("csrc/window_attention.cu", "clover_tpu/ops/window_attention.py:1274"),
               "K2": ("csrc/mlp_block.cu", "clover_tpu/ops/mlp_block.py:565"),
               "K3": ("csrc/mlp_block.cu", "clover_tpu/ops/mlp_block.py:245"),
               "K4": ("csrc/layer_norm.cu", "clover_tpu/ops/layer_norm.py:64"),
               "K5": ("csrc/window_attention_bwd.cu", "clover_tpu/ops/window_attention.py:2499"),
               "K2S": ("csrc/mlp_block.cu", "clover_tpu/ops/mlp_block.py:565"),
               "K6": ("csrc/attn_block.cu", "clover_tpu/ops/attn_block.py:489"),
               "K3M": ("csrc/mlp_block.cu", "clover_tpu/ops/mlp_block.py:418"),
               "K2T": ("csrc/mlp_block.cu", "clover_tpu/ops/mlp_block.py:565"),
               "K7": ("csrc/mlp_block_bwd_passes.cu", "clover_tpu/ops/mlp_block.py:942"),
               "K8": ("csrc/mlp_block_bwd_passes.cu", "clover_tpu/ops/mlp_block.py:1008")}
    # at N=392 the TPU runs the attention and its backward as the head-group
    # kernels, which K1 and K5 replace there
    sources32 = dict(sources, K1=(sources["K1"][0], "clover_tpu/ops/window_attention.py:989"),
                     K5=(sources["K5"][0], "clover_tpu/ops/window_attention.py:1905"))
    rows = [(k, results, counts, f"eval, ms per forward, launches over {N_BATCHES} forwards",
             sources) for k in ("K1", "K2", "K3", "K4")]
    rows += [(k, results32, counts32,
              f"eval32, ms per forward, launches over {N32_BATCHES} forwards", sources)
             for k in ("K6", "K2", "K3", "K4")]
    # K9 stands for #8 (v2, the 'pallas' default) on E8H and for #7 (v1) on
    # E8P; K11 for #11 on the flat qkv and, head-major, for #10
    heads = "csrc/window_attention_heads.cu"
    wa_py = "clover_tpu/ops/window_attention.py"
    rows += [(k, spatial[path], spatial_counts[run],
              f"{path} ({run}), ms per forward, launches over "
              f"{SPATIAL_PATHS[run][4]} forwards", {k: (src, f"{wa_py}:{line}")})
             for k, path, run, src, line in (
                 ("K9", "E8H", "E8H", heads, 181), ("K10", "E8S", "E8S", heads, 336),
                 ("K9", "E8P", "E8P-pallas", heads, 232),
                 ("K10", "E8P", "E8P-pallas_fused", heads, 336),
                 ("K11", "E32L", "E32L-v7", "csrc/window_attention_flash.cu", 1610),
                 ("K11h", "E32L", "E32L-v6", "csrc/window_attention_flash.cu", 1445))]
    rows += [(k, train, train_counts,
              f"train, ms per step, launches over {TRAIN_STEPS} steps", sources)
             for k in ("K1", "K5", "K2S")]
    rows += [(k, train32, train32_counts,
              f"train32, ms per step, launches over {TRAIN_STEPS} steps", sources32)
             for k in ("K6", "K1", "K5", "K2S")]
    rows += [(k, pre, pre_counts,
              f"pretrain, ms per step, launches over {TRAIN_STEPS} steps", sources)
             for k in ("K1", "K5", "K2S", "K3M")]
    rows += [(k, pre32, pre32_counts,
              f"pretrain32-remat, ms per step, launches over {TRAIN_STEPS} steps", sources32)
             for k in ("K6", "K1", "K5", "K2T", "K7", "K3M")]
    rows += [(k, pre_erf, pre_erf_counts,
              f"pretrain-erf-pair, ms per step, launches over {PRETRAIN_ERF_STEPS} steps", sources)
             for k in ("K8", "K1", "K5", "K2T")]
    # R8 and F12R run the eval8 and 12-frame train kernels at their shapes
    # (timed in phases 3 and 6); E8F's K6 and K4 at its own
    rows += [(k, results, r8_counts, f"R8 (RGB frames), ms per forward, launches over "
              f"{R8_BATCHES} forwards", sources) for k in ("K1", "K2", "K3", "K4")]
    rows += [(k, train, f12r_counts, f"F12R (RGB frames), ms per step, launches over "
              f"{F12R_STEPS} steps", sources) for k in ("K1", "K5", "K2S")]
    rows += [(k, e8f if k in ("K6", "K4") else results, e8f_counts,
              f"E8F (fused_block), ms per forward, launches over {E8F[4]} forwards", sources)
             for k in ("K6", "K2", "K3", "K4")]
    # slice 4: Q8O and FIB share their call shapes (64 videos, L=40)
    rows += [(k, q8o, n, f"{path}, ms per forward, launches over {runs} forwards", sources)
             for path, n, runs in (("Q8O (QA-OE eval)", q8o_counts, O_BATCHES),
                                   ("FIB (answer_mask eval)", fib_counts, 1))
             for k in ("K1", "K2", "K3", "K4")]
    rows += [(k, q8m, q8m_counts, f"Q8M (QA-MC train), ms per step, launches over "
              f"{TRAIN_STEPS} steps", sources) for k in ("K1", "K5", "K2S")]
    rows += [(k, itm, itm_counts, f"ITM (rerank score), ms per call of {ITM_PAIRS} pairs, "
              f"launches over {ITM_CALLS + 1} calls", sources) for k in ("K3", "K4")]
    # TR8 runs the pretrain step's 16-clip 8-frame Swin shapes (timed in phase
    # 8c) and eval8's forward shapes (phase 3); launches over its first run
    tr8_run = "launches over 2 epochs through the train entry (8 steps, 4 eval forwards)"
    rows += [(k, pre, tr8_counts, f"TR8 (train entry), ms per step, {tr8_run}", sources)
             for k in ("K1", "K5", "K2S")]
    rows += [(k, results, tr8_counts, f"TR8 (train entry's eval), ms per forward, {tr8_run}",
              sources) for k in ("K1", "K2", "K3", "K4")]
    dp8_run = ("rank 0's launches through the train entry with --distributed (8 steps, "
               "2 eval forwards)")
    rows += [(k, pre, dp8_counts, f"DP8 (data parallel), ms per step, {dp8_run}", sources)
             for k in ("K1", "K5", "K2S")]
    rows += [(k, results, dp8_counts, f"DP8 (data parallel eval), ms per forward, {dp8_run}",
              sources) for k in ("K1", "K2", "K3", "K4")]
    # SRV serves eval8's shapes (phase 3's times); SRV32 the 32-frame towers at B=8
    rows += [(k, results, srv_counts, f"SRV (served bundle, 8 frames), ms per forward, "
              f"launches over {SRV_BATCHES} forwards of the loaded artifacts", sources)
             for k in ("K1", "K2", "K3", "K4")]
    rows += [(k, srv32, srv32_counts, f"SRV32 (served bundle from the export entry, 32 frames, "
              f"B={SRV32_B}), ms per forward, launches over 1 forward", sources)
             for k in ("K6", "K2", "K3", "K4")]
    table = [{"name": res[k]["name"], "route": "cuda",
              "source": "clover_tpu_torch/" + src[k][0], "replaces": src[k][1],
              "launches": n[k], "max_abs_err": res[k]["err"],
              "ms": res[k]["ms"], "plain_ms": res[k]["plain_ms"],
              "bound_ms": res[k]["bound_ms"],
              "bound_by": "operations" if res[k]["ops_ms"] >= res[k]["bytes_ms"] else "bytes",
              "library_ms": res[k]["library_ms"], "path": path,
              **{extra: res[k][extra] for extra in ("layout_ms", "alone_ms") if extra in res[k]}}
             for k, res, n, path, src in rows]
    print(json.dumps({"kernels": table}))
    print(ok)
    return 0


if __name__ == "__main__":
    sys.exit(main())
