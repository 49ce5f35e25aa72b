#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``vmrframe_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out record.json]

Phases, in order; any failure exits non-zero:

1. card: fails without CUDA; prints ``nvidia-smi``'s name and power limit.
2. build: compiles the CUDA sources in ``vmrframe_tpu_torch/kernels/csrc``,
   one ``nvcc`` for each, all started together.
3. check: each kernel against its plain PyTorch version on the card, in f32
   and bf16, with random lengths and wholly masked rows and samples: the
   attention kernels at the shapes SeqPAN's Charades forward gives them
   (B=128, 4 heads of 32, L=64 video and 30 text positions, D=128); the
   whole-stack kernel (#4) at those shapes, at an odd batch (3), on a
   short ragged pair (13 video, 5 text positions), at ANet and TACoS video
   lengths (100 and 256 against 30 text positions, batch 128), on a
   ragged pair past its 64-row tiles (3, 129 video, 65 text) and with 8
   heads of 16 (3, 64 video, 30 text), and at D 256, 384 and 512 (batch
   128 with 4 heads, batch 3 with 8: head dims 64, 96, 128 and 32, 48, 64)
   and at the cluster's D 640, 768, 896 and 1024 (batch 128 with 4 heads of
   160-256, each crossing a 128-column slice edge; batch 3 with 8 heads of
   80-128; D 768 at 4 heads with a valid video facing an empty text side),
   every leaf of its weight stacks random; the
   banded kernel at the shapes ActionFormer's long config gives it (B=8, 4
   heads of 128, window 19, T = 2304, 1152, 576), a ragged T=1000 and T=300
   (padded length equal to its key window), on head-split views of one
   (B, T, 3C) projection, and at T=1000 with 4 heads of 24 and of 96 (head
   dims off the 32/64/128 grid, which #5-#7 take as they are).  #1-#3 also at the shapes SeqPAN at TACoS
   width gives them (vlen 256 against tlen 30, both ways round), and #3 at
   ANet width (vlen 100 against 30, both ways round).
4. time: each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (``library_ms``), in bf16 (#1-#3
   in f32 too), timed with CUDA events; beside each, the least time the card
   could take.  #1-#4 at TACoS width and #3 at ANet width as extra rows,
   outside the means; the
   banded forward (#5) in f32 at the training batch (2) as its f32 time.  The
   whole-stack kernel (#4) in bf16 and f32, and beside it the module path's
   time for the same stack (4 ``DualAttentionBlock`` calls through kernel #2);
   the same at D 256-1024 as extra rows, beside their bound.
4b. profile: the profiling and roofline tools at one or two reps on
   SeqPAN at Charades width, before any other phase runs the profiler:
   ``ops/chunked.py`` at B 512 in chunks of 256, f32, against the direct
   call (logits within 1e-4, spans equal);
   ``tools/roofline.py``'s probes (streaming rate at 64 KiB-1 GiB, launch
   overhead, chain rate; a probe the profiler saw nothing of in its passes
   is timed by CUDA events and named in ``timed_by_cuda_events``) and its
   measured-over-floor row at B 128;
   ``tools/trace_profile.py`` of the bf16 eval step at B 128 (2/4/2
   launches of #1/#2/#3 a step; the operations' device times summing to the
   busy time within 5%); ``tools/roofline_trace.py`` on the two (no
   operation below 0.95 of its floor); ``tools/profile_batch.py``'s rows at
   B 128, 256, 512 with chunk 0 and 256 (printed on a line before the
   ``kernels`` line); ``tools/profile_seqpan.py``'s blocks;
   ``tools/profile_model.py``'s SeqPAN pieces, whose GFLOP the zoo phase
   holds to its row's.
5. serve: SeqPAN at the full width of its Charades config, seeded random
   weights, bf16, behind the port's ``MomentRetrievalService``; a few
   hundred concurrent ``predict`` calls; the kernels' launch counts must be
   4 dual, 2 CQ and 2 masked per forward.
6. verify: one f32 batch through the kernels on the card and through the
   plain versions on the CPU; the logits must agree.
6b. verify-long: verify at TACoS width (vlen 256, the other widths as
   Charades): #3 at 256 by 30 and 30 by 256, #1/#2 over 256 keys; exactly
   2 masked, 4 dual and 2 CQ launches.
7. serve-AF: ActionFormer with ``configs/tacos_actionformer_long.yaml`` as
   it is (2304-frame grids of 1024 dims, width 512, 7 transformer blocks),
   bf16, seeded random weights, synthetic features, service batch 8; 256
   concurrent ``predict`` calls; exactly 4 banded launches per forward.
8. verify-AF: one f32 batch through the whole ActionFormer forward, kernel
   on the card against plain on the CPU, with the AffineDropPath scales
   drawn in [0.5, 1.5] (at their init of 1e-4 they would hide the attention
   branches); cls_logits and offsets must agree.
9. train-AF: ActionFormer training on ``configs/tacos_actionformer_long.yaml``
   as it is (batch 2, f32, droppath 0.1 live) through the CLI's ``main``
   (``--synthetic --epochs 1``) in a temporary working directory, then
   ``--eval`` of the best checkpoint, whose mIoU must equal the best that
   ``fit`` logged; exactly 4 launches each of the banded forward (#5), dq
   (#6) and dk/dv (#7) per train step, 4 of #5 per eval forward; finite
   losses; the EMA loss normaliser moved.  Then >= 20 timed train steps
   through ``Trainer`` (host clock per step, samples/s, peak device bytes)
   and 3 steps in bf16.
10. verify-train-AF: one f32 batch at full width, drop path off and the
   kernel route on (``model.eval()`` with grads), the AffineDropPath scales
   lifted: the loss and every parameter gradient on the card with the
   kernels against the CPU with the plain versions, each gradient beyond
   the distance of the card's band-mask route (no banded kernel) to the CPU.

11. serve-stack: phase 5 with ``model.fused_dual_stack`` set: exactly 1
   whole-stack launch (#4), 0 dual, 2 CQ and 2 masked per forward; its rate
   and latencies are printed beside the flag-off phase's.
12. verify-stack: phase 6 with the flag set (whole forward, f32, the stack
   kernel on the card against its plain version on the CPU).
12b. verify-stack-long: phase 6b with the flag set: SeqPAN at TACoS width
   (vlen 256), f32, card against CPU; exactly 1 launch of #4 and 0 of #2.
12c. verify-stack-wide: SeqPAN at D 512 (4 heads of 128; Charades lengths,
   batch 128) with the flag set: one bf16 eval forward on the card launches
   1/0/2/2 of stack/dual/CQ/masked, and one f32 forward matches the CPU's
   plain path (``TOL_MODEL_F32``), 1/0/2/2 too.
12d. verify-stack-heads: phase 12c at #4's wide and narrow heads, D 512 at
   1 head (head dim 512) and D 384 at 128 heads (head dim 3), batch 16.
12e. verify-stack-wider: phase 12c at D 768 (BERT-base's width, as
   ``configs/charades_backbone_alignfeature.yaml``; 4 heads of 192, #4 as a
   cluster of 6 CTAs a sample), batch 128; then at the cluster's wide and
   narrow heads, D 1024 at 1 head (head dim 1024), D 640 at 128 (head dim
   5) and D 896 at 64 (head dim 14), batch 16.
13. serve-router: SeqPAN and BackBone (flag set) and BaseFast at full
   Charades width, bf16, behind one ``ModelRouter`` over real HTTP: a burst
   on each route with that route's launch counts (1/0/2/2, 1/0/2/2, 0/0/2/2
   of stack/dual/CQ/masked per forward), a mixed burst routed by the body's
   ``"model"`` field, then ``POST /reload`` of SeqPAN from a checkpoint
   written in a temporary directory, after which its answers are those of
   the new weights.
14. train-SeqPAN: SeqPAN training on ``configs/charades_seqpan_fused.yaml``
   as it is (batch 128, bf16, droprate 0.2, the stack's flag on) through the
   CLI's ``main`` (``--synthetic --epochs 1``) in a temporary working
   directory, then ``--eval`` of the best checkpoint, whose mIoU must equal
   the best that ``fit`` logged: no launch of #1-#4 in a train step (the
   JAX package drops the attention probabilities, which no kernel does),
   1/0/2/2 of stack/dual/CQ/masked per eval forward.  Then >= 20 timed
   train steps through ``Trainer`` at droprate 0.2 and at droprate 0, where
   each step launches exactly 2/4/2 of #1/#2/#3 (their recomputed backward
   launches none) and 0 of #4 (host clock per step, samples/s, peak device
   bytes), and 3 steps each of BackBone and BaseFast on their configs.
15. verify-train-SeqPAN: one f32 batch at full width, droprate 0, one
   gumbel noise for both sides, the label embeddings drawn off their
   orthogonal init (where the orthogonality penalty has no gradient): the
   loss and every parameter gradient with #1-#3 on the card (2/4/2
   launches) against the plain versions on the CPU.
16. train-files: a Charades-shaped dataset in the reference's file formats
   (``testing.write_dataset_files``: 400 videos of 1024-d ``.npy`` features,
   30-250 frames each, 1024 train and 512 test captions over 1000 words, a
   300-d GloVe file) in a temporary directory; SeqPAN trained on it through
   the CLI's ``main`` with no ``--synthetic`` (``configs/charades_seqpan_fused.yaml``
   with its ``paths`` set, 1 epoch), then ``--eval`` of the best checkpoint,
   whose mIoU must equal the logged best; 1/0/2/2 launches of
   stack/dual/CQ/masked per eval forward; the ``.pkl`` cache's build and
   read-back seconds.
17. serve-files: that checkpoint behind ``build_service`` from the same
   files with a lazy store, every test record once from 64 threads: 0
   failed, 1/0/2/2 launches per forward, and the spans equal to the
   ``--eval`` pass's on at least 99% of the records (bf16 batches made up
   differently may flip an argmax; the count is printed).
18. pipeline: ``device_augment_resample`` on the card against the CPU for
   ``unchanged`` and ``samelen`` (f32, 1e-5), the gt span kept and the
   shapes static under erosion and dilation; then, at batch 128 on the same
   files with erosion 0.05 and with ``unchanged``, the host's assembly ms a
   batch and train steps fed as ``fit`` feeds them (host clock, median of
   10 after 2, the card's busy share from ``torch.profiler``) under
   ``num_workers`` 0, 4, 8 and ``device_pipeline``.
19. distill: on the same files and the SeqPAN checkpoint of phase 16,
   ``python -m vmrframe_tpu_torch.tools.export_labels`` (its ``main``) writes
   the train split's teacher curves: one a record, in order, (2, clip
   length), values in (0, 1), the first batch within 1e-3 of the sigmoid of
   the serving evaluator's bf16 eval forward; 1/0/2/2 launches per export
   forward.  ``OneTeacher_SoftLabel``
   (``configs/charades_oneteacher_softlabel.yaml`` with its ``paths`` set and
   that checkpoint as its frozen teacher) trained through the CLI's ``main``
   for 1 epoch, then ``--eval`` of the best checkpoint, whose mIoU must
   equal the logged best: every ``teach_model.`` tensor of that checkpoint
   bit-equal to the SeqPAN checkpoint's, every predictor weight moved from
   the seeded init, 1/0/4/4 launches of stack/dual/CQ/masked per eval
   forward and none in a train step (droprate 0.2).  ``MultiTeacher``
   (``configs/charades_multiteacher.yaml``, its three teachers the exported
   curves) for 1 epoch: finite losses, 0/0/2/2 per eval forward.  Then >= 20
   timed ``OneTeacher_SoftLabel`` train steps through ``Trainer`` at
   droprate 0.2 and at 0 (0/4/4/4 a step), as in phase 14.
20. verify-train-distill: phase 15's check on ``OneTeacher`` (the teacher
   trained jointly, so both towers take gradients through #1-#3's
   Functions): 4/4/4 launches of #1/#2/#3, one gumbel noise for both match
   heads, both label embeddings lifted, both towers' predictor biases held
   to the largest gradient as in phase 15 (their own maxima are printed).

21. sentence: BackBoneBertSentence (``configs/charades_backbone_bertsentence.yaml``,
   one 768-d sentence vector a sample, one text position) and
   BackBoneAlignFeature (``configs/charades_backbone_alignfeature.yaml``, D
   768: #1/#2 at head dim 192, #3 at D 768) at full width, bf16, synthetic
   data, behind one ``ModelRouter`` over HTTP as ``--model NAME=CONFIG``
   gives them: 2/4/2 launches of #1/#2/#3 per forward (their blocks are
   called directly: #4 never); 3 train steps of each at droprate 0 (2/4/2 a
   step) and at the config's 0.2 (none); one f32 forward and loss of each,
   card against the CPU.
22. backbone-af: BackBoneActionFormer (``configs/charades_backbone_actionformer.yaml``)
   served the same way (1/0/2/2 of #4/#2/#3/#1 per forward, no banded
   attention at T 64), 3 train steps at droprate 0 (0/4/2/2) and at 0.2
   (none; stochastic depth live), one f32 forward and loss, card against CPU.
23. af-rest: the long ActionFormer config with the FPN neck (4 banded
   launches), the conv backbone (none) and rel-PE (none), each one f32 batch
   of 8 through the whole forward, card against CPU; then
   ``actionformer_infer_full`` on the FPN variant's card outputs, its
   soft-NMS held per video against the C++ twin
   (``vmrframe_tpu_torch/native``, built with ``g++`` at first use).
24. serve-BAN: BAN on ``configs/tacos_ban_long.yaml`` as it is (vlen 128,
   pooling [15, 8, 8, 8], vdim 1024, dim 256, fuse 512, topk 16, neighbor 4,
   f32), seeded random weights, synthetic features, service batch 8, 256
   concurrent predictions: rate, p50/p99; no launch of any kernel (BAN runs
   cuDNN's LSTMs and plain torch).
25. verify-BAN: one f32 batch of 8 through BAN's forward, loss and
   backward, card against CPU: tmap within 1e-4, ``proposal_selection`` on
   the card equal to the CPU's on the same scores, final_pred and offset
   within 1e-4 and the loss within 1e-5 relative on those proposals, every
   gradient within 1e-3 of its largest magnitude (BANCQAttention's scalar
   bias, zero up to rounding, of the largest gradient; a unit on a ReLU's
   kink, whose sign rounding flips, left out and counted), ``ban_infer``'s spans
   equal (the card's own selection counted: at random init the scores tie).
26. train-BAN: the CLI trains BAN one epoch on that config (``--synthetic``)
   in a temporary directory, ``--eval`` of the best checkpoint gives the
   logged best mIoU and test loss; then 10 timed train steps (host clock, samples/s, peak
   bytes, the card's busy share).
27. ban-pretrain: ``BaseFast_BAN_PreTrain`` with that checkpoint as its
   frozen teacher, 3 train steps at droprate 0.1 (no launch) and 3 at 0
   (2/2 of #3/#1 a step), one eval forward (2/2); the teacher bit-equal
   after; ``export_labels`` of the BAN checkpoint on the card against the
   CPU within 1e-5.
28. repairs: the bf16 forward against the f32 forward on the card of
   BackBoneActionFormer and of SeqPAN with the stack's flag off (4 launches
   of #2 in its bf16 forward), a flag-on BackBone at D 1152, past #4's
   limit, whose forward on the card raises the wrapper's ``ValueError``,
   and one case just past each other
   kernel's limit (#5 at head dim 192, #3 at Lc 1025, #1 at
   head dim 264): the plain route, no launch, the CPU's values; then BAN's
   long config in bf16 (its LSTMs in the input's type): served (64
   requests), its forward's outputs bf16, 3 bf16 train steps with finite
   losses.
29. serve-CCA: CCA on ``configs/anet_cca.yaml`` as it is (64 clips of
   1024-d features, the synthetic concept graph of 3152 nodes, the
   3216-wide transformer, f32), service batch 64, 256 predictions from 64
   threads: rate, p50/p99; no launch of any kernel (CCA runs cuDNN's
   LSTMs and convolutions and plain torch).
30. verify-CCA: one f32 batch of 8 at that width, card against CPU: the
   eval forward's scores within 1e-4, the loss within 1e-5 relative, the
   spans equal where the best two cells lie apart; one train-mode forward
   and backward: every gradient within 1e-3 of its largest magnitude, the
   BatchNorm running statistics within 1e-4.
31. train-CCA: the CLI trains CCA one epoch (``--synthetic``), ``--eval``
   of the best checkpoint gives the logged mIoU and test loss; 10 timed
   steps (host clock, samples/s, peak bytes, busy share).
32. cca-pretrain: ``export_labels`` of that checkpoint, card against CPU
   within 1e-5, and the curves feeding ``BaseFast_CCA_PreTrain`` (3 train
   steps, no launch; an eval forward, 2/2 of #3/#1).
33. serve-CPL: CPL on ``configs/charades_cpl.yaml`` as it is (dim 128, 8
   proposals a clip, f32), service batch 128, 512 predictions from 128
   threads; no launch.
34. verify-CPL: one f32 batch of 8 (64 proposals), card against CPU: the
   logits, Gaussians, centers and widths within 1e-4, the loss within 1e-5
   relative, every gradient within 1e-3 of its largest magnitude, the spans
   equal where the two lowest proposal NLLs lie apart.
35. train-CPL: phase 31 for CPL (batch 128).
36. zoo: ``tools/bench_zoo.py`` rows for SeqPAN (Charades width, f32, the
   stack's flag off), BAN (its test config), CCA, ActionFormerLong and CPL:
   train and eval step times (5 steps between synchronizes, median of 3),
   FLOPs on the counting route, MFU against the dense peak of the step's
   type (no profiler pass: the tool's own run gives the busy share); each
   row's launches a step (SeqPAN 2/4/2 of #1/#2/#3 an eval step and none a
   train step at droprate 0.2,
   ActionFormerLong 4 of #5 an eval step and 4 each of #5/#6/#7 a train
   step, the others none); SeqPAN's and BAN's FLOP counts equal to the
   CPU's at the same shapes (1e-6 relative), and ``profile_model``'s SeqPAN
   train and eval GFLOP (phase 4b) equal to its row's.
37. sweep: ``tools/flag_sweep.py``'s ``model.fused_dual_stack`` pair, one
   fresh process each, on SeqPAN's Charades eval step: 4 launches of #2 a
   step with the flag off, 1 of #4 with it on.
38. convert: a reference-layout SeqPAN ``state_dict`` at Charades width (a
   seeded model under the original repository's names, its dead tensors
   included) through ``tools/convert_torch.py``: every tensor equal to the
   source's; one f32 batch served by the ``Evaluator`` on the card against
   the CPU within 1e-3, 1/0/2/2 launches.
39. ddp: the ``Trainer`` in a NCCL process group of one (its data-parallel
   route) against the plain trainer, 3 SeqPAN steps at Charades width (f32,
   droprate 0): losses within 1e-6 relative, 2/4/2 launches a step in both;
   the group torn down; then ``torchrun --nproc_per_node 1 -m
   vmrframe_tpu_torch`` trains the tiny SeqPAN test config one epoch.

The check phase also holds #1-#3 at the sentence variants' shapes (head
dim 192 at B 128: 64 queries over 64 and 30 keys and 30 over 64; one key;
one query over one key; #3 at D 768 both ways, and at one query or one
context row), which the time phase times as extra rows beside their bound
and SDPA.  It also holds the backward kernels (#6, #7) against their
plain versions at the training shapes (B 2, 4 heads of 128, window 19,
T = 2304, 1152, 576, 1000, 300) with a random cotangent on every row, and
the ``autograd.Function``'s grads against ``torch.autograd`` through the
plain forward; the time phase times them in f32 and bf16, with SDPA's
backward (forward + backward, less forward) as their library yardstick.

Prints one ``{"profile_batch": [...]}`` line and one ``{"kernels": [...]}``
line (#1-#3 with their TACoS-width and sentence rows in bf16 and f32 beside
the means), then as the last line
``{"ok": true, "device": {...}}``.  ``--out`` also writes the full record
(every timing with its spread) to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vmrframe_tpu_torch.tools.bench_kernels import (  # the kernel table's inputs and timing
    AF_LAUNCHES, ATTENTION, B, B_AF, B_TRAIN, BWD_KERNELS, D, H, HBM_BYTES_PER_S, LT, LV,
    LV_ANET, LV_LONG, REPLACES, SOURCE_OF, SOURCES, STACK, WINDOW, as_tuple, band_mask,
    banded_bwd_cases, banded_cases, bound_ms, card_line, cast_args, device_ms, functions,
    split_heads, stack_cases, table_cases, time_kernels, time_module_path, time_wide_stack,
    wide_stack_cases)

TOL_F32 = 1e-4  # f32 sums taken in another order, expf against torch.exp
BF16_ULPS = 2.0 ** -6  # bf16 check: 2-4 ulps of the output's largest magnitude
TOL_MODEL_F32 = 1e-3  # whole f32 forward, card against CPU: ~40 layers of reordered f32 sums
# whole f32 loss and gradients, card against CPU (relative to the loss, and
# to each gradient's largest magnitude beyond the card's band-mask route's
# own distance to the CPU): ~40 layers of reordered f32 sums, forward and back
TOL_TRAIN_F32 = 1e-3
TOL_NMS = 1e-5  # decayed scores: the card's exp and the C++ twin's expf, a few ulps a step
N_REQUESTS, CONCURRENCY, NUM_WORDS = 1024, 256, 1000
AF_CONFIG = "configs/tacos_actionformer_long.yaml"
AF_CHECK_T = tuple(AF_LAUNCHES) + (1000, 300)  # + a ragged length, and T_pad == K_WIN
AF_CHECK_HD = (24, 96)  # head dims off the 32/64/128 grid, checked at T=1000
N_AF_REQUESTS, AF_CONCURRENCY = 256, 32
N_TIMED_STEPS, N_WARMUP_STEPS, N_BF16_STEPS = 20, 2, 3
N_ROUTE_STEPS = N_TIMED_STEPS // 4  # the pipeline phase's fed steps, on each of its 8 routes
# Charades, an odd B, a ragged pair; ANet length; a ragged pair past the
# kernel's 64-row tiles (TACoS length: long_cases)
STACK_CHECK_SHAPES = ((B, LV, LT), (3, LV, LT), (2, 13, 5), (B, LV_ANET, LT), (3, 129, 65))
STACK_CHECK_HEADS = 8  # one more check case at Charades lengths: 8 heads of 16
WIDE_DIM = 512  # verify-stack-wide: SeqPAN at the widest D #4 takes, 4 heads of 128
# verify-stack-heads: SeqPAN at #4's wide and narrow heads (head dims 512 and
# 3), at a batch whose CPU forward is short
WIDE_NARROW_HEADS, WIDE_NARROW_BATCH = ((512, 1), (384, 128)), 16
# verify-stack-wider: SeqPAN at BERT-base's width (the sentence variants'
# D 768), 4 heads of 192, batch B; then the cluster's wide and narrow heads
# (head dims 1024, 5 and 14) at WIDE_NARROW_BATCH
WIDER_DIM, WIDER_HEADS = 768, ((1024, 1), (640, 128), (896, 64))
# calls queued per timed repetition of the stack's plain version and module
# path: each is hundreds of small launches, and more than the host can queue
# during the sleep kernel would time the host, not the card
N_ROUTE_REQUESTS, ROUTE_CONCURRENCY, N_MIXED_REQUESTS = 128, 64, 192


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- inputs


# ------------------------------------------------------------ phases


def phase_build() -> dict:
    from vmrframe_tpu_torch.kernels import attention as K
    from vmrframe_tpu_torch.kernels import build
    from vmrframe_tpu_torch.kernels import dual_stack as S
    from vmrframe_tpu_torch.kernels import window_attention as W

    t0 = time.perf_counter()
    build.build_all(list(SOURCES))
    K.load_kernels()
    W.load_kernels()
    S.load_kernels()
    seconds = time.perf_counter() - t0
    log(f"[build] {', '.join(SOURCES.values())} built (in parallel) and loaded in {seconds:.1f} s")
    for name in SOURCES:  # each kernel's registers, each function's spills, each source's seconds
        for line in build.ptxas_report(name):
            log(f"[build]   {name}: {line}")
    return {"seconds": seconds}


def phase_check(fns, cases) -> dict:
    results = {}
    for name, shapes in cases.items():
        wrapper, plain = fns[name]
        for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            err, tol = 0.0, 0.0
            for args in shapes:
                args = cast_args(name, args, dtype)
                got = as_tuple(wrapper(*args))
                want = as_tuple(plain(*args))
                torch.cuda.synchronize()
                for g_, w_ in zip(got, want):
                    if g_.shape != w_.shape or not torch.isfinite(g_.float()).all():
                        raise SmokeFailure(f"{name} {key}: bad output {tuple(g_.shape)}")
                    err = max(err, (g_.float() - w_.float()).abs().max().item())
                    scale = max(1.0, w_.float().abs().max().item())
                    tol = max(tol, TOL_F32 if dtype == torch.float32 else BF16_ULPS * scale)
            ok = err <= tol
            log(f"[check] {name:24s} {key:5s} max_abs_err {err:.3e}  tol {tol:.3e}  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SmokeFailure(f"{name} {key}: kernel and plain version disagree")
            results.setdefault(name, {})[key] = {"max_abs_err": err, "tol": tol}
    results["autograd_function"] = check_autograd_function(cases["banded_attention_dq"])
    return results


def check_autograd_function(cases) -> dict:
    """The ``autograd.Function`` (kernels #5-#7) against ``torch.autograd``
    through the plain forward, in f32, with the cotangent zero on rows that
    have no valid key (there the TPU backward is not the exact gradient)."""
    from vmrframe_tpu_torch.kernels import window_attention as W

    err = 0.0
    for qkv, mask, cot in cases:
        has_key = band_mask(mask)[:, 0].any(-1).float()  # (B, T)
        g = (cot * has_key[:, :, None, None]).transpose(1, 2)
        grads = []
        for fn in (W.banded_attention, W.banded_attention_plain):
            leaves = [t.detach().requires_grad_() for t in split_heads(qkv)]
            fn(*leaves, mask, WINDOW).backward(g)
            grads.append([t.grad for t in leaves])
        torch.cuda.synchronize()
        for a, b in zip(*grads):
            err = max(err, (a - b).abs().max().item())
    ok = err <= TOL_F32
    log(f"[check] autograd.Function f32 vs torch.autograd through the plain forward: "
        f"max_abs_err {err:.3e}  tol {TOL_F32:.0e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("banded_attention: the Function's grads disagree with autograd's")
    return {"max_abs_err": err, "tol": TOL_F32}


def charades_vocab(dataset, num_words: int, seed: int) -> None:
    """Pads the synthetic vocabulary to ``num_words`` entries with seeded
    GloVe-like vectors, the table size of the Charades benchmark config."""
    words, vectors = dataset["word_dict"], dataset["word_vector"]
    rng = np.random.default_rng(seed)
    extra = num_words - len(words)
    for i in range(extra):
        words[f"<filler{i}>"] = len(words)
    filler = rng.standard_normal((extra, vectors.shape[1])).astype(np.float32) * 0.1
    dataset["word_vector"] = np.concatenate([vectors, filler])
    dataset["n_words"] = len(words)


def drive(service, records, n_requests: int, concurrency: int, kernels,
          answers: list = None) -> dict:
    """``n_requests`` concurrent ``predict`` calls; the kernels' launch counts
    are set to 0 just before and read just after.  ``answers``, if given,
    receives each request's answer at its index."""
    lat, results = [], []
    lock = threading.Lock()

    def one(i):
        rec = records[i % len(records)]
        t = time.perf_counter()
        out = service.predict(rec["vid"], rec["sentence"], rec["duration"])
        dt = time.perf_counter() - t
        with lock:
            lat.append(dt)
            results.append(out["pred_frac"])
            if answers is not None:
                answers[i] = out

    batches0 = service.metrics()["batches"]
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=concurrency) as ex:
        list(ex.map(one, range(n_requests)))
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    metrics = service.metrics()
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    fracs = np.asarray(results)
    if metrics["requests_ok"] < n_requests or metrics["requests_error"]:
        raise SmokeFailure(f"serve: {metrics}")
    if fracs.shape != (n_requests, 2) or not np.isfinite(fracs).all() \
            or fracs.min() < 0 or fracs.max() > 1:
        raise SmokeFailure("serve: predicted fractions are not finite spans in [0, 1]")
    return {"requests": n_requests, "concurrency": concurrency,
            "forwards": metrics["batches"] - batches0, "wall_s": wall,
            "qps": n_requests / wall, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "failed": metrics["requests_error"], "launches": launches}


def check_launches(phase: str, stats: dict, want: dict) -> None:
    forwards, launches = stats["forwards"], stats["launches"]
    for name, per_forward in want.items():
        if forwards < 1 or launches[name] != per_forward * forwards:
            raise SmokeFailure(f"{phase}: {launches[name]} launches of {name} in {forwards} "
                               f"forwards, want {per_forward} per forward")
    log(f"[{phase}] launches per forward: " +
        ", ".join(f"{k} {v / forwards:g}" for k, v in launches.items()))


SERVE_LAUNCHES = {  # per forward, by route of the dual-attention stack
    False: {STACK: 0, "fused_dual_attention": 4, "fused_cq_attention": 2,
            "fused_masked_attention": 2},
    True: {STACK: 1, "fused_dual_attention": 0, "fused_cq_attention": 2,
           "fused_masked_attention": 2},
}


def phase_serve(kernels, card: str, fused: bool = False):
    """SeqPAN at Charades width behind the service; ``fused`` sets
    ``model.fused_dual_stack`` (phase serve-stack)."""
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.tools.serve import MomentRetrievalService, make_cfg

    phase = "serve-stack" if fused else "serve"
    cfg = make_cfg(fused_dual_stack=fused)  # SeqPAN at Charades width, batch 128, bf16
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=B, n_test=2 * B)
    charades_vocab(dataset, NUM_WORDS, seed=0)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    service = MomentRetrievalService(cfg, derived, dataset["word_dict"], dataset["char_dict"],
                                     dataset["word_vector"], store, device="cuda", seed=0)
    boot_s = time.perf_counter() - t0
    try:
        load = drive(service, dataset["test_set"], N_REQUESTS, CONCURRENCY, kernels)
    finally:
        service.close()
    stats = {
        "card": card, "model": "SeqPAN", "fused_dual_stack": fused,
        "batch_size": service.batch_size, "dtype": "bfloat16", "vlen": LV, "tlen": LT, "vdim": int(cfg.model.vdim), "dim": D, "heads": H,
        "num_words": dataset["n_words"], "boot_s": boot_s, **load,
        "peak_device_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    log(f"[{phase}] {json.dumps(stats)}")
    check_launches(phase, stats, SERVE_LAUNCHES[fused])
    return stats, dataset, store, derived, cfg


def phase_verify(cfg, derived, dataset, store, phase: str = "verify", size: int = B) -> dict:
    """One f32 batch of ``size``: kernels on the card against the plain
    versions on the CPU.  With ``model.fused_dual_stack`` set in ``cfg``
    (verify-stack) the card must have launched the whole-stack kernel once
    and kernel #2 never."""
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.kernels import attention as K
    from vmrframe_tpu_torch.kernels import dual_stack as S

    batch = Batcher(dataset["test_set"], store, cfg, derived).make_batch(list(range(size)))
    zero_counts(K.KERNELS + S.KERNELS)
    vlen = int(cfg.model.vlen)
    out = verify_forward(phase, cfg, derived, dataset["word_vector"], batch,
                         {"slogits": (size, vlen), "elogits": (size, vlen)})
    want = SERVE_LAUNCHES[bool(cfg.model.get("fused_dual_stack", False))]
    got = {fn.__name__: fn.launches for fn in K.KERNELS + S.KERNELS}
    log(f"[{phase}] launches in one forward on the card: {json.dumps(got)}")
    if got != want:
        raise SmokeFailure(f"{phase}: launches {got} in one forward on the card, want {want}")
    return {**out, "launches": got}


def phase_verify_long(fused: bool = False) -> dict:
    """verify at TACoS width: SeqPAN with vlen 256 (tlen 30, dim 128, 4
    heads and the other widths as Charades), one f32 batch, the kernels on
    the card against the plain versions on the CPU.  #3 runs 256 by 30 and
    30 by 256 (the grid that needs its scratch), #1/#2 over 256 keys; with
    ``fused`` (verify-stack-long) the whole stack runs as one launch of #4
    over 256 video and 30 text rows, and #2 never."""
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.tools.serve import make_cfg

    cfg = make_cfg(vlen=LV_LONG, fused_dual_stack=fused)
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=B, n_test=B)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    return phase_verify(cfg, derived, dataset, store,
                        "verify-stack-long" if fused else "verify-long")


def verify_flag_on(phase: str, dim: int, heads: int, size: int) -> dict:
    """SeqPAN at D ``dim`` with ``heads`` heads (Charades lengths, batch
    ``size``) with the stack's flag set: one bf16 eval forward on the card
    (the serving policy) launches #4 once, #2 never, #3 and #1 twice, with
    finite logits; then phase_verify's f32 forward against the CPU's plain
    path."""
    from vmrframe_tpu_torch.config import Derived
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.kernels import attention as K
    from vmrframe_tpu_torch.kernels import dual_stack as S
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.tools.serve import make_cfg
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    cfg = make_cfg(dim=dim, batch_size=size, fused_dual_stack=True).updated(
        {"model.num_heads": heads})
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=size, n_test=size)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    batch = Batcher(dataset["test_set"], store, cfg, derived).make_batch(list(range(size)))
    ev = Evaluator(cfg, derived, dataset["word_vector"], device="cuda", seed=0)
    kernels = K.KERNELS + S.KERNELS
    zero_counts(kernels)
    out = ev.forward(ev.to_device(batch))
    torch.cuda.synchronize()
    got = {fn.__name__: fn.launches for fn in kernels}
    log(f"[{phase}] one {cfg.train.compute_dtype} eval forward at D {dim}, {heads} heads: "
        f"launches {json.dumps(got)}")
    if got != SERVE_LAUNCHES[True]:
        raise SmokeFailure(f"{phase}: launches {got}, want {SERVE_LAUNCHES[True]}")
    if not all(torch.isfinite(out[k].float()).all() for k in ("slogits", "elogits")):
        raise SmokeFailure(f"{phase}: the bf16 logits are not finite")
    del ev
    return {**phase_verify(cfg, derived, dataset, store, phase, size), "bf16_launches": got}


def phase_verify_wide() -> dict:
    """``verify_flag_on`` at D ``WIDE_DIM`` (4 heads of 128), batch ``B``."""
    return verify_flag_on("verify-stack-wide", WIDE_DIM, H, B)


def phase_verify_heads() -> dict:
    """``verify_flag_on`` at #4's wide and narrow heads (``WIDE_NARROW_HEADS``:
    D 512 at 1 head of 512, D 384 at 128 heads of 3), batch
    ``WIDE_NARROW_BATCH``."""
    return {f"D={dim} heads={heads}": verify_flag_on("verify-stack-heads", dim, heads,
                                                     WIDE_NARROW_BATCH)
            for dim, heads in WIDE_NARROW_HEADS}


def phase_verify_wider() -> dict:
    """``verify_flag_on`` at D ``WIDER_DIM`` (4 heads of 192), batch ``B``,
    and at ``WIDER_HEADS``, batch ``WIDE_NARROW_BATCH``: #4 as a cluster of
    D / 128 CTAs a sample."""
    out = {f"D={WIDER_DIM} heads={H}": verify_flag_on("verify-stack-wider", WIDER_DIM, H, B)}
    for dim, heads in WIDER_HEADS:
        out[f"D={dim} heads={heads}"] = verify_flag_on("verify-stack-wider", dim, heads,
                                                       WIDE_NARROW_BATCH)
    return out


def empty_to_side_case(g, blocks) -> tuple:
    """One stack case (3, 40 video, 20 text positions) whose sample 1 has
    every video row valid and no valid text row."""
    case = stack_cases(g, blocks, ((3, 40, 20),))[0]
    case[2][1], case[3][1] = 1.0, 0.0
    return case


def verify_forward(phase: str, cfg, derived, word_vector, batch, shapes: dict,
                   with_loss: bool = False, kernels=(), outputs: dict = None) -> dict:
    """One f32 forward, the kernels on the card against the plain versions
    on the CPU; ``with_loss``: the eval step's loss too (relative).  The
    launch counts of ``kernels`` are set to 0 just before the card's forward
    and read into the result just after it; ``outputs``, if given, receives
    the card's outputs (on the card)."""
    from vmrframe_tpu_torch.testing import lift_drop_path
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    cfg32 = cfg.updated({"train.compute_dtype": "float32"})
    outs, losses, launches = {}, {}, {}
    for device in ("cuda", "cpu"):
        ev = Evaluator(cfg32, derived, word_vector, device=device, seed=0)
        lift_drop_path(ev.model, seed=0)
        b = ev.to_device(batch)
        zero_counts(kernels)
        out = ev.forward(b)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in kernels}
            if outputs is not None:
                outputs.update(out)
        outs[device] = {k: out[k].cpu() for k in shapes}
        if with_loss:
            losses[device] = float(ev.eval_step(b)["loss"])
    errs = {}
    for key, shape in shapes.items():
        got, want = outs["cuda"][key], outs["cpu"][key]
        if got.shape != shape or not torch.isfinite(got).all():
            raise SmokeFailure(f"{phase}: {key} is not a finite {shape} tensor")
        errs[key] = (got - want).abs().max().item()
    ok = max(errs.values()) <= TOL_MODEL_F32
    loss_err = None
    if with_loss:
        loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        ok = ok and math.isfinite(losses["cuda"]) and loss_err <= TOL_TRAIN_F32
    log(f"[{phase}] f32 forward, kernels on the card vs plain on the CPU: "
        f"{json.dumps(errs)}  tol {TOL_MODEL_F32}"
        + (f"; loss card {losses['cuda']!r} cpu {losses['cpu']!r} (rel {loss_err:.3e}, tol "
           f"{TOL_TRAIN_F32})" if with_loss else "") + f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{phase}: kernel path and plain path disagree")
    return {"max_abs_err": errs, "tol": TOL_MODEL_F32, "loss_rel_err": loss_err,
            "launches": launches}


def compare_serving(off: dict, on: dict) -> None:
    for label, st in (("flag off (4 block calls)", off), ("flag on (1 stack launch)", on)):
        log(f"[serve-stack] {label}: {st['qps']:.1f} requests/s, p50 {st['p50_ms']:.1f} ms, "
            f"p99 {st['p99_ms']:.1f} ms, {st['forwards']} forwards, on {st['card']}")


def http_post(url: str, body) -> tuple:
    """(status, JSON) of a POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode("utf8"),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_drive(phase: str, url: str, router, records, n_requests: int, concurrency: int,
               route_of, by_path: bool, kernels) -> dict:
    """``n_requests`` concurrent POSTs over real HTTP; request i goes to model
    ``route_of(i)``, named in the path or in the body.  Launch counts are set
    to 0 just before and read just after; forwards are counted per service."""
    lat, lock = [], threading.Lock()

    def one(i):
        rec, name = records[i % len(records)], route_of(i)
        body = {"vid": rec["vid"], "sentence": rec["sentence"], "duration": rec["duration"]}
        target = f"{url}/predict/{name}" if by_path else f"{url}/predict"
        t = time.perf_counter()
        code, out = http_post(target, body if by_path else {**body, "model": name})
        dt = time.perf_counter() - t
        frac = out.get("pred_frac", ())
        if code != 200 or out.get("model") != name or len(frac) != 2 \
                or not all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in frac):
            raise SmokeFailure(f"{phase}: {target} answered {code} {out}")
        with lock:
            lat.append(dt)

    before = {n: s.metrics() for n, s in router.services.items()}
    zero_counts(kernels)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=concurrency) as ex:
        list(ex.map(one, range(n_requests)))
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    after = {n: s.metrics() for n, s in router.services.items()}
    if any(after[n]["requests_error"] for n in after):
        raise SmokeFailure(f"{phase}: {after}")
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    return {"requests": n_requests, "concurrency": concurrency, "wall_s": wall,
            "qps": n_requests / wall, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "forwards": {n: after[n]["batches"] - before[n]["batches"] for n in after},
            "served": {n: after[n]["requests_ok"] - before[n]["requests_ok"] for n in after},
            "launches": launches}


ROUTES = {  # route -> (model, fused_dual_stack, launches per forward)
    "seqpan": ("SeqPAN", True, SERVE_LAUNCHES[True]),
    "backbone": ("BackBone", True, SERVE_LAUNCHES[True]),
    "basefast": ("BaseFast", False, {**SERVE_LAUNCHES[False], "fused_dual_attention": 0}),
}


def check_route_launches(phase: str, stats: dict) -> None:
    """The launch counts must be the sum over routes of forwards times that
    route's launches per forward."""
    want = {name: sum(stats["forwards"][r] * ROUTES[r][2][name] for r in ROUTES)
            for name in SERVE_LAUNCHES[True]}
    got = {name: stats["launches"][name] for name in want}
    log(f"[{phase}] forwards {json.dumps(stats['forwards'])}, launches {json.dumps(got)}, "
        f"want {json.dumps(want)}; {stats['qps']:.1f} requests/s, p50 {stats['p50_ms']:.1f} ms, "
        f"p99 {stats['p99_ms']:.1f} ms")
    if got != want or sum(stats["forwards"].values()) < 1:
        raise SmokeFailure(f"{phase}: launches {got}, want {want}")


def phase_serve_router(kernels, card: str) -> dict:
    """SeqPAN, BackBone (both with the fused stack) and BaseFast at full
    Charades width behind one ``ModelRouter`` over HTTP, then a ``/reload``."""
    from vmrframe_tpu_torch.tools.serve import (ModelRouter, build_service, make_cfg,
                                                make_http_server)

    services, dataset = {}, None
    t0 = time.perf_counter()
    for route, (model, fused, _) in ROUTES.items():
        cfg = make_cfg(model=model, fused_dual_stack=fused)
        services[route], dataset = build_service(cfg, n_synthetic=2 * B, device="cuda")
    boot_s = time.perf_counter() - t0
    router = ModelRouter(services)
    server = make_http_server(router, 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    records = dataset["test_set"]
    stats = {"card": card, "routes": {r: ROUTES[r][0] for r in ROUTES}, "boot_s": boot_s,
             "batch_size": B, "dtype": "bfloat16", "bursts": {}}
    try:
        for route in ROUTES:  # one route at a time: its launch counts alone
            burst = http_drive("serve-router", url, router, records, N_ROUTE_REQUESTS,
                               ROUTE_CONCURRENCY, lambda i, r=route: r, True, kernels)
            if burst["served"] != {r: (N_ROUTE_REQUESTS if r == route else 0) for r in ROUTES}:
                raise SmokeFailure(f"serve-router: /predict/{route} served {burst['served']}")
            check_route_launches(f"serve-router /predict/{route}", burst)
            stats["bursts"][route] = burst
        names = list(ROUTES)
        mixed = http_drive("serve-router", url, router, records, N_MIXED_REQUESTS,
                           ROUTE_CONCURRENCY, lambda i: names[i % 3], False, kernels)
        if mixed["served"] != {r: N_MIXED_REQUESTS // 3 for r in ROUTES}:
            raise SmokeFailure(f"serve-router: the mixed burst served {mixed['served']}")
        check_route_launches("serve-router mixed", mixed)
        stats["bursts"]["mixed"] = mixed
        stats["reload"] = check_reload(url, router, dataset)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        router.close()
    return stats


def check_reload(url: str, router, dataset, n_records: int = 8) -> dict:
    """``POST /reload`` of SeqPAN from a checkpoint written in a temporary
    directory (the same tree from another seed): its answers to
    ``n_records`` requests become those of the new weights, the other
    routes' stay."""
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    service = router.get("seqpan")
    records = dataset["test_set"][:n_records]
    body = lambda r: {"vid": r["vid"], "sentence": r["sentence"],  # noqa: E731
                      "duration": r["duration"]}
    ask = lambda: {route: [http_post(f"{url}/predict/{route}", body(r))[1]["pred_frac"]  # noqa: E731
                           for r in records] for route in ROUTES}
    before = ask()
    other = Evaluator(service.cfg, service.derived, dataset["word_vector"], device="cuda", seed=7)
    want = []
    for r in records:  # one request per batch, as the service will assemble them
        batch = other.to_device(service._assemble(
            [service._make_record(r["vid"], r["sentence"], r["duration"])]))
        want.append(other.eval_step(batch)["props"][0].tolist())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seqpan_seed7.pt")
        torch.save({k: v.float().cpu() for k, v in other.model.state_dict().items()}, path)
        code, out = http_post(f"{url}/reload", {"model": "seqpan", "checkpoint": path})
        if (code, out) != (200, {"ok": True, "model": "seqpan"}):
            raise SmokeFailure(f"serve-router: /reload answered {code} {out}")
        code, out = http_post(f"{url}/reload", {"model": "seqpan",
                                               "checkpoint": os.path.join(tmp, "none.pt")})
        if code != 400:
            raise SmokeFailure(f"serve-router: /reload of a missing file answered {code} {out}")
    after = ask()
    diff = lambda xs, ys: max(abs(a - b) for x, y in zip(xs, ys) for a, b in zip(x, y))  # noqa: E731
    err, moved = diff(after["seqpan"], want), diff(after["seqpan"], before["seqpan"])
    others_same = all(after[r] == before[r] for r in ROUTES if r != "seqpan")
    log(f"[serve-router] /reload of seqpan over {len(records)} requests: answers moved by up to "
        f"{moved:.4f}; against the new weights alone max abs diff {err:.2e}; the other routes "
        f"unchanged: {others_same}")
    if err > 1e-6 or moved == 0.0 or not others_same:
        raise SmokeFailure("serve-router: after /reload the answers are not the new weights'")
    return {"before": before["seqpan"], "after": after["seqpan"], "new_weights_alone": want,
            "max_abs_diff": err, "moved": moved}


def phase_serve_af(kernels, card: str):
    """ActionFormer on the long config as it is, bf16, service batch 8."""
    from vmrframe_tpu_torch.config import load_config
    from vmrframe_tpu_torch.tools.serve import build_service

    cfg = load_config(AF_CONFIG).updated({"train.compute_dtype": "bfloat16"})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    service, dataset = build_service(cfg, batch_size=B_AF, n_synthetic=64, device="cuda")
    boot_s = time.perf_counter() - t0
    try:
        load = drive(service, dataset["test_set"], N_AF_REQUESTS, AF_CONCURRENCY, kernels)
    finally:
        service.close()
    af = cfg.actionformer
    stats = {
        "card": card, "model": "ActionFormer", "config": AF_CONFIG,
        "batch_size": service.batch_size, "dtype": "bfloat16", "max_seq_len": af.max_seq_len,
        "input_dim": af.input_dim, "embd_dim": af.embd_dim, "n_head": af.n_head,
        "window": af.n_mha_win_size, "arch": list(af.backbone_arch), "boot_s": boot_s, **load,
        "peak_device_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    log(f"[serve-AF] {json.dumps(stats)}")
    check_launches("serve-AF", stats, {"banded_attention": sum(AF_LAUNCHES.values())})
    return stats, service, dataset, cfg


def phase_verify_af(service, dataset, cfg) -> dict:
    """One f32 batch through the whole ActionFormer forward."""
    from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher

    batch = ActionFormerBatcher(dataset["test_set"], service.store, cfg, service.derived,
                                batch_size=B_AF).make_batch(list(range(B_AF)))
    P = sum(cfg.actionformer.max_seq_len // 2 ** i
            for i in range(cfg.actionformer.backbone_arch[2] + 1))
    return verify_forward("verify-AF", cfg, service.derived, None, batch,
                          {"cls_logits": (B_AF, P, 1), "offsets": (B_AF, P, 2)})


def train_launches(steps: int, evals: int = 0) -> dict:
    """The launch counts a run of ``steps`` train steps and ``evals`` eval
    forwards must show: 4 of each banded kernel per step, 4 forwards per eval."""
    per_step = sum(AF_LAUNCHES.values())
    return {"banded_attention": per_step * (steps + evals),
            "banded_attention_dq": per_step * steps, "banded_attention_dkv": per_step * steps}


def read_launches(phase: str, kernels, want: dict) -> dict:
    got = {fn.__name__: fn.launches for fn in kernels if fn.__name__ in want}
    log(f"[{phase}] launches {json.dumps(got)}, want {json.dumps(want)}")
    if got != want:
        raise SmokeFailure(f"{phase}: launches {got}, want {want}")
    return got


def zero_counts(kernels) -> None:
    for fn in kernels:
        fn.launches = 0


def phase_train_af(W, card: str) -> dict:
    """The CLI's train-then-eval on the long config, then timed steps."""
    from vmrframe_tpu_torch.cli import main as cli_main

    config = os.path.abspath(AF_CONFIG)
    stats = {"card": card, "config": AF_CONFIG, "batch_size": B_TRAIN, "dtype": "float32"}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # ckpt/ and the log land here
        try:
            zero_counts(W.KERNELS)
            t0 = time.perf_counter()
            fit = cli_main(["--config", config, "--synthetic", "--epochs", "1", "--device", "cuda"])
            stats["fit_s"] = time.perf_counter() - t0
            steps, evals = fit["steps"], fit["eval_batches"]
            stats["launches"] = read_launches("train-AF", W.KERNELS,
                                              train_launches(steps, evals))
            stats.update(steps=steps, eval_forwards=evals, best_miou=fit["best_miou"],
                         train_loss=fit["history"][0]["train_loss"],
                         loss_normalizer=float(fit["extras"]["loss_normalizer"]))
            if not math.isfinite(stats["train_loss"]):
                raise SmokeFailure(f"train-AF: the epoch's mean loss is {stats['train_loss']}")
            if stats["loss_normalizer"] == 100.0:
                raise SmokeFailure("train-AF: the EMA loss normaliser did not move")
            zero_counts(W.KERNELS)
            ev = cli_main(["--config", config, "--synthetic", "--eval", "--checkpoint",
                           fit["best_path"], "--device", "cuda"])
            stats["eval_launches"] = read_launches(
                "train-AF eval", W.KERNELS, train_launches(0, ev["eval_batches"]))
            stats["eval_miou"] = ev["miou"]
            log(f"[train-AF] best mIoU logged by fit {fit['best_miou']!r}, "
                f"--eval of its checkpoint {ev['miou']!r}")
            if ev["miou"] != fit["best_miou"]:
                raise SmokeFailure("train-AF: --eval of the best checkpoint gives another mIoU")
        finally:
            os.chdir(cwd)
    stats["timed"] = timed_train_steps(W, "float32", N_WARMUP_STEPS + N_TIMED_STEPS, card)
    stats["bf16"] = timed_train_steps(W, "bfloat16", N_BF16_STEPS, card)
    log(f"[train-AF] {json.dumps(stats)}")
    return stats


def af_train_world(compute_dtype: str):
    """The long config as it is (at ``compute_dtype``), its synthetic
    dataset, derived record and train batcher."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher
    from vmrframe_tpu_torch.testing import make_synthetic_data

    cfg = load_config(AF_CONFIG).updated({"train.compute_dtype": compute_dtype})
    dataset, store = make_synthetic_data(cfg, seed=0)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    batcher = ActionFormerBatcher(dataset["train_set"], store, cfg, derived, "train")
    derived.num_train_steps = derived.steps_per_epoch = len(batcher)
    return cfg, derived, batcher


def timed_train_steps(W, compute_dtype: str, n: int, card: str) -> dict:
    """``n`` train steps through ``Trainer`` on batches already on the card;
    each step's host clock ends in a synchronise.  The first
    ``N_WARMUP_STEPS`` of a long run are not in the median."""
    from vmrframe_tpu_torch.train.trainer import Trainer

    cfg, derived, batcher = af_train_world(compute_dtype)
    trainer = Trainer(cfg, derived, None, device="cuda")
    batches = []
    for batch in batcher.epoch(seed=0):
        batches.append(trainer.to_device(batch))
        if len(batches) == n:
            break
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(W.KERNELS)
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(batch)["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(f"train-AF {compute_dtype}", W.KERNELS, train_launches(n))
    if not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"train-AF {compute_dtype}: losses {losses}")
    timed = times[N_WARMUP_STEPS:] if n > N_WARMUP_STEPS + 1 else times
    median = statistics.median(timed)
    out = {"card": card, "dtype": compute_dtype, "steps": n, "losses": losses,
           "step_ms_median": median, "step_ms_min": min(timed), "step_ms_max": max(timed),
           "samples_per_s": B_TRAIN / (median / 1e3), "launches": launches,
           "peak_device_mem_bytes": torch.cuda.max_memory_allocated()}
    log(f"[train-AF] {compute_dtype}: {n} steps, median {median:.3f} ms/step (host clock), "
        f"{out['samples_per_s']:.2f} samples/s, peak {out['peak_device_mem_bytes']} bytes, "
        f"on {card}")
    return out


def phase_verify_train_af(W) -> dict:
    """One f32 batch at full width, drop path off with the kernel route on:
    the loss and every parameter gradient, kernels on the card against the
    plain versions on the CPU, with the AffineDropPath scales lifted.

    The card's f32 backward outside the kernels (cuDNN's convolution
    gradients, the first conv's ill-conditioned weight sum) differs from the
    CPU by up to ~3e-3 of a gradient's max on a few stem gradients, on the
    band-mask route (no banded kernel) exactly as on the kernel route
    (against an f64 reference; PERF.md).  So the card's band-mask route sets
    the floor: each gradient of the kernel route must be within 1e-3 of its
    max of the CPU's, beyond the band-mask route's own distance to it."""
    from vmrframe_tpu_torch.layers.actionformer import SHIFT_INVARIANT
    from vmrframe_tpu_torch.testing import lift_drop_path
    from vmrframe_tpu_torch.train.trainer import Trainer

    cfg, derived, batcher = af_train_world("float32")
    batch = batcher.make_batch(list(range(B_TRAIN)))
    outs = {}
    for label, device, min_len in (("kernels", "cuda", None), ("band", "cuda", -1),
                                   ("plain", "cpu", None)):
        zero_counts(W.KERNELS)
        run_cfg = cfg if min_len is None else cfg.updated({"actionformer.pallas_min_len": min_len})
        trainer = Trainer(run_cfg, derived, None, device=device)
        lift_drop_path(trainer.model, seed=0)
        trainer.model.eval()  # no drop path; the eval gate takes the same route
        loss, grads, _, _ = trainer.loss_and_grads(trainer.to_device(batch))
        outs[label] = (float(loss.detach()), {k: v.detach().cpu() for k, v in grads.items()})
        read_launches(f"verify-train-AF {label}", W.KERNELS,
                      train_launches(1 if label == "kernels" else 0))
    (loss_k, g_k), (_, g_b), (loss_p, g_p) = outs["kernels"], outs["band"], outs["plain"]
    ref = f64_reference(cfg, derived, batch)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    largest = max(v.abs().max().item() for v in g_p.values())
    worst, worst_name, shift, floor = float("-inf"), None, 0.0, {}
    for name, want in g_p.items():
        got = g_k[name]
        if not torch.isfinite(got).all():
            raise SmokeFailure(f"verify-train-AF: {name}'s gradient is not finite")
        if name.endswith(SHIFT_INVARIANT):  # zero up to rounding: held to the largest gradient
            shift = max(shift, got.abs().max().item() / largest, want.abs().max().item() / largest)
            continue
        scale = max(want.abs().max().item(), 1e-30)
        floor[name] = (g_b[name] - want).abs().max().item() / scale
        rel = (got - want).abs().max().item() / scale - floor[name]
        if rel > worst:
            worst, worst_name = rel, name
    top_floor = sorted(floor.items(), key=lambda kv: -kv[1])[:3]
    # each f32 run's distance to the f64 reference on the gradients the card
    # is furthest from the CPU on: the card's two routes alike, the CPU closer
    f64_err = {label: {name: (g[name].double() - ref[name]).abs().max().item()
                       / max(ref[name].abs().max().item(), 1e-300) for name, _ in top_floor}
               for label, g in (("card_kernels", g_k), ("card_band", g_b), ("cpu_plain", g_p))}
    log(f"[verify-train-AF] distance to an f64 CPU reference (band-mask route), of each "
        f"gradient's max: {json.dumps(f64_err)}")
    ok = max(loss_err, worst, shift) <= TOL_TRAIN_F32
    log(f"[verify-train-AF] loss card {loss_k!r} cpu {loss_p!r} (rel {loss_err:.3e}); worst "
        f"gradient {worst_name} at {worst:.3e} of its max beyond the card's band-mask route "
        f"(whose largest distances to the CPU are {json.dumps(top_floor)}); the key biases' "
        f"(zero up to rounding) at {shift:.3e} of the largest; {len(g_p)} gradients; "
        f"tol {TOL_TRAIN_F32}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("verify-train-AF: kernel path and plain path disagree")
    return {"loss_rel_err": loss_err, "worst_grad_rel_err_beyond_band": worst,
            "worst_grad": worst_name, "band_route_rel_err_top": top_floor,
            "f64_rel_err": f64_err,
            "shift_invariant_grad_rel": shift, "n_grads": len(g_p), "tol": TOL_TRAIN_F32}


def f64_reference(cfg, derived, batch) -> dict:
    """Every parameter gradient of the same loss in f64 on the CPU, through
    the band-mask route (the plain versions compute in f32)."""
    from vmrframe_tpu_torch.testing import lift_drop_path
    from vmrframe_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg.updated({"actionformer.pallas_min_len": -1}), derived, None,
                      device="cpu")
    lift_drop_path(trainer.model, seed=0)
    model = trainer.model.double().eval()
    wide = lambda v: v.double() if v.is_floating_point() else v  # noqa: E731
    b = {k: wide(v) for k, v in trainer.to_device(batch).items()}
    extras = {k: wide(v) for k, v in trainer.extras.items()}
    loss, _ = trainer.entry.loss_fn(model(b), b, trainer.cfg, extras)
    named = dict(model.named_parameters())
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


# ------------------------------------------------- SeqPAN-family training


SEQPAN_CONFIG = "configs/charades_seqpan_fused.yaml"
FAMILY_CONFIGS = {"BackBone": "configs/charades_backbone_fused.yaml",
                  "BaseFast": "configs/charades_basefast.yaml"}
# kernel launches of one SeqPAN forward (and its train step, whose backward
# launches none) on the train route at droprate 0, with the stack's flag set
SEQPAN_TRAIN_LAUNCHES = {STACK: 0, "fused_dual_attention": 4, "fused_cq_attention": 2,
                         "fused_masked_attention": 2}
N_SEQPAN_BATCHES, N_FAMILY_STEPS = 4, 3


def want_launches(per_forward: dict, n: int) -> dict:
    return {name: per * n for name, per in per_forward.items()}


def family_world(config: str, updates: dict, n_batches: int):
    """A SeqPAN-family config (with ``updates``), its synthetic dataset of
    ``n_batches`` train batches, derived record and train batcher (the
    model's registered one)."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.testing import make_synthetic_data

    cfg = load_config(config).updated(updates)
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=n_batches * B, n_test=B)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    batcher_cls = get_model_entry(str(cfg.model.name)).batcher_cls or Batcher
    batcher = batcher_cls(dataset["train_set"], store, cfg, derived, "train")
    derived.num_train_steps = derived.steps_per_epoch = len(batcher)
    return cfg, derived, dataset, batcher


def family_steps(K, S, config: str, updates: dict, n: int, card: str, want: dict,
                 label: str, phase: str = "train-SeqPAN", kernels=None) -> dict:
    """``n`` train steps through ``Trainer`` on ``N_SEQPAN_BATCHES`` batches
    already on the card, in turn; the host clock of each ends in a
    synchronise; the launch counts of ``kernels`` (default #1-#4) must be
    ``want`` per step.  The first ``N_WARMUP_STEPS`` of a long run are not in
    the median."""
    from vmrframe_tpu_torch.train.trainer import Trainer

    cfg, derived, dataset, batcher = family_world(config, updates, N_SEQPAN_BATCHES)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # by the earlier phases, not by this training
    trainer = Trainer(cfg, derived, dataset["word_vector"], device="cuda")
    batches = [trainer.to_device(b) for b in batcher.epoch(seed=0)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = kernels or K.KERNELS + S.KERNELS
    zero_counts(kernels)
    times, losses = [], []
    for i in range(n):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(batches[i % len(batches)])["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(f"{phase} {label}", kernels, want_launches(want, n))
    if not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"{phase} {label}: losses {losses}")
    timed = times[N_WARMUP_STEPS:] if n > N_WARMUP_STEPS + 1 else times
    median = statistics.median(timed)
    out = {"card": card, "model": str(cfg.model.name), "config": config,
           "dtype": str(cfg.train.compute_dtype), "droprate": float(cfg.model.droprate),
           "batch_size": B, "steps": n, "losses": losses, "step_ms_median": median,
           "step_ms_min": min(timed), "step_ms_max": max(timed),
           "samples_per_s": B / (median / 1e3), "launches": launches,
           "launches_per_step": {k: v / n for k, v in launches.items()},
           "peak_device_mem_bytes": torch.cuda.max_memory_allocated(),
           "held_before_bytes": held}
    out["peak_training_bytes"] = out["peak_device_mem_bytes"] - held
    log(f"[{phase}] {label}: {n} steps, median {median:.3f} ms/step (host clock, "
        f"{min(timed):.3f}-{max(timed):.3f}), {out['samples_per_s']:.1f} samples/s, peak "
        f"{out['peak_training_bytes']} bytes beyond the {held} the earlier phases hold, "
        f"on {card}")
    return out


def phase_train_seqpan(K, S, card: str) -> dict:
    """The CLI's train-then-eval on the SeqPAN config as it is (batch 128,
    bf16, droprate 0.2, the stack's flag on), then timed train steps at
    droprate 0.2 and 0, then a few steps of BackBone and BaseFast."""
    from vmrframe_tpu_torch.cli import main as cli_main

    config = os.path.abspath(SEQPAN_CONFIG)
    stats = {"card": card, "config": SEQPAN_CONFIG}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # ckpt/ and the log land here
        try:
            zero_counts(K.KERNELS + S.KERNELS)
            fit = cli_main(["--config", config, "--synthetic", "--epochs", "1", "--device", "cuda"])
            steps, evals = fit["steps"], fit["eval_batches"]
            # the train steps (droprate 0.2) launch none; each eval forward 1/0/2/2
            read_launches("train-SeqPAN fit", K.KERNELS + S.KERNELS,
                          want_launches(SERVE_LAUNCHES[True], evals))
            stats.update(steps=steps, eval_forwards=evals, best_miou=fit["best_miou"],
                         train_loss=fit["history"][0]["train_loss"])
            if not math.isfinite(stats["train_loss"]):
                raise SmokeFailure(f"train-SeqPAN: the epoch's mean loss is {stats['train_loss']}")
            zero_counts(K.KERNELS + S.KERNELS)
            ev = cli_main(["--config", config, "--synthetic", "--eval", "--checkpoint",
                           fit["best_path"], "--device", "cuda"])
            read_launches("train-SeqPAN eval", K.KERNELS + S.KERNELS,
                          want_launches(SERVE_LAUNCHES[True], ev["eval_batches"]))
            stats["eval_miou"] = ev["miou"]
            log(f"[train-SeqPAN] best mIoU logged by fit {fit['best_miou']!r}, "
                f"--eval of its checkpoint {ev['miou']!r}")
            if ev["miou"] != fit["best_miou"]:
                raise SmokeFailure("train-SeqPAN: --eval of the best checkpoint gives another mIoU")
        finally:
            os.chdir(cwd)
    n = N_WARMUP_STEPS + N_TIMED_STEPS
    none = want_launches(SEQPAN_TRAIN_LAUNCHES, 0)
    stats["droprate_0.2"] = family_steps(K, S, SEQPAN_CONFIG, {}, n, card, none, "droprate 0.2")
    stats["droprate_0"] = family_steps(K, S, SEQPAN_CONFIG, {"model.droprate": 0.0}, n, card,
                                       SEQPAN_TRAIN_LAUNCHES, "droprate 0")
    for name, config in FAMILY_CONFIGS.items():
        stats[name] = family_steps(K, S, config, {}, N_FAMILY_STEPS, card, none, name)
    log(f"[train-SeqPAN] {json.dumps(stats)}")
    return stats


def verify_train(K, S, phase: str, config: str, updates: dict, want: dict,
                 shift_invariant: tuple) -> dict:
    """One f32 batch at full width, droprate 0, one gumbel noise for every
    match head (drawn on the CPU): the loss and every parameter gradient of
    the model's train mode, kernels #1-#3 on the card (``want`` launches;
    their recomputed backward) against the plain versions on the CPU.  The
    label embeddings are drawn off their orthogonal init
    (``testing.lift_label_embs``), where the orthogonality penalty has no
    gradient.  The gradients named by ``shift_invariant`` are zero up to
    rounding: they are held to the largest gradient."""
    from vmrframe_tpu_torch.models import seqpan
    from vmrframe_tpu_torch.testing import lift_label_embs
    from vmrframe_tpu_torch.train.trainer import Trainer

    cfg, derived, dataset, batcher = family_world(
        config, {"train.compute_dtype": "float32", "model.droprate": 0.0, **updates}, 1)
    batch = batcher.make_batch(list(range(B)))
    noise = torch.empty(B, int(cfg.model.vlen), 4).exponential_(
        generator=torch.Generator().manual_seed(0)).log().neg()  # Gumbel(0, 1)
    draw = seqpan.gumbel_noise
    seqpan.gumbel_noise = lambda logits, generator: noise.to(logits.device, logits.dtype)
    outs = {}
    try:
        for device in ("cuda", "cpu"):
            zero_counts(K.KERNELS + S.KERNELS)
            trainer = Trainer(cfg, derived, dataset["word_vector"], device=device)
            lift_label_embs(trainer.model, seed=0)
            trainer.model.train()
            loss, grads, _, _ = trainer.loss_and_grads(
                trainer.to_device(batch), torch.Generator(device=device).manual_seed(0))
            outs[device] = (float(loss.detach()),
                            {k: None if v is None else v.detach().cpu() for k, v in grads.items()})
            read_launches(f"{phase} {device}", K.KERNELS + S.KERNELS,
                          want if device == "cuda" else want_launches(want, 0))
    finally:
        seqpan.gumbel_noise = draw
    (loss_k, g_k), (loss_p, g_p) = outs["cuda"], outs["cpu"]
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    largest = max(v.abs().max().item() for v in g_p.values() if v is not None)
    worst, worst_name, shift = float("-inf"), None, 0.0
    shift_own, shift_own_name = 0.0, None  # recorded, not held to the tolerance
    for name, want_g in g_p.items():
        got = g_k[name]
        if got is None or not torch.isfinite(got).all():
            raise SmokeFailure(f"{phase}: {name}'s gradient on the card is {got}")
        zero_on_card_only = want_g is not None and want_g.abs().max() > 0 \
            and got.abs().max() == 0
        want_g = torch.zeros_like(got) if want_g is None else want_g
        rel = (got - want_g).abs().max().item() / max(want_g.abs().max().item(), 1e-30)
        if name.endswith(shift_invariant):  # zero up to rounding: held to the largest
            # (zero is their exact value, so either side may round to it)
            shift = max(shift, got.abs().max().item() / largest,
                        want_g.abs().max().item() / largest)
            if rel > shift_own:
                shift_own, shift_own_name = rel, name
            continue
        if zero_on_card_only:
            raise SmokeFailure(f"{phase}: {name}'s gradient is zero on the card only")
        if rel > worst:
            worst, worst_name = rel, name
    ok = max(loss_err, worst, shift) <= TOL_TRAIN_F32
    log(f"[{phase}] loss card {loss_k!r} cpu {loss_p!r} (rel {loss_err:.3e}); worst "
        f"gradient {worst_name} at {worst:.3e} of its max; the shift-invariant biases' (zero "
        f"up to rounding) at {shift:.3e} of the largest (their worst, {shift_own_name}, at "
        f"{shift_own:.3e} of its own max); {len(g_p)} gradients; tol {TOL_TRAIN_F32}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{phase}: kernel path and plain path disagree")
    return {"loss_rel_err": loss_err, "worst_grad_rel_err": worst, "worst_grad": worst_name,
            "shift_invariant_grad_rel": shift, "shift_invariant_own_rel": shift_own,
            "shift_invariant_own_worst": shift_own_name, "n_grads": len(g_p),
            "tol": TOL_TRAIN_F32, "launches": want}


def phase_verify_train_seqpan(K, S) -> dict:
    """SeqPAN's train mode, card against CPU (``verify_train``)."""
    from vmrframe_tpu_torch.models import seqpan

    return verify_train(K, S, "verify-train-SeqPAN", SEQPAN_CONFIG, {}, SEQPAN_TRAIN_LAUNCHES,
                        seqpan.SHIFT_INVARIANT)


# ----------------------------------------------------- the file-backed path


# a Charades-shaped dataset in the reference's file formats
# (testing.write_dataset_files): 1024-d features of 30-250 frames per video
N_FILE_VIDEOS, N_FILE_TRAIN, N_FILE_TEST, N_FILE_WORDS = 400, 1024, 512, 1000
FILE_FRAMES = (30, 250)
N_FILE_REQUESTS, FILE_CONCURRENCY = 512, 64
SPAN_AGREEMENT = 0.99  # bf16 batches made up differently may flip an argmax
WORKER_ROUTES = (0, 4, 8)
PIPELINE_AUGMENTATIONS = {"erosion": {"erosion": 0.05},  # the reference's config/anet/SeqPAN.yaml
                          "unchanged": {"unchanged": None}}
N_ASSEMBLED, N_PROFILED_STEPS = 4, 4
TOL_PIPELINE = 1e-5


def phase_train_files(K, S, card: str, root: str):
    """Writes the dataset files, trains SeqPAN on them through the CLI's
    ``main`` as a user runs it (no ``--synthetic``; the config is
    ``configs/charades_seqpan_fused.yaml`` with its ``paths`` set, 1 epoch),
    then ``--eval`` of the best checkpoint with ``--save-results``."""
    from vmrframe_tpu_torch.cli import main as cli_main
    from vmrframe_tpu_torch.config import load_config
    from vmrframe_tpu_torch.testing import write_dataset_files

    cfg = load_config(SEQPAN_CONFIG).updated({"train.epochs": 1,
                                              "paths.ckpt_dir": os.path.join(root, "ckpt")})
    t0 = time.perf_counter()
    config = write_dataset_files(os.path.join(root, "data"), cfg, n_videos=N_FILE_VIDEOS,
                                 n_train=N_FILE_TRAIN, n_test=N_FILE_TEST, seed=0,
                                 n_words=N_FILE_WORDS, min_len=FILE_FRAMES[0],
                                 max_len=FILE_FRAMES[1])
    stats = {"card": card, "config": SEQPAN_CONFIG + " with paths set", "files_write_s":
             time.perf_counter() - t0, "videos": N_FILE_VIDEOS, "frames": FILE_FRAMES}
    zero_counts(K.KERNELS + S.KERNELS)
    t0 = time.perf_counter()
    fit = cli_main(["--config", config, "--device", "cuda"])
    stats["fit_s"] = time.perf_counter() - t0
    steps, evals = fit["steps"], fit["eval_batches"]
    # droprate 0.2: the train steps launch none; each eval forward 1/0/2/2
    stats["fit_launches"] = read_launches("train-files fit", K.KERNELS + S.KERNELS,
                                          want_launches(SERVE_LAUNCHES[True], evals))
    if fit["cache"] != "built" or steps != N_FILE_TRAIN // B or evals != N_FILE_TEST // B:
        raise SmokeFailure(f"train-files: cache {fit['cache']}, {steps} steps, {evals} evals")
    if not math.isfinite(fit["history"][0]["train_loss"]):
        raise SmokeFailure(f"train-files: the epoch's mean loss is {fit['history']}")
    predictions = os.path.join(root, "eval_predictions.json")
    zero_counts(K.KERNELS + S.KERNELS)
    ev = cli_main(["--config", config, "--eval", "--checkpoint", fit["best_path"], "--device",
                   "cuda", "--save-results", predictions])
    stats["eval_launches"] = read_launches(
        "train-files eval", K.KERNELS + S.KERNELS,
        want_launches(SERVE_LAUNCHES[True], ev["eval_batches"]))
    stats.update(steps=steps, eval_forwards=evals, best_miou=fit["best_miou"],
                 eval_miou=ev["miou"], train_loss=fit["history"][0]["train_loss"],
                 cache_build_s=fit["data_s"], cache_load_s=ev["data_s"],
                 features_read_s=fit["features_s"], eval_cache=ev["cache"],
                 launches_per_eval_forward={k: v / ev["eval_batches"]
                                            for k, v in stats["eval_launches"].items()})
    log(f"[train-files] best mIoU logged by fit {fit['best_miou']!r}, --eval of its "
        f"checkpoint {ev['miou']!r}; the dataset cache built in {fit['data_s']:.3f} s, read "
        f"back in {ev['data_s']:.3f} s; features read in {fit['features_s']:.3f} s")
    if ev["cache"] != "loaded" or ev["miou"] != fit["best_miou"]:
        raise SmokeFailure("train-files: --eval of the best checkpoint gives another mIoU, "
                           "or did not read the cache")
    log(f"[train-files] {json.dumps(stats)}")
    return stats, config, fit["best_path"], predictions


def phase_serve_files(kernels, card: str, config: str, checkpoint: str, predictions: str):
    """Serves the trained checkpoint through ``build_service`` from the same
    files with a lazy store: every test record once, from many threads; each
    answer's span against the ``--eval`` pass's for the same record."""
    from vmrframe_tpu_torch.config import load_config
    from vmrframe_tpu_torch.tools.serve import build_service

    t0 = time.perf_counter()
    service, dataset = build_service(load_config(config), checkpoint=checkpoint, device="cuda",
                                     synthetic=False)
    boot_s = time.perf_counter() - t0
    records = dataset["test_set"]
    answers = [None] * N_FILE_REQUESTS
    try:
        if not service.store.lazy:
            raise SmokeFailure("serve-files: the service's store is not lazy")
        load = drive(service, records, N_FILE_REQUESTS, FILE_CONCURRENCY, kernels, answers)
    finally:
        service.close()
    with open(predictions, encoding="utf8") as f:
        want = json.load(f)
    if len(want) != len(records) or N_FILE_REQUESTS != len(records):
        raise SmokeFailure(f"serve-files: {len(want)} eval predictions, {len(records)} records")
    differ = [i for i, (got, w) in enumerate(zip(answers, want))
              if got["pred_time"] != w["pred_time"]]
    worst = max((abs(a - b) for i in differ
                 for a, b in zip(answers[i]["pred_time"], want[i]["pred_time"])), default=0.0)
    stats = {"card": card, "store": "lazy .npy", "batch_size": service.batch_size,
             "dtype": str(service.cfg.train.compute_dtype), "boot_s": boot_s, **load,
             "spans_equal_share": 1 - len(differ) / len(records), "spans_differ": len(differ),
             "spans_differ_worst_s": worst}
    log(f"[serve-files] {json.dumps(stats)}")
    check_launches("serve-files", stats, SERVE_LAUNCHES[True])
    log(f"[serve-files] {load['qps']:.1f} requests/s, p50 {load['p50_ms']:.1f} ms, p99 "
        f"{load['p99_ms']:.1f} ms, {load['failed']} failed; spans equal to the --eval pass's "
        f"on {len(records) - len(differ)} of {len(records)} records ({len(differ)} differ, by "
        f"at most {worst:.3f} s), on {card}")
    if load["failed"] or stats["spans_equal_share"] < SPAN_AGREEMENT:
        raise SmokeFailure("serve-files: failed requests, or spans unlike the eval pass's")
    return stats


def check_pipeline_on_the_card(cfg, batcher) -> dict:
    """``device_augment_resample`` on the card against the CPU where it draws
    nothing (``unchanged`` under ``truncation``, and ``samelen``), f32 with
    TF32 off; under erosion and dilation the gt span survives in every sample
    and the shapes are the static ones."""
    from vmrframe_tpu_torch.ops.input_pipeline import device_augment_resample

    raw = batcher.make_batch(list(range(B)))
    if "raw_vfeats" not in raw:
        raise SmokeFailure("pipeline: the device pipeline's batcher made a host batch")
    vlen, vdim = int(cfg.model.vlen), int(cfg.model.vdim)
    args = [torch.as_tensor(raw[k]) for k in ("raw_vfeats", "raw_lens", "se_fracs")]
    out = {}
    for name, kw in (("unchanged", {"sample_type": "truncation"}),
                     ("samelen", {"sample_type": "samelen"})):
        card = device_augment_resample(*[a.cuda() for a in args], 5, vlen=vlen, **kw)
        cpu = device_augment_resample(*args, 5, vlen=vlen, **kw)
        err = {k: (card[k].cpu().float() - cpu[k].float()).abs().max().item() for k in cpu}
        out[name] = err
        exact = err["vmasks"] == 0 and err["NER_labels"] == 0
        log(f"[pipeline] {name}: card against CPU, max abs err {json.dumps(err)}, tol "
            f"{TOL_PIPELINE}  {'ok' if exact and max(err.values()) <= TOL_PIPELINE else 'FAIL'}")
        if not exact or max(err.values()) > TOL_PIPELINE:
            raise SmokeFailure(f"pipeline: {name} on the card differs from the CPU")
    for mode in ("erosion", "dilation"):
        got = device_augment_resample(*[a.cuda() for a in args], 7, vlen=vlen, aug_mode=mode,
                                      erosion_p=0.05)
        peaks = got["label1ds"].amax(-1)
        shapes = {k: tuple(v.shape) for k, v in got.items()}
        ok = (shapes == {"vfeats": (B, vlen, vdim), "vmasks": (B, vlen),
                         "label1ds": (B, 2, vlen), "NER_labels": (B, vlen)}
              and bool((peaks == 1).all()) and bool(torch.isfinite(got["vfeats"]).all()))
        log(f"[pipeline] {mode} on the card: shapes {shapes}, every sample's start and end "
            f"heatmaps peak at 1: {bool((peaks == 1).all())}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"pipeline: {mode} lost a gt span or changed a shape")
        out[mode] = {"shapes": shapes, "gt_kept": True}
    return out


def route_steps(K, S, cfg, derived, dataset, store, card: str, label: str) -> dict:
    """One route of batch assembly (``tools/bench_pipeline.py::time_route``):
    the host's assembly ms of the first batches of an epoch; then train steps
    fed as ``fit`` feeds them (the batcher on a prefetch thread), host clock
    per step from taking the batch to the loss on the host, and the card's
    busy share of a step."""
    from vmrframe_tpu_torch.tools.bench_pipeline import time_route

    zero_counts(K.KERNELS + S.KERNELS)
    out = time_route(  # droprate 0.2: no kernel in a train step, on either route
        cfg, derived, dataset, store, "cuda", N_WARMUP_STEPS, N_ROUTE_STEPS, N_ASSEMBLED,
        N_PROFILED_STEPS, after_timed=lambda: read_launches(
            f"pipeline {label}", K.KERNELS + S.KERNELS, want_launches(SEQPAN_TRAIN_LAUNCHES, 0)))
    losses = out.pop("losses")
    if not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"pipeline {label}: losses {losses}")
    out = {"route": label, **out}
    median, busy = out["step_ms_median"], out["device_busy_ms_per_step"]
    log(f"[pipeline] {label}: assembly {out['assembly_ms_median']:.1f} ms a batch (first "
        f"{N_ASSEMBLED} of an epoch), fed train step {median:.3f} ms ({out['step_ms_min']:.3f}-"
        f"{out['step_ms_max']:.3f}, host clock, {out['steps']} steps), card busy "
        f"{busy if busy is None else round(busy, 3)} ms a step "
        f"({'not measured' if not busy else f'{busy / median:.1%}'}), on {card}")
    return out


def phase_pipeline(K, S, card: str, config: str) -> dict:
    """Batch 128 on the same files: the pipeline on the card against the
    CPU, then the host's assembly and fed train steps under each route
    (``num_workers`` 0, 4, 8 and ``device_pipeline``), with erosion 0.05 and
    with ``unchanged``."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.data.datasets import load_dataset
    from vmrframe_tpu_torch.data.features import open_feature_store

    base = load_config(config)
    store = open_feature_store(base.paths.feature_path, base.model.vlen)
    dataset = load_dataset(base, Derived())
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    derived.num_train_steps = derived.steps_per_epoch = len(dataset["train_set"]) // B
    pipe = base.updated({"dataprocess.device_pipeline": True})
    stats = {"card": card, "batch_size": B, "dtype": str(base.train.compute_dtype),
             "check": check_pipeline_on_the_card(
                 pipe, Batcher(dataset["train_set"], store, pipe, derived, "train"))}
    for name, aug in PIPELINE_AUGMENTATIONS.items():
        routes = [(f"workers {w}", {"train.num_workers": w}) for w in WORKER_ROUTES]
        routes.append(("device pipeline", {"dataprocess.device_pipeline": True}))
        for label, updates in routes:
            cfg = base.updated({"dataprocess.video_augmentation": aug, **updates})
            stats[f"{name}, {label}"] = route_steps(K, S, cfg, derived, dataset, store, card,
                                                   f"{name}, {label}")
    log(f"[pipeline] {json.dumps(stats)}")
    return stats


# ------------------------------------------------------------ distillation


DISTILL_CONFIG = "configs/charades_oneteacher_softlabel.yaml"
MULTI_CONFIG = "configs/charades_multiteacher.yaml"
# kernel launches of one OneTeacher_SoftLabel forward (student and teacher):
# in eval with the teacher's stack flag on, and in a train step at droprate 0
DISTILL_EVAL_LAUNCHES = {STACK: 1, "fused_dual_attention": 0, "fused_cq_attention": 4,
                         "fused_masked_attention": 4}
DISTILL_TRAIN_LAUNCHES = {STACK: 0, "fused_dual_attention": 4, "fused_cq_attention": 4,
                          "fused_masked_attention": 4}
# the student alone (MultiTeacher, BaseFast_CCA_PreTrain), eval forward
STUDENT_LAUNCHES = {STACK: 0, "fused_dual_attention": 0, "fused_cq_attention": 2,
                    "fused_masked_attention": 2}
TOL_EXPORT = 1e-3  # bf16: the export's forward against the serving evaluator's


def files_variant(root: str, files_config: str, config: str, name: str, updates: dict) -> str:
    """``config`` with the paths (files, cache) of the file-backed phases'
    config and ``updates``, written as ``<root>/<name>.json``."""
    from vmrframe_tpu_torch.config import load_config

    paths = load_config(files_config).paths.to_dict()
    cfg = load_config(config).updated({"paths": {**paths, "ckpt_dir": os.path.join(root, name)},
                                       "train.epochs": 1, **updates})
    path = os.path.join(root, f"{name}.json")
    with open(path, "w", encoding="utf8") as f:
        json.dump(cfg.to_dict(), f)
    return path


def check_export(K, S, files_config: str, checkpoint: str, curves: list) -> dict:
    """The exported curves against the train split (one a record, in order,
    (2, clip length), values in (0, 1)) and, on the first batch, against the
    sigmoid of the serving evaluator's eval forward of the checkpoint."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.data.datasets import load_dataset
    from vmrframe_tpu_torch.data.features import open_feature_store
    from vmrframe_tpu_torch.train.evaluator import Evaluator
    from vmrframe_tpu_torch.weights import load_checkpoint

    cfg = load_config(files_config)
    store = open_feature_store(cfg.paths.feature_path, cfg.model.vlen)
    dataset = load_dataset(cfg, Derived())
    records = dataset["train_set"]
    if [v for v, _ in curves] != [r["vid"] for r in records]:
        raise SmokeFailure(f"distill export: {len(curves)} curves, not one per train record "
                           f"({len(records)}) in order")
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    batches = list(Batcher(records, store, cfg, derived, "test").epoch(seed=0, shuffle=False))
    lens = np.concatenate([b["vmasks"].sum(1)[: int(b["num_valid"])] for b in batches]).astype(int)
    shapes_ok = all(c.shape == (2, n) for (_, c), n in zip(curves, lens))
    inside = all(((c > 0) & (c < 1)).all() for _, c in curves)
    ev = Evaluator(cfg, derived, dataset["word_vector"], device="cuda")
    load_checkpoint(ev.model, checkpoint)
    zero_counts(K.KERNELS + S.KERNELS)  # not the export's launches
    out = ev.forward(ev.to_device(batches[0]))
    direct = torch.stack([torch.sigmoid(out["slogits"]), torch.sigmoid(out["elogits"])], 1).cpu()
    err = max(float((torch.from_numpy(c) - direct[i, :, : c.shape[1]]).abs().max())
              for i, (_, c) in enumerate(curves[: int(batches[0]["num_valid"])]))
    ok = shapes_ok and inside and err <= TOL_EXPORT
    log(f"[distill] export: {len(curves)} curves for {len(records)} train records, in order; "
        f"shapes (2, clip length): {shapes_ok}; values in (0, 1): {inside}; the first batch "
        f"against the evaluator's eval forward, max abs err {err:.3e}, tol {TOL_EXPORT}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("distill: the exported curves are wrong")
    return {"curves": len(curves), "max_abs_err_first_batch": err, "tol": TOL_EXPORT,
            "clip_lengths": [int(lens.min()), int(lens.max())]}


def check_student_trained(config: str, checkpoint: str, teacher_checkpoint: str,
                          seed: int = 1234) -> dict:
    """Every ``teach_model.`` tensor of the student's checkpoint bit-equal to
    the teacher checkpoint's; every predictor weight moved from the CLI's
    seeded init (``--seed`` 1234)."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.datasets import load_dataset
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.weights import init_weights, read_checkpoint

    got, teacher = read_checkpoint(checkpoint), read_checkpoint(teacher_checkpoint)
    differ = [k for k, v in teacher.items() if not torch.equal(got[f"teach_model.{k}"], v)]
    cfg = load_config(config)
    dataset = load_dataset(cfg, Derived())
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    init = init_weights(get_model_entry(cfg.model.name).model_cls(
        cfg, derived, dataset["word_vector"]), seed).state_dict()
    weights = [k for k in init if k.startswith("predictor.") and k.endswith(".weight")]
    still = [k for k in weights if torch.equal(init[k], got[k])]
    log(f"[distill] teacher tensors bit-equal to the SeqPAN checkpoint: "
        f"{len(teacher) - len(differ)} of {len(teacher)}; predictor weights moved from the "
        f"seeded init: {len(weights) - len(still)} of {len(weights)}")
    if differ or still or not weights:
        raise SmokeFailure(f"distill: teacher tensors changed {differ[:3]}, predictor weights "
                           f"that did not move {still[:3]}")
    return {"teacher_tensors_equal": len(teacher), "predictor_weights_moved": len(weights)}


def phase_distill(K, S, card: str, root: str, files_config: str, teacher: str) -> dict:
    """On the file-backed phases' dataset and SeqPAN checkpoint: the teacher's
    curves exported through ``tools/export_labels.py``'s ``main``;
    ``OneTeacher_SoftLabel`` trained through the CLI's ``main`` with that
    checkpoint as its frozen teacher, then ``--eval`` of its best checkpoint;
    ``MultiTeacher`` trained on the exported curves; then timed
    ``OneTeacher_SoftLabel`` train steps at droprate 0.2 and 0."""
    from vmrframe_tpu_torch.cli import main as cli_main
    from vmrframe_tpu_torch.tools import export_labels

    stats = {"card": card}
    kernels = K.KERNELS + S.KERNELS
    curves_path = os.path.join(root, "teacher_curves.pkl")
    zero_counts(kernels)
    t0 = time.perf_counter()
    curves = export_labels.main(["--config", files_config, "--checkpoint", teacher, "--out",
                                 curves_path, "--device", "cuda"])
    stats["export_s"] = time.perf_counter() - t0
    n_export = -(-len(curves) // B)
    stats["export_launches"] = read_launches("distill export", kernels,
                                             want_launches(SERVE_LAUNCHES[True], n_export))
    stats["export"] = check_export(K, S, files_config, teacher, curves)

    config = files_variant(root, files_config, DISTILL_CONFIG, "oneteacher_softlabel",
                           {"teacher0.model.checkpoint": teacher})
    zero_counts(kernels)
    t0 = time.perf_counter()
    fit = cli_main(["--config", config, "--device", "cuda"])
    stats["fit_s"] = time.perf_counter() - t0
    # droprate 0.2 in both towers: the train steps launch none
    stats["fit_launches"] = read_launches("distill fit", kernels, want_launches(
        DISTILL_EVAL_LAUNCHES, fit["eval_batches"]))
    zero_counts(kernels)
    ev = cli_main(["--config", config, "--eval", "--checkpoint", fit["best_path"], "--device",
                   "cuda"])
    stats["eval_launches"] = read_launches("distill eval", kernels, want_launches(
        DISTILL_EVAL_LAUNCHES, ev["eval_batches"]))
    stats.update(steps=fit["steps"], eval_forwards=ev["eval_batches"],
                 best_miou=fit["best_miou"], eval_miou=ev["miou"],
                 train_loss=fit["history"][0]["train_loss"],
                 launches_per_eval_forward={k: v / ev["eval_batches"]
                                            for k, v in stats["eval_launches"].items()})
    log(f"[distill] OneTeacher_SoftLabel: best mIoU logged by fit {fit['best_miou']!r}, --eval "
        f"of its checkpoint {ev['miou']!r}; train loss {stats['train_loss']!r}")
    if ev["miou"] != fit["best_miou"] or not math.isfinite(stats["train_loss"]):
        raise SmokeFailure("distill: --eval of the best checkpoint gives another mIoU, or the "
                           "loss is not finite")
    stats["trained"] = check_student_trained(config, fit["best_path"], teacher)

    config = files_variant(root, files_config, MULTI_CONFIG, "multiteacher",
                           {f"loss.t{i}_path": curves_path for i in range(3)})
    zero_counts(kernels)
    multi = cli_main(["--config", config, "--device", "cuda"])
    stats["multi"] = {"steps": multi["steps"], "eval_forwards": multi["eval_batches"],
                      "train_loss": multi["history"][0]["train_loss"],
                      "best_miou": multi["best_miou"],
                      "launches": read_launches("distill MultiTeacher", kernels, want_launches(
                          STUDENT_LAUNCHES, multi["eval_batches"]))}
    log(f"[distill] MultiTeacher on the exported curves: {json.dumps(stats['multi'])}")
    if not math.isfinite(stats["multi"]["train_loss"]):
        raise SmokeFailure(f"distill: MultiTeacher's loss is {stats['multi']['train_loss']}")

    n = N_WARMUP_STEPS + N_TIMED_STEPS
    none = want_launches(DISTILL_TRAIN_LAUNCHES, 0)
    stats["droprate_0.2"] = family_steps(K, S, DISTILL_CONFIG, {}, n, card, none,
                                         "droprate 0.2", "distill")
    stats["droprate_0"] = family_steps(
        K, S, DISTILL_CONFIG, {"model.droprate": 0.0, "teacher0.model.droprate": 0.0}, n, card,
        DISTILL_TRAIN_LAUNCHES, "droprate 0", "distill")
    log(f"[distill] {json.dumps(stats)}")
    return stats


def phase_verify_train_distill(K, S) -> dict:
    """``OneTeacher``'s train mode (both towers take gradients through the
    #1-#3 Functions), card against CPU (``verify_train``), under SeqPAN's
    rule.  Both towers' predictor biases (``seqpan.SHIFT_INVARIANT``) get
    the hard losses' gradient, zero up to rounding, plus softloc's, which its
    L2 normalisation keeps from being shift-invariant but leaves ~1e-5 of
    the largest gradient: their own maxima are the cancellation's rounding."""
    from vmrframe_tpu_torch.models import seqpan

    return verify_train(K, S, "verify-train-distill", DISTILL_CONFIG,
                        {"model.name": "OneTeacher"}, DISTILL_TRAIN_LAUNCHES,
                        seqpan.SHIFT_INVARIANT)


# ------------------------------------- the sentence variants, BackBoneActionFormer


# the routes of the sentence phase, as ``--model NAME=CONFIG`` gives them
SENTENCE_SPECS = ("bertsentence=configs/charades_backbone_bertsentence.yaml",
                  "alignfeature=configs/charades_backbone_alignfeature.yaml")
# kernel launches of one sentence-variant forward (eval, or a train step at
# droprate 0): they call their blocks directly, so #4 never runs
SENTENCE_LAUNCHES = {STACK: 0, "fused_dual_attention": 4, "fused_cq_attention": 2,
                     "fused_masked_attention": 2}
N_SENTENCE_REQUESTS, SENTENCE_CONCURRENCY = 256, 64


def serve_routes(phase: str, specs, kernels, want: dict, card: str) -> dict:
    """The ``--model NAME=CONFIG`` routes behind one ``ModelRouter`` over
    real HTTP (bf16, synthetic data, batch 128): a burst on each route
    alone, its launch counts ``want`` per forward."""
    from vmrframe_tpu_torch.config import load_config
    from vmrframe_tpu_torch.tools.serve import (ModelRouter, build_service, make_http_server,
                                                model_spec)

    services, dataset = {}, None
    t0 = time.perf_counter()
    for spec in specs:
        name, config, checkpoint = model_spec(spec)
        services[name], dataset = build_service(load_config(config), checkpoint,
                                                n_synthetic=2 * B, device="cuda")
    stats = {"card": card, "routes": list(specs), "boot_s": time.perf_counter() - t0,
             "batch_size": B, "dtype": "bfloat16", "bursts": {}}
    router = ModelRouter(services)
    server = make_http_server(router, 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for route in services:
            burst = http_drive(phase, url, router, dataset["test_set"], N_SENTENCE_REQUESTS,
                               SENTENCE_CONCURRENCY, lambda i, r=route: r, True, kernels)
            forwards = burst["forwards"][route]
            expect = want_launches(want, forwards)
            got = {name: burst["launches"][name] for name in expect}
            log(f"[{phase}] /predict/{route}: {forwards} forwards, launches {json.dumps(got)}, "
                f"want {json.dumps(expect)}; {burst['qps']:.1f} requests/s, p50 "
                f"{burst['p50_ms']:.1f} ms, p99 {burst['p99_ms']:.1f} ms, on {card}")
            if forwards < 1 or got != expect or burst["served"][route] != N_SENTENCE_REQUESTS:
                raise SmokeFailure(f"{phase}: /predict/{route} launches {got}, want {expect}")
            stats["bursts"][route] = {**burst, "launches_per_forward": {
                k: v / forwards for k, v in got.items()}}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        router.close()
    return stats


def verify_family(phase: str, config: str, kernels, want: dict) -> dict:
    """One f32 batch of the model's test batcher at full width: forward and
    eval loss on the card against the CPU's plain path; ``want`` launches of
    ``kernels`` in the card's forward."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.testing import make_synthetic_data

    cfg = load_config(config)
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=B, n_test=B)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    batcher_cls = get_model_entry(str(cfg.model.name)).batcher_cls or Batcher
    batch = batcher_cls(dataset["test_set"], store, cfg, derived).make_batch(list(range(B)))
    vlen = int(cfg.model.vlen)
    out = verify_forward(phase, cfg, derived, dataset["word_vector"], batch,
                         {"slogits": (B, vlen), "elogits": (B, vlen)}, with_loss=True,
                         kernels=kernels)
    got = {k: out["launches"][k] for k in want}
    log(f"[{phase}] launches in one f32 forward on the card: {json.dumps(got)}")
    if got != want:
        raise SmokeFailure(f"{phase}: launches {got} in one forward on the card, want {want}")
    return out


def phase_sentence(K, S, card: str) -> dict:
    """BackBoneBertSentence and BackBoneAlignFeature (D 768: head dim 192,
    #3 at D 768) at full width on synthetic data: served behind one router
    (2/4/2 launches of #1/#2/#3 per forward), 3 train steps of each at
    droprate 0 (2/4/2 a step) and at the config's 0.2 (none), and one f32
    forward and loss, card against CPU."""
    from vmrframe_tpu_torch.tools.serve import model_spec

    kernels = K.KERNELS + S.KERNELS
    stats = {"serve": serve_routes("sentence", SENTENCE_SPECS, kernels, SENTENCE_LAUNCHES, card)}
    none = want_launches(SENTENCE_LAUNCHES, 0)
    for spec in SENTENCE_SPECS:
        name, config, _ = model_spec(spec)
        stats[name] = {
            "droprate_0": family_steps(K, S, config, {"model.droprate": 0.0}, N_FAMILY_STEPS,
                                       card, SENTENCE_LAUNCHES, f"{name} droprate 0",
                                       "sentence"),
            "droprate_0.2": family_steps(K, S, config, {}, N_FAMILY_STEPS, card, none,
                                         f"{name} droprate 0.2", "sentence"),
            "verify": verify_family(f"sentence {name}", config, kernels, SENTENCE_LAUNCHES)}
    log(f"[sentence] {json.dumps(stats)}")
    return stats


BBAF_CONFIG = "configs/charades_backbone_actionformer.yaml"
# one BackBoneActionFormer eval forward with the stack's flag on: #4 once,
# #3 and #1 twice, no banded attention (T 64 < pallas_min_len 512); a train
# step at droprate 0 runs the module path (4 of #2)
BBAF_EVAL_LAUNCHES = {STACK: 1, "fused_dual_attention": 0, "fused_cq_attention": 2,
                      "fused_masked_attention": 2, "banded_attention": 0}
BBAF_TRAIN_LAUNCHES = {**SEQPAN_TRAIN_LAUNCHES, "banded_attention": 0}


def phase_backbone_af(K, S, W, card: str) -> dict:
    """BackBoneActionFormer from its config: served (bf16, batch 128), 3
    train steps at droprate 0 and at 0.2 (stochastic depth live), one f32
    forward and loss, card against CPU."""
    kernels = K.KERNELS + S.KERNELS + W.KERNELS
    name = "backbone_af"
    stats = {"serve": serve_routes("backbone-af", (f"{name}={BBAF_CONFIG}",), kernels,
                                   BBAF_EVAL_LAUNCHES, card)}
    none = want_launches(BBAF_TRAIN_LAUNCHES, 0)
    stats["droprate_0"] = family_steps(K, S, BBAF_CONFIG, {"model.droprate": 0.0},
                                       N_FAMILY_STEPS, card, BBAF_TRAIN_LAUNCHES, "droprate 0",
                                       "backbone-af", kernels)
    stats["droprate_0.2"] = family_steps(K, S, BBAF_CONFIG, {}, N_FAMILY_STEPS, card, none,
                                         "droprate 0.2", "backbone-af", kernels)
    stats["verify"] = verify_family("backbone-af verify", BBAF_CONFIG, kernels,
                                    BBAF_EVAL_LAUNCHES)
    log(f"[backbone-af] {json.dumps(stats)}")
    return stats


# the long config with each of the rest of ActionFormer: the FPN neck (4
# banded launches a forward, as the identity neck), the conv backbone (no
# attention) and rel-PE (no banded kernel: it does not add the term)
AF_VARIANTS = {"fpn": ({"actionformer.fpn_type": "fpn"}, 4),
               "conv": ({"actionformer.backbone_type": "conv"}, 0),
               "rel_pe": ({"actionformer.use_rel_pe": True}, 0)}


def phase_af_rest(W) -> dict:
    """Each variant of the long config: one f32 batch of 8 through the whole
    forward, the card against the CPU, with its banded launches; then
    ``actionformer_infer_full`` on the FPN variant's card outputs, its
    soft-NMS held per video against the C++ twin."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher
    from vmrframe_tpu_torch.testing import make_synthetic_data

    stats = {}
    for name, (updates, banded) in AF_VARIANTS.items():
        cfg = load_config(AF_CONFIG).updated(updates)
        dataset, store = make_synthetic_data(cfg, seed=0, n_train=B_AF, n_test=B_AF)
        derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
        batch = ActionFormerBatcher(dataset["test_set"], store, cfg, derived,
                                    batch_size=B_AF).make_batch(list(range(B_AF)))
        P = sum(cfg.actionformer.max_seq_len // 2 ** i
                for i in range(cfg.actionformer.backbone_arch[2] + 1))
        outputs = {}
        out = verify_forward(f"af-rest {name}", cfg, derived, None, batch,
                             {"cls_logits": (B_AF, P, 1), "offsets": (B_AF, P, 2)},
                             kernels=W.KERNELS, outputs=outputs)
        want = {"banded_attention": banded, "banded_attention_dq": 0, "banded_attention_dkv": 0}
        log(f"[af-rest] {name}: launches in one f32 forward on the card "
            f"{json.dumps(out['launches'])}, want {json.dumps(want)}")
        if out["launches"] != want:
            raise SmokeFailure(f"af-rest {name}: launches {out['launches']}, want {want}")
        stats[name] = out
        if name == "fpn":
            stats["nms"] = check_nms_twin(cfg, batch, outputs)
    return stats


def check_nms_twin(cfg, batch, outputs) -> dict:
    """``actionformer_infer_full`` on the card's outputs; its soft-NMS
    (before voting) against the C++ twin on each video's candidates: the
    same picks, in order, above ``min_score``."""
    from vmrframe_tpu_torch import native
    from vmrframe_tpu_torch.models import actionformer as A
    from vmrframe_tpu_torch.ops.nms import batched_nms_1d

    test = cfg.actionformer.test_cfg
    method = {"soft": 2, "linear": 1}.get(test.nms_method, 0)
    K = int(test.max_seg_num)
    card_batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    A.actionformer_infer_full(outputs, card_batch, cfg)  # warm: the first call loads kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = A.actionformer_infer_full(outputs, card_batch, cfg)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    segs, scores, _ = A._decode_candidates(outputs, cfg)
    kept_segs, kept_scores, valid = batched_nms_1d(segs, scores, test.iou_threshold, K,
                                                   test.min_score, method, test.nms_sigma)
    if not (torch.equal(full["scores"], kept_scores) and torch.equal(full["valid"], valid)):
        raise SmokeFailure("af-rest: actionformer_infer_full's NMS is not batched_nms_1d's")
    segs, scores = segs.cpu().numpy(), scores.cpu().numpy()
    kept_segs, kept_scores, valid = kept_segs.cpu(), kept_scores.cpu(), valid.cpu()
    t0 = time.perf_counter()
    twin = [native.nms_1d_cpu(segs[b], scores[b], test.iou_threshold, test.min_score, method,
                              test.nms_sigma, K) for b in range(segs.shape[0])]
    twin_s = time.perf_counter() - t0
    seg_err, score_err, kept = 0.0, 0.0, []
    for b, (c_segs, c_scores, _) in enumerate(twin):
        n = int(valid[b].sum())
        if len(c_scores) != n or not bool(valid[b, :n].all()):
            raise SmokeFailure(f"af-rest: video {b}: the twin keeps {len(c_scores)}, the card "
                               f"{n} (valid {valid[b].tolist()})")
        seg_err = max(seg_err, float(np.abs(c_segs - kept_segs[b, :n].numpy()).max(initial=0)))
        score_err = max(score_err, float((np.abs(c_scores - kept_scores[b, :n].numpy())
                                          / np.abs(c_scores)).max(initial=0)))
        kept.append(n)
    ok = seg_err == 0.0 and score_err <= TOL_NMS
    log(f"[af-rest] actionformer_infer_full on the card ({full_s * 1e3:.1f} ms host clock, "
        f"second call, {K} steps of "
        f"{test.nms_method} NMS over {segs.shape[1]} candidates x {segs.shape[0]} videos) "
        f"against the C++ twin per video ({twin_s * 1e3:.1f} ms): kept {kept}; segments max "
        f"abs diff {seg_err:.3e}; scores max rel diff {score_err:.3e}, tol {TOL_NMS}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("af-rest: the card's NMS and the C++ twin disagree")
    return {"kept": kept, "segments_max_abs_diff": seg_err, "scores_max_rel_diff": score_err,
            "tol": TOL_NMS, "infer_full_ms": full_s * 1e3, "twin_ms": twin_s * 1e3,
            "segments_shape": list(full["segments"].shape)}


BAN_CONFIG = "configs/tacos_ban_long.yaml"
B_BAN = 8  # the config's batch
N_BAN_REQUESTS, BAN_CONCURRENCY = 256, 32
N_BAN_TIMED, N_PRETRAIN_STEPS = 10, 3
# the whole f32 BAN forward, card (cuDNN's LSTMs) against the CPU: tmap,
# final_pred and offset; the loss relative; the export's curves
TOL_BAN, TOL_BAN_LOSS, TOL_BAN_EXPORT = 1e-4, 1e-5, 1e-5


def config_world(config: str = BAN_CONFIG, updates: dict = None, n_train: int = 64):
    """A config as it is (or updated), its synthetic dataset and derived record."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.testing import make_synthetic_data

    cfg = load_config(config).updated(updates or {})
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=n_train, n_test=32)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    return cfg, dataset, store, derived


def serve_config(phase: str, config: str, batch_size: int, n_requests: int, concurrency: int,
                 kernels, card: str, updates: dict = None) -> dict:
    """A config as it is (or updated), seeded random weights, synthetic
    features, behind the service at ``batch_size``: ``n_requests``
    concurrent predictions from ``concurrency`` threads; rate, p50/p99 and
    peak device bytes.  The families served this way (BAN, CCA, CPL) run no
    hand-written kernel: every count stays 0."""
    from vmrframe_tpu_torch.config import load_config
    from vmrframe_tpu_torch.tools.serve import build_service

    cfg = load_config(config).updated(updates or {})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    service, dataset = build_service(cfg, batch_size=batch_size, n_synthetic=64, device="cuda")
    boot_s = time.perf_counter() - t0
    try:
        load = drive(service, dataset["test_set"], n_requests, concurrency, kernels)
    finally:
        service.close()
    stats = {"card": card, "model": str(cfg.model.name), "config": config,
             "batch_size": service.batch_size,
             "dtype": str(cfg.train.get("compute_dtype", "float32")),
             "widths": cfg.model.to_dict(), "boot_s": boot_s, **load,
             "peak_device_mem_bytes": torch.cuda.max_memory_allocated()}
    log(f"[{phase}] {json.dumps(stats)}")
    check_launches(phase, stats, {fn.__name__: 0 for fn in kernels})
    return stats


def phase_serve_ban(kernels, card: str) -> dict:
    """BAN on its long config as it is (vlen 128, pooling [15, 8, 8, 8], vdim
    1024, dim 256, fuse 512, topk 16, neighbor 4, f32) at the config's batch
    of 8 (``serve_config``)."""
    return serve_config("serve-BAN", BAN_CONFIG, B_BAN, N_BAN_REQUESTS, BAN_CONCURRENCY,
                        kernels, card)


def _ban_pass(model, cfg, batch, selection=None):
    """One deterministic forward with the loss and every parameter
    gradient: train mode (cuDNN's LSTM has a backward only there) with
    every dropout at rate 0; ``selection`` forces the proposals.  Returns
    (outputs, the selection it made, loss, grads) on the CPU."""
    from vmrframe_tpu_torch.layers.dropout import Dropout
    from vmrframe_tpu_torch.models import ban
    from vmrframe_tpu_torch.registry import get_model_entry

    model.train()
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0

    real, made = ban.proposal_selection, []

    def select(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1] if selection is None else selection.to(made[-1].device)

    ban.proposal_selection = select
    try:
        out = model(batch)
    finally:
        ban.proposal_selection = real
    loss = get_model_entry("BAN").loss_fn(out, batch, cfg)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    cpu = lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t  # noqa: E731
    return ({k: cpu(v) for k, v in out.items()}, made[0].cpu(), float(loss.detach()),
            {k: None if g is None else g.cpu() for k, g in zip(named, grads)})


def _record_pre_activations(model, into: dict) -> list:
    """Hooks that keep each ``MLPBlock``'s input times its weight plus its
    bias (its ReLU's argument) in ``into`` by module name, on the CPU."""
    from vmrframe_tpu_torch.models.ban import MLPBlock

    def keep(name):
        def hook(mod, inputs, _):
            into[name] = (inputs[0] @ mod.weight.t() + mod.bias).detach().cpu()
        return hook

    return [mod.register_forward_hook(keep(name)) for name, mod in model.named_modules()
            if isinstance(mod, MLPBlock)]


def phase_verify_ban() -> dict:
    """One f32 batch of 8 through the whole BAN forward, loss and backward
    (dropout off), card (cuDNN's LSTMs, no TF32) against the CPU, same
    seeded weights.
    tmap (before the selection) within ``TOL_BAN``; ``proposal_selection``
    on the card on the CPU's scores gives the CPU's indices exactly.  At
    random init the ~3600 cell scores spread over ~0.003 with exact f32
    ties, so the card's own scores may select differently where f32 and f64
    on the CPU also do: the card's own selection is counted, must be the
    CPU's selection on the card's scores, and where it differs, the two
    stable orders of the scores must first part at two cells whose CPU
    scores lie within twice the largest distance of the scores; the rest
    of the forward (final_pred, offset within ``TOL_BAN``), the loss
    (``TOL_BAN_LOSS`` relative) and every gradient (``TOL_TRAIN_F32`` of its
    largest magnitude; ``models/ban.py::SHIFT_INVARIANT``'s, zero up to
    rounding, of the largest gradient; the rows of an ``MLPBlock`` unit
    whose pre-activation is on the ReLU's kink, its sign differing by
    rounding, left out and counted) run on the CPU's proposals.  ``ban_infer``'s spans
    from the card's own forward equal the CPU's."""
    from vmrframe_tpu_torch.data.ban_batcher import BANBatcher
    from vmrframe_tpu_torch.models import ban
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.weights import init_weights

    cfg, dataset, store, derived = config_world()
    batch = BANBatcher(dataset["test_set"], store, cfg, derived).make_batch(list(range(B_BAN)))
    batch = {k: torch.as_tensor(v) for k, v in batch.items() if k != "num_valid"}
    entry = get_model_entry("BAN")
    cpu_model = init_weights(entry.model_cls(cfg, derived, dataset["word_vector"]), 0)
    card_model = init_weights(entry.model_cls(cfg, derived, dataset["word_vector"]), 0).cuda()
    card_batch = {k: v.cuda() for k, v in batch.items()}
    t0 = time.perf_counter()
    pre = {"cpu": {}, "cuda": {}}  # each MLPBlock's pre-activations (before its ReLU)
    hooks = _record_pre_activations(cpu_model, pre["cpu"])
    out_p, sel_p, loss_p, g_p = _ban_pass(cpu_model, cfg, batch)
    cpu_s = time.perf_counter() - t0
    own, sel_own, _, _ = _ban_pass(card_model, cfg, card_batch)
    hooks += _record_pre_activations(card_model, pre["cuda"])
    out_k, _, loss_k, g_k = _ban_pass(card_model, cfg, card_batch, selection=sel_p)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    # a unit whose pre-activation sits on the ReLU's kink (its sign differs
    # between the card and the CPU by rounding) has its weight row's and
    # bias entry's gradient switched on one side only: those rows are left
    # out of the comparison, counted, and their pre-activations held to TOL_BAN
    kinks, kink_pre = {}, 0.0
    for name, a in pre["cpu"].items():
        b = pre["cuda"][name]
        flip = (a > 0) != (b > 0)
        kink_pre = max(kink_pre, a[flip].abs().max().item() if flip.any() else 0.0)
        kinks[name] = torch.nonzero(flip.reshape(-1, a.shape[-1]).any(dim=0)).flatten()
    errs = {key: (out_k[key] - out_p[key]).abs().max().item()
            for key in ("tmap", "final_pred", "offset", "td", "sen_proj")}
    scores = torch.sigmoid(out_p["tmap_cells"])
    on_card = ban.proposal_selection(scores.cuda(), card_model.moments, card_model.topk,
                                     card_model.neighbor, card_model.negative, 0.7).cpu()
    spans_k = entry.infer_fn(own, {k: v.cpu() for k, v in card_batch.items()}, cfg)
    spans_p = entry.infer_fn(out_p, batch, cfg)
    # where the card's own selection differs, it must be the CPU's selection
    # on the card's scores, and the two stable orders must first part at a
    # pair of cells whose CPU scores lie within twice the scores' distance
    own_scores = torch.sigmoid(own["tmap_cells"].cuda()).cpu()
    score_err = (own_scores - scores).abs().max().item()
    own_on_cpu = ban.proposal_selection(own_scores, cpu_model.moments, cpu_model.topk,
                                        cpu_model.neighbor, cpu_model.negative, 0.7)
    order_p = torch.argsort(-scores, dim=1, stable=True)
    order_k = torch.argsort(-own_scores, dim=1, stable=True)
    differ = (sel_own != sel_p).any(dim=1)
    own_differ, tie_gap = int(differ.sum()), 0.0
    ties_ok = torch.equal(own_on_cpu, sel_own)
    for b in torch.nonzero(differ).flatten().tolist():
        parted = torch.nonzero(order_p[b] != order_k[b]).flatten()
        if not len(parted):
            ties_ok = False
            continue
        t = int(parted[0])
        tie_gap = max(tie_gap, (scores[b, order_p[b, t]] - scores[b, order_k[b, t]]).item())
    ties_ok = ties_ok and tie_gap <= 2 * score_err
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    largest = max(v.abs().max().item() for v in g_p.values() if v is not None)
    worst, worst_name, shift = 0.0, None, 0.0
    for name, want in g_p.items():
        got = g_k[name]
        if (got is None) != (want is None):
            raise SmokeFailure(f"verify-BAN: {name} has a gradient on one side only")
        if got is None:
            continue
        if not torch.isfinite(got).all():
            raise SmokeFailure(f"verify-BAN: {name}'s gradient on the card is not finite")
        if name in ban.SHIFT_INVARIANT:  # zero up to rounding: held to the largest
            shift = max(shift, got.abs().max().item() / largest,
                        want.abs().max().item() / largest)
            continue
        units = kinks.get(name.rsplit(".", 1)[0])
        if units is not None and len(units):
            keep = torch.ones(got.shape[0], dtype=torch.bool)
            keep[units] = False
            got, want = got[keep], want[keep]
        rel = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    n_kinks = {k: len(v) for k, v in kinks.items() if len(v)}
    ok = (max(errs["tmap"], errs["final_pred"], errs["offset"], kink_pre) <= TOL_BAN
          and torch.equal(on_card, sel_p) and torch.equal(spans_k, spans_p) and ties_ok
          and loss_err <= TOL_BAN_LOSS and max(worst, shift) <= TOL_TRAIN_F32
          and math.isfinite(loss_k))
    log(f"[verify-BAN] f32, card against CPU: {json.dumps(errs)} (tol {TOL_BAN}); the card's "
        f"selection on the CPU's scores equal: {torch.equal(on_card, sel_p)}; its own "
        f"selection differs in {own_differ} of {B_BAN} samples, each the CPU's selection on "
        f"the card's scores: {torch.equal(own_on_cpu, sel_own)}, first parting at a CPU score "
        f"gap of {tie_gap:.3e} (at most twice the scores' distance {score_err:.3e}); ban_infer spans equal: {torch.equal(spans_k, spans_p)}; loss card {loss_k!r} "
        f"cpu {loss_p!r} (rel {loss_err:.3e}, tol {TOL_BAN_LOSS}); worst gradient "
        f"{worst_name} at {worst:.3e} of its max over {len(g_p)}, the shift-invariant "
        f"{ban.SHIFT_INVARIANT} at {shift:.3e} of the largest (tol {TOL_TRAIN_F32}); units "
        f"on a ReLU kink left out {json.dumps(n_kinks)} (their pre-activations within "
        f"{kink_pre:.3e}); "
        f"CPU pass {cpu_s:.1f} s  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("verify-BAN: the card and the CPU disagree")
    return {"max_abs_err": errs, "tol": TOL_BAN, "selection_on_cpu_scores_equal": True,
            "own_selection_differs": own_differ, "own_selection_tie_gap": tie_gap,
            "score_max_abs_err": score_err, "spans_equal": True, "loss_rel_err": loss_err,
            "worst_grad_rel_err": worst, "worst_grad": worst_name,
            "shift_invariant_grad_rel": shift, "kink_units": n_kinks, "kink_pre_max": kink_pre,
            "n_grads": len(g_p)}


def train_config(phase: str, config: str, batch_size: int, n_timed: int, kernels, card: str,
                 root: str) -> dict:
    """The CLI's train-then-eval on a config as it is (``--synthetic
    --epochs 1``) in ``root``; ``--eval`` of the best checkpoint must give
    the logged best mIoU and test loss (one epoch, so the best is the only
    one); no kernel launch (the families trained this way run none).  Then
    ``n_timed`` timed train steps (after 2) through ``Trainer``: host clock
    per step, samples/s, peak device bytes and the card's busy share."""
    from vmrframe_tpu_torch.cli import main as cli_main
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.tools.profile_serve import _device_profile
    from vmrframe_tpu_torch.train.trainer import Trainer

    cfg, dataset, store, derived = config_world(config)
    dtype = str(cfg.train.get("compute_dtype", "float32"))
    stats = {"card": card, "config": config, "batch_size": batch_size, "dtype": dtype}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        zero_counts(kernels)
        t0 = time.perf_counter()
        fit = cli_main(["--config", os.path.abspath(os.path.join(cwd, config)), "--synthetic",
                        "--epochs", "1", "--device", "cuda"])
        stats["fit_s"] = time.perf_counter() - t0
        ev = cli_main(["--config", os.path.abspath(os.path.join(cwd, config)), "--synthetic",
                       "--eval", "--checkpoint", fit["best_path"], "--device", "cuda"])
        stats.update(steps=fit["steps"], best_miou=fit["best_miou"], eval_miou=ev["miou"],
                     train_loss=fit["history"][0]["train_loss"],
                     test_loss=fit["history"][0]["test_loss"], eval_loss=ev["loss"],
                     best_path=os.path.abspath(fit["best_path"]),
                     launches=read_launches(phase, kernels, {fn.__name__: 0 for fn in kernels}))
    finally:
        os.chdir(cwd)
    log(f"[{phase}] best mIoU logged by fit {fit['best_miou']!r}, --eval of its checkpoint "
        f"{ev['miou']!r}; test loss logged by fit {stats['test_loss']!r}, --eval's "
        f"{stats['eval_loss']!r}; mean train loss {stats['train_loss']!r}")
    if ev["miou"] != fit["best_miou"] or ev["loss"] != stats["test_loss"] \
            or not math.isfinite(stats["train_loss"]):
        raise SmokeFailure(f"{phase}: --eval of the best checkpoint gives another mIoU or "
                           "test loss, or the train loss is not finite")
    batcher_cls = get_model_entry(str(cfg.model.name)).batcher_cls or Batcher
    batcher = batcher_cls(dataset["train_set"], store, cfg, derived, "train")
    derived.num_train_steps = derived.steps_per_epoch = len(batcher)
    trainer = Trainer(cfg, derived, dataset["word_vector"], device="cuda")
    batches = [trainer.to_device(b) for b in batcher.epoch(seed=0)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(N_WARMUP_STEPS + n_timed):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(batches[i % len(batches)])["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    it = iter(range(10 ** 6))
    profiled = _device_profile(
        lambda: float(trainer.train_step(batches[next(it) % len(batches)])["loss"]), 4)
    timed = times[N_WARMUP_STEPS:]
    median = statistics.median(timed)
    busy = profiled["device_busy_ms_per_step"]
    if not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"{phase}: losses {losses}")
    stats["timed"] = {"steps": len(timed), "step_ms_median": median, "step_ms_min": min(timed),
                      "step_ms_max": max(timed), "samples_per_s": batch_size / (median / 1e3),
                      "peak_device_mem_bytes": peak, "device_busy_ms_per_step": busy,
                      "device_busy_share": busy / median if busy else None,
                      "device_ops_per_step": profiled.get("device_ops_per_step"),
                      "top_device_ops": profiled.get("top_kernels", [])[:6], "losses": losses}
    log(f"[{phase}] {dtype} batch {batch_size}: median {median:.3f} ms/step ({min(timed):.3f}-"
        f"{max(timed):.3f}, host clock, {len(timed)} steps), {batch_size / (median / 1e3):.1f} "
        f"samples/s, peak {peak} bytes, card busy "
        f"{'not measured' if not busy else f'{busy:.3f} ms ({busy / median:.1%})'}, on {card}")
    return stats


def phase_train_ban(kernels, card: str, root: str) -> dict:
    """BAN's long config as it is (f32, batch 8; ``train_config``)."""
    return train_config("train-BAN", BAN_CONFIG, B_BAN, N_BAN_TIMED, kernels, card, root)


def phase_ban_pretrain(kernels, card: str, teacher: str) -> dict:
    """``BaseFast_BAN_PreTrain`` on the long BAN config's data (vlen 128,
    vdim 1024; the QANet-block student at dim 256, 4 heads) with the
    train-BAN checkpoint as its frozen teacher: ``N_PRETRAIN_STEPS`` train
    steps at the config's droprate (0.1: the student's cores plain, no
    launch) and at 0 (2 of #3 and 2 of #1 a step), one eval forward (2 and
    2); the teacher bit-equal after.  Then ``export_labels`` of that BAN
    checkpoint on the card against the CPU's curves (``TOL_BAN_EXPORT``)."""
    from vmrframe_tpu_torch.config import load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.tools.export_labels import export_labels
    from vmrframe_tpu_torch.train.trainer import Trainer
    from vmrframe_tpu_torch.weights import load_checkpoint, read_checkpoint

    ban_model = load_config(BAN_CONFIG).model.to_dict()
    updates = {"model.name": "BaseFast_BAN_PreTrain", "loss.temperature": 3,
               "teacher0.model": {**ban_model, "checkpoint": teacher}}
    stats = {"card": card, "teacher": os.path.basename(teacher)}
    for label, rate in (("droprate 0.1", None), ("droprate 0", 0.0)):
        up = dict(updates) if rate is None else {**updates, "model.droprate": rate}
        cfg, dataset, store, derived = config_world(updates=up, n_train=B_BAN * N_PRETRAIN_STEPS)
        train = Batcher(dataset["train_set"], store, cfg, derived, "train")
        derived.num_train_steps = derived.steps_per_epoch = len(train)
        trainer = Trainer(cfg, derived, dataset["word_vector"], device="cuda")
        start = {k: v.clone() for k, v in trainer.model.named_parameters()
                 if k.startswith("teach_model.")}
        saved = read_checkpoint(teacher)
        if any(not torch.equal(v.cpu(), saved[k[len("teach_model."):]]) for k, v in start.items()):
            raise SmokeFailure("ban-pretrain: the hook did not load the BAN checkpoint")
        zero_counts(kernels)
        times, losses = [], []
        for b in train.epoch(seed=0):
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(trainer.to_device(b))["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        n = len(times)
        launches = read_launches(f"ban-pretrain {label}", kernels,
                                 want_launches(STUDENT_LAUNCHES, n if rate == 0.0 else 0))
        moved = [k for k, v in start.items()
                 if not torch.equal(v, dict(trainer.model.named_parameters())[k])]
        if moved or not all(math.isfinite(x) for x in losses):
            raise SmokeFailure(f"ban-pretrain {label}: teacher moved {moved[:3]}, losses {losses}")
        stats[label] = {"steps": n, "losses": losses, "step_ms": times,
                        "launches_per_step": {k: v / n for k, v in launches.items()}}
        log(f"[ban-pretrain] {label}: {n} steps, {json.dumps(times)} ms (host clock), losses "
            f"{losses}, the teacher's {len(start)} tensors bit-equal after, launches "
            f"{json.dumps(launches)}")
    zero_counts(kernels)
    test = Batcher(dataset["test_set"], store, cfg, derived).make_batch(list(range(B_BAN)))
    trainer.model.eval()
    with torch.no_grad():
        trainer.forward(trainer.to_device(test))
    stats["eval_launches"] = read_launches("ban-pretrain eval", kernels, STUDENT_LAUNCHES)

    cfg, dataset, store, derived = config_world(n_train=16)
    curves = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(cfg, derived, dataset["word_vector"], device=device)
        load_checkpoint(trainer.model, teacher)
        with tempfile.NamedTemporaryFile(suffix=".pkl") as f:
            t0 = time.perf_counter()
            curves[device] = export_labels(cfg, derived, dataset, store, trainer, f.name)
            stats[f"export_{device}_s"] = time.perf_counter() - t0
    err = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(curves["cuda"], curves["cpu"]))
    same = [a[0] for a in curves["cuda"]] == [b[0] for b in curves["cpu"]] and all(
        a[1].shape == b[1].shape for a, b in zip(curves["cuda"], curves["cpu"]))
    ok = same and err <= TOL_BAN_EXPORT
    log(f"[ban-pretrain] export_labels of the BAN checkpoint, {len(curves['cuda'])} curves: "
        f"card against CPU max abs {err:.3e} (tol {TOL_BAN_EXPORT})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("ban-pretrain: the card's export and the CPU's disagree")
    stats["export_max_abs_err"] = err
    return stats


CCA_CONFIG, CPL_CONFIG = "configs/anet_cca.yaml", "configs/charades_cpl.yaml"
B_CCA, B_CPL = 64, 128  # the configs' batches
# 40 full batches each, a window of several seconds: a window of 5-7
# forwards (under a second) reads the host's jitter more than the rate
N_CCA_REQUESTS, CCA_CONCURRENCY = 40 * B_CCA, 64
N_CPL_REQUESTS, CPL_CONCURRENCY = 40 * B_CPL, 128
N_ZOO_TIMED = 10
B_ZOO_VERIFY = 8  # the card-against-CPU batch: the CPU's side of CCA's 3216-wide layer
# whole f32 forward of CCA or CPL, card against CPU (absolute; the outputs
# are O(1)), the loss relative; each gradient within TOL_TRAIN_F32 of its
# largest magnitude
TOL_ZOO, TOL_ZOO_LOSS = 1e-4, 1e-5


def _zoo_batch(cfg, dataset, store, derived, n: int):
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.registry import get_model_entry

    batcher_cls = get_model_entry(str(cfg.model.name)).batcher_cls or Batcher
    batch = batcher_cls(dataset["test_set"], store, cfg, derived, batch_size=n).make_batch(
        list(range(n)))
    return {k: torch.as_tensor(v) for k, v in batch.items() if k != "num_valid"}


def _grads_close(phase: str, g_p: dict, g_k: dict, shift_invariant=()) -> tuple:
    """(the worst gradient's distance in units of its largest magnitude,
    its name, the shift-invariant ones' largest magnitude in units of the
    largest gradient)."""
    largest = max(v.abs().max().item() for v in g_p.values() if v is not None)
    worst, worst_name, shift = 0.0, None, 0.0
    for name, want in g_p.items():
        got = g_k[name]
        if (got is None) != (want is None):
            raise SmokeFailure(f"{phase}: {name} has a gradient on one side only")
        if got is None:
            continue
        if not torch.isfinite(got).all():
            raise SmokeFailure(f"{phase}: {name}'s gradient on the card is not finite")
        if name in shift_invariant:  # zero up to rounding: held to the largest
            shift = max(shift, got.abs().max().item() / largest,
                        want.abs().max().item() / largest)
            continue
        rel = (got.cpu() - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name, shift


def _spans_where_apart(choice_k, choice_p, top2, err: float) -> tuple:
    """(samples whose best two candidates lie more than twice ``err``
    apart, how many of those choose differently): a nearer pair may flip
    under any change of rounding.  ``choice_*``: (B, k) spans or indices."""
    apart = (top2[:, 0] - top2[:, 1]).abs() > 2 * err
    differ = (choice_k != choice_p).any(dim=1) & apart
    return int(apart.sum()), int(differ.sum())


def _zoo_pass(model, entry, cfg, batch, train: bool):
    """One forward (train mode with every dropout at 0, or eval), the loss
    and, in train mode, every parameter's gradient."""
    from vmrframe_tpu_torch.layers.dropout import Dropout

    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    model.train(train)
    with torch.set_grad_enabled(train):
        out = model(batch)
        loss = entry.loss_fn(out, batch, cfg)
    grads = {}
    if train:
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                    allow_unused=True)))
        grads = {k: None if v is None else v.detach().cpu() for k, v in grads.items()}
    out = {k: v.detach().cpu() for k, v in out.items()}
    spans = entry.infer_fn(out, {k: v.cpu() for k, v in batch.items()}, cfg)
    return out, float(loss.detach()), grads, spans


def phase_serve_cca(kernels, card: str) -> dict:
    """CCA on ``configs/anet_cca.yaml`` as it is (64 clips of 1024-d
    features, the synthetic concept graph of 3152 nodes, the 3216-wide
    transformer, 3-layer BiLSTM queries, f32) at its batch of 64."""
    return serve_config("serve-CCA", CCA_CONFIG, B_CCA, N_CCA_REQUESTS, CCA_CONCURRENCY,
                        kernels, card)


def phase_verify_cca() -> dict:
    """One f32 batch of 8 through CCA at full width, card (no TF32) against
    the CPU, same seeded weights: the eval forward's ``scores2d`` within
    ``TOL_ZOO``, its loss within ``TOL_ZOO_LOSS`` relative, ``cca_infer``'s
    spans equal in every sample whose best two cells lie more than twice the
    scores' distance apart; then one train-mode forward (BatchNorm on the
    batch's statistics, dropout off), its loss, every gradient within
    ``TOL_TRAIN_F32`` of its largest magnitude (the shift-invariant biases,
    ``models/cca.py::TRAIN_SHIFT_INVARIANT``, of the largest gradient) and
    BatchNorm's running statistics after it within ``TOL_ZOO``."""
    from vmrframe_tpu_torch.models import cca
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.weights import init_weights

    cfg, dataset, store, derived = config_world(CCA_CONFIG)
    batch = _zoo_batch(cfg, dataset, store, derived, B_ZOO_VERIFY)
    entry = get_model_entry("CCA")
    models = {dev: init_weights(entry.model_cls(cfg, derived, dataset["word_vector"]), 0).to(dev)
              for dev in ("cpu", "cuda")}
    batches = {"cpu": batch, "cuda": {k: v.cuda() for k, v in batch.items()}}
    t0 = time.perf_counter()
    cpu = [_zoo_pass(models["cpu"], entry, cfg, batches["cpu"], train) for train in (False, True)]
    cpu_s = time.perf_counter() - t0
    card = [_zoo_pass(models["cuda"], entry, cfg, batches["cuda"], train)
            for train in (False, True)]
    (out_p, loss_p, _, spans_p), (_, tloss_p, g_p, _) = cpu
    (out_k, loss_k, _, spans_k), (_, tloss_k, g_k, _) = card
    err = (out_k["scores2d"] - out_p["scores2d"]).abs().max().item()
    L = int(cfg.MODEL.CCA.NUM_CLIPS)
    scores = torch.sigmoid(out_p["scores2d"]) * torch.as_tensor(cca._dense_mask(L))
    top2 = scores.reshape(B_ZOO_VERIFY, -1).topk(2, dim=1).values
    n_apart, n_differ = _spans_where_apart(spans_k, spans_p, top2, err)
    bn = {dev: models[dev].sim_map.bn for dev in models}
    stats_err = max((getattr(bn["cuda"], k).cpu() - getattr(bn["cpu"], k)).abs().max().item()
                    for k in ("running_mean", "running_var"))
    worst, worst_name, shift = _grads_close("verify-CCA", g_p, g_k, cca.TRAIN_SHIFT_INVARIANT)
    loss_err = max(abs(loss_k - loss_p) / abs(loss_p), abs(tloss_k - tloss_p) / abs(tloss_p))
    ok = (err <= TOL_ZOO and loss_err <= TOL_ZOO_LOSS and n_differ == 0 and n_apart > 0
          and stats_err <= TOL_ZOO and max(worst, shift) <= TOL_TRAIN_F32)
    log(f"[verify-CCA] f32 batch {B_ZOO_VERIFY}, card against CPU: scores2d max abs {err:.3e} "
        f"(tol {TOL_ZOO}); loss eval card {loss_k!r} cpu {loss_p!r}, train card {tloss_k!r} cpu "
        f"{tloss_p!r} (rel {loss_err:.3e}, tol {TOL_ZOO_LOSS}); spans equal in the {n_apart} "
        f"of {B_ZOO_VERIFY} samples whose best two cells lie more than twice that apart: "
        f"{n_differ == 0}; BatchNorm running statistics after one train forward within "
        f"{stats_err:.3e}; worst gradient {worst_name} at {worst:.3e} of its max over "
        f"{len(g_p)}, the shift-invariant {cca.TRAIN_SHIFT_INVARIANT} at {shift:.3e} of the "
        f"largest (tol {TOL_TRAIN_F32}); CPU passes {cpu_s:.1f} s  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("verify-CCA: the card and the CPU disagree")
    return {"scores_max_abs_err": err, "tol": TOL_ZOO, "loss_rel_err": loss_err,
            "spans_apart": n_apart, "spans_differ": n_differ, "bn_stats_max_abs_err": stats_err,
            "worst_grad_rel_err": worst, "worst_grad": worst_name,
            "shift_invariant_grad_rel": shift, "n_grads": len(g_p), "cpu_s": cpu_s}


def phase_train_cca(kernels, card: str, root: str) -> dict:
    """CCA's config as it is (f32, batch 64; ``train_config``); then the
    device time of its two port-only ops at the shapes a train step gives
    them (``time_cca_ops``)."""
    stats = train_config("train-CCA", CCA_CONFIG, B_CCA, N_ZOO_TIMED, kernels, card, root)
    stats["ops"] = time_cca_ops(card)
    return stats


def time_cca_ops(card: str) -> dict:
    """``cosine_sum_scores`` (q (64, 64), map (64, 64, 64, 64)) and
    ``cell_segment_max_map`` (clips (64, 64, 64) over the 1344-row strided
    map of pooling [15, 8, 8]), f32, forward and forward + backward, device
    time by CUDA events; beside each, its bytes bound (the map read once,
    or written once, at 3.35 TB/s)."""
    from vmrframe_tpu_torch.models import cca
    from vmrframe_tpu_torch.ops.windowed import cell_segment_max_map

    g = torch.Generator(device="cuda").manual_seed(0)
    Bc = L = Hc = 64
    _, cells = cca.cca_strided_mask_meta((15, 8, 8), L)
    q = torch.randn(Bc, Hc, device="cuda", generator=g, requires_grad=True)
    m = torch.randn(Bc, L, L, Hc, device="cuda", generator=g, requires_grad=True)
    x = torch.randn(Bc, L, Hc, device="cuda", generator=g, requires_grad=True)
    gs = torch.randn(Bc, L, L, device="cuda", generator=g)
    gm = torch.randn(Bc, L, L, Hc, device="cuda", generator=g)
    map_bytes = m.numel() * 4
    rows = {
        "cosine_sum_scores": (lambda: cca.cosine_sum_scores(q, m), gs, (q, m)),
        "cell_segment_max_map": (lambda: cell_segment_max_map(x, cells), gm, (x,)),
    }
    out = {}
    for name, (fn, grad_out, inputs) in rows.items():
        with torch.no_grad():
            fwd = device_ms(fn)
        both = device_ms(lambda: torch.autograd.grad(fn(), inputs, grad_out))
        out[name] = {"fwd_ms": fwd["median"], "fwd_bwd_ms": both["median"],
                     "bytes_bound_fwd_ms": map_bytes / HBM_BYTES_PER_S * 1e3}
    log(f"[train-CCA] port-only ops at the train shapes, f32, on {card}: {json.dumps(out)}")
    return out


def phase_cca_pretrain(kernels, card: str, teacher: str) -> dict:
    """CCA's teacher curves feed ``BaseFast_CCA_PreTrain``: ``export_labels``
    of the train-CCA checkpoint over a train split of 24 on the card, against
    the CPU's export of the same checkpoint (``TOL_BAN_EXPORT``), each curve
    the row or column maxima of sigmoid(scores2d) * mask2d(64) over its clip,
    L2-normalized.  Then the student (the QANet-block tower at Charades'
    widths, dim 128, 4 heads, over CCA's data) reads the card's curves
    (``loss.t0_path``) and takes ``N_PRETRAIN_STEPS`` train steps at the
    config's droprate 0.1 (no launch) and one eval forward (2/2 of #3/#1):
    finite losses."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.tools.export_labels import export_labels
    from vmrframe_tpu_torch.train.trainer import Trainer
    from vmrframe_tpu_torch.weights import load_checkpoint

    n_train = B_ZOO_VERIFY * N_PRETRAIN_STEPS
    cfg, dataset, store, derived = config_world(CCA_CONFIG, {"train.batch_size": B_ZOO_VERIFY},
                                                n_train=n_train)
    stats, curves = {"card": card, "teacher": os.path.basename(teacher)}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for device in ("cuda", "cpu"):
            trainer = Trainer(cfg, derived, dataset["word_vector"], device=device)
            load_checkpoint(trainer.model, teacher)
            zero_counts(kernels)
            t0 = time.perf_counter()
            curves[device] = export_labels(cfg, derived, dataset, store, trainer,
                                           os.path.join(tmp, f"{device}.pkl"))
            stats[f"export_{device}_s"] = time.perf_counter() - t0
        stats["export_launches"] = read_launches("cca-pretrain export", kernels,
                                                 {fn.__name__: 0 for fn in kernels})
        err = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(curves["cuda"], curves["cpu"]))
        same = [a[0] for a in curves["cuda"]] == [b[0] for b in curves["cpu"]] and all(
            a[1].shape == b[1].shape and a[1].shape[0] == 2
            for a, b in zip(curves["cuda"], curves["cpu"]))
        norms = [float(np.linalg.norm(c[1], axis=1).min()) for c in curves["cuda"]]
        ok = same and err <= TOL_BAN_EXPORT and len(curves["cuda"]) == n_train \
            and min(norms) > 0.99
        log(f"[cca-pretrain] export_labels of the CCA checkpoint, {len(curves['cuda'])} curves: "
            f"card against CPU max abs {err:.3e} (tol {TOL_BAN_EXPORT}), smallest curve norm "
            f"{min(norms):.6f}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure("cca-pretrain: the card's export and the CPU's disagree")
        stats["export_max_abs_err"] = err

        student = load_config(CCA_CONFIG).updated({
            "model.name": "BaseFast_CCA_PreTrain", "model.dim": 128, "model.num_heads": 4,
            "loss.temperature": 3, "loss.t0_path": os.path.join(tmp, "cuda.pkl"),
            "train.batch_size": B_ZOO_VERIFY})
        sder = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
        batcher_cls = get_model_entry("BaseFast_CCA_PreTrain").batcher_cls
        train = batcher_cls(dataset["train_set"], store, student, sder, "train")
        sder.num_train_steps = sder.steps_per_epoch = len(train)
        trainer = Trainer(student, sder, dataset["word_vector"], device="cuda")
        zero_counts(kernels)
        times, losses = [], []
        for b in train.epoch(seed=0):
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(trainer.to_device(b))["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        n = len(times)
        launches = read_launches("cca-pretrain train", kernels, want_launches(STUDENT_LAUNCHES, 0))
        if not all(math.isfinite(x) for x in losses):
            raise SmokeFailure(f"cca-pretrain: losses {losses}")
        zero_counts(kernels)
        first = batcher_cls(dataset["train_set"], store, student, sder).make_batch(
            list(range(B_ZOO_VERIFY)))  # the curves are the train split's
        trainer.model.eval()
        with torch.no_grad():
            trainer.forward(trainer.to_device(first))
        stats.update(steps=n, losses=losses, step_ms=times, train_launches=launches,
                     eval_launches=read_launches("cca-pretrain eval", kernels, STUDENT_LAUNCHES))
    log(f"[cca-pretrain] BaseFast_CCA_PreTrain on CCA's curves: {n} steps at droprate 0.1, "
        f"{json.dumps(times)} ms (host clock), losses {losses}")
    return stats


def phase_serve_cpl(kernels, card: str) -> dict:
    """CPL on ``configs/charades_cpl.yaml`` as it is (dim 128, 4 heads, 8
    Gaussian proposals a clip, 64 clips, 25 words, f32) at its batch of 128."""
    return serve_config("serve-CPL", CPL_CONFIG, B_CPL, N_CPL_REQUESTS, CPL_CONCURRENCY,
                        kernels, card)


def phase_verify_cpl() -> dict:
    """One f32 batch of 8 through CPL at full width, card against the CPU,
    same seeded weights, dropout off: ``words_logit``, ``gauss_weight``,
    ``center`` and ``width`` within ``TOL_ZOO``, the loss within
    ``TOL_ZOO_LOSS`` relative, every gradient within ``TOL_TRAIN_F32`` of its
    largest magnitude; ``cpl_infer`` chooses the same proposal in every
    sample whose two lowest proposal NLLs lie more than twice the NLLs'
    distance apart, and its spans there lie within ``TOL_ZOO``."""
    from vmrframe_tpu_torch.losses import cal_nll_loss
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.weights import init_weights

    cfg, dataset, store, derived = config_world(CPL_CONFIG)
    batch = _zoo_batch(cfg, dataset, store, derived, B_ZOO_VERIFY)
    entry = get_model_entry("CPL")
    models = {dev: init_weights(entry.model_cls(cfg, derived, dataset["word_vector"]), 0).to(dev)
              for dev in ("cpu", "cuda")}
    out_p, loss_p, g_p, spans_p = _zoo_pass(models["cpu"], entry, cfg, batch, True)
    out_k, loss_k, g_k, spans_k = _zoo_pass(models["cuda"], entry, cfg,
                                            {k: v.cuda() for k, v in batch.items()}, True)
    errs = {k: (out_k[k] - out_p[k]).abs().max().item()
            for k in ("words_logit", "gauss_weight", "center", "width")}
    P = int(cfg.others.cpl_num_props)

    def nll(out):
        return cal_nll_loss(out["words_logit"], out["word_ids"].repeat_interleave(P, 0),
                            out["words_mask"].repeat_interleave(P, 0))[0].reshape(-1, P)

    nll_p, nll_k = nll(out_p), nll(out_k)
    nll_err = (nll_k - nll_p).abs().max().item()
    low2 = -(-nll_p).topk(2, dim=1).values
    best_p, best_k = nll_p.argmin(dim=1, keepdim=True), nll_k.argmin(dim=1, keepdim=True)
    n_apart, n_differ = _spans_where_apart(best_k, best_p, low2, nll_err)
    same = (best_k == best_p).flatten()
    span_err = (spans_k[same] - spans_p[same]).abs().max().item() if same.any() else 0.0
    worst, worst_name, shift = _grads_close("verify-CPL", g_p, g_k)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    ok = (max(errs.values()) <= TOL_ZOO and loss_err <= TOL_ZOO_LOSS and n_differ == 0
          and n_apart > 0 and span_err <= TOL_ZOO and worst <= TOL_TRAIN_F32)
    log(f"[verify-CPL] f32 batch {B_ZOO_VERIFY} ({B_ZOO_VERIFY * P} proposals), card against "
        f"CPU: {json.dumps(errs)} (tol {TOL_ZOO}); loss card {loss_k!r} cpu {loss_p!r} (rel "
        f"{loss_err:.3e}, tol {TOL_ZOO_LOSS}); proposal NLLs within {nll_err:.3e}, the chosen "
        f"proposal equal in the {n_apart} of {B_ZOO_VERIFY} samples whose best two lie more "
        f"than twice that apart: {n_differ == 0}, the spans of the equal choices within "
        f"{span_err:.3e}; worst gradient {worst_name} at {worst:.3e} of its max over "
        f"{len(g_p)} (tol {TOL_TRAIN_F32})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("verify-CPL: the card and the CPU disagree")
    return {"max_abs_err": errs, "tol": TOL_ZOO, "loss_rel_err": loss_err,
            "nll_max_abs_err": nll_err, "choices_apart": n_apart, "choices_differ": n_differ,
            "span_max_abs_err": span_err,
            "worst_grad_rel_err": worst, "worst_grad": worst_name, "n_grads": len(g_p)}


def phase_train_cpl(kernels, card: str, root: str) -> dict:
    """CPL's config as it is (f32, batch 128; ``train_config``)."""
    return train_config("train-CPL", CPL_CONFIG, B_CPL, N_ZOO_TIMED, kernels, card, root)


# ------------------------------------------------ the zoo's tools and DDP


ZOO_ROWS = ("SeqPAN", "BAN", "CCA", "ActionFormerLong", "CPL")  # tools/bench_zoo.py rows
ZOO_FLOP_CHECK = ("SeqPAN", "BAN")  # #1-#3's launches; cuDNN's LSTMs
ZOO_STEPS, ZOO_REPS = 5, 3
TOL_FLOPS = 1e-6  # relative: the card's count against the CPU's at the same shapes
# launches a (train, eval) step of each row (PERF.md §6); a kernel not named: 0.
# SeqPAN's row is f32 with the stack's flag off at droprate 0.2, where a
# train step launches nothing
ZOO_LAUNCHES = {
    "SeqPAN": ({}, {"fused_masked_attention": 2, "fused_dual_attention": 4,
                    "fused_cq_attention": 2}),
    "BAN": ({}, {}), "CCA": ({}, {}), "CPL": ({}, {}),
    "ActionFormerLong": ({"banded_attention": 4, "banded_attention_dq": 4,
                          "banded_attention_dkv": 4}, {"banded_attention": 4}),
}
SWEEP_LAUNCHES = {"A": {STACK: 0, "fused_dual_attention": 4},  # flag off, per eval step
                  "B": {STACK: 1, "fused_dual_attention": 0}}  # flag on
N_DDP_STEPS = 3
TOL_DDP = 1e-6  # relative, NCCL world 1 against the plain trainer


def phase_zoo(card: str) -> dict:
    """``tools/bench_zoo.py`` rows on the card: times, launches a step, FLOPs
    and MFU; SeqPAN's and BAN's FLOP counts against the CPU's count at the
    same shapes (the counting route: plain versions, no cuDNN)."""
    from vmrframe_tpu_torch.tools import bench_zoo

    rows = {}
    for name in ZOO_ROWS:
        # no profiler pass here: tools/bench_zoo.py measures the busy share
        row = bench_zoo.bench_model(name, "cuda", ZOO_STEPS, ZOO_REPS, profile=False)
        for mode, want in zip(("train", "eval"), ZOO_LAUNCHES[name]):
            got = row[f"{mode}_launches_per_step"]
            if got != {k: want.get(k, 0) for k in got}:
                raise SmokeFailure(f"zoo {name}: {mode} launches a step {got}, want {want}")
        for key in ("train_ms_per_step", "eval_ms_per_step", "train_flops", "eval_flops"):
            if not (math.isfinite(row[key]) and row[key] > 0):
                raise SmokeFailure(f"zoo {name}: {key} = {row[key]}")
        if name in ZOO_FLOP_CHECK:
            path, overrides = bench_zoo.MODELS[name]
            _, trainer, train, test = bench_zoo.build_from(path, overrides, "cpu")
            cpu = {"train": bench_zoo.count_flops(trainer, train, train=True),
                   "eval": bench_zoo.count_flops(trainer, test, train=False)}
            for mode, flops in cpu.items():
                rel = abs(row[f"{mode}_flops"] - flops) / flops
                if rel > TOL_FLOPS:
                    raise SmokeFailure(f"zoo {name}: {mode} FLOPs {row[f'{mode}_flops']} on "
                                       f"the card, {flops} on the CPU (rel {rel:.2e})")
            row["cpu_flops"] = cpu
        log(f"[zoo] {name} ({row['dtype']}, batch {row['batch_size']}): train "
            f"{row['train_ms_per_step']:.3f} ms ({row['train_gflops_per_step']:.3f} GFLOP, MFU "
            f"{row['train_mfu_pct']:.2f}%, {row['train_bound']}), eval "
            f"{row['eval_ms_per_step']:.3f} ms ({row['eval_gflops_per_step']:.3f} GFLOP, MFU "
            f"{row['eval_mfu_pct']:.2f}%, {row['eval_bound']})"
            + (f"; FLOPs equal to the CPU's {row['cpu_flops']}" if "cpu_flops" in row else "")
            + f", on {card}")
        rows[name] = row
    return rows


def phase_sweep(card: str) -> dict:
    """``tools/flag_sweep.py``'s ``fused_dual_stack`` pair (one A/B pair,
    each a fresh process) on SeqPAN's Charades eval step: 4 launches of #2
    with the flag off, 1 of #4 with it on."""
    from vmrframe_tpu_torch.tools import flag_sweep

    res = flag_sweep.sweep("fused_dual_stack", "cuda", pairs=1, steps=10, reps=3, log=log)
    for label, want in SWEEP_LAUNCHES.items():
        got = {k: res[label]["launches_per_step"][k] for k in want}
        if got != want:
            raise SmokeFailure(f"sweep: candidate {label} launches {got} a step, want {want}")
    log(f"[sweep] fused_dual_stack on/off eval step: {res['B']['ms']['median']:.3f} / "
        f"{res['A']['ms']['median']:.3f} ms (one pair; tools/flag_sweep.py takes 3 or more), "
        f"on {card}")
    return res


def phase_convert(kernels) -> dict:
    """A reference-layout SeqPAN ``state_dict`` at Charades width (a seeded
    port model under the reference's names and layouts, with its dead
    tensors), converted by ``tools/convert_torch.py``: every tensor equal to
    the source's; then served for one f32 batch by the ``Evaluator`` on the
    card and on the CPU, within ``TOL_MODEL_F32``; 1/0/2/2 launches."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.models.seqpan import SeqPAN
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.tools.convert_torch import reference_layout, to_port_state
    from vmrframe_tpu_torch.train.evaluator import Evaluator
    from vmrframe_tpu_torch.weights import init_weights

    cfg = load_config(SEQPAN_CONFIG).updated({"train.compute_dtype": "float32"})
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=B, n_test=B)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
    source = init_weights(SeqPAN(cfg, derived, dataset["word_vector"]), seed=7)
    reference = reference_layout(source)
    state = to_port_state(reference)
    for k, v in source.state_dict().items():
        if not torch.equal(state[k], v):
            raise SmokeFailure(f"convert: {k} is not the source's after the conversion")
    batch = Batcher(dataset["test_set"], store, cfg, derived).make_batch(list(range(B)))
    outs = {}
    for device in ("cuda", "cpu"):
        ev = Evaluator(cfg, derived, dataset["word_vector"], device=device)
        ev.load_state_dict(state)
        b = ev.to_device(batch)
        zero_counts(kernels)
        out = ev.forward(b)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in kernels if fn.launches}
        outs[device] = {k: out[k].cpu() for k in ("slogits", "elogits")}
    errs = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item() for k in outs["cpu"]}
    want = {k: v for k, v in SERVE_LAUNCHES[True].items() if v}
    ok = max(errs.values()) <= TOL_MODEL_F32 and launches == want \
        and all(torch.isfinite(v).all() for v in outs["cuda"].values())
    log(f"[convert] {len(reference)} reference tensors -> {len(state)} port tensors, equal to "
        f"the source; served f32 batch of {B}, card against CPU {json.dumps(errs)} (tol "
        f"{TOL_MODEL_F32}), launches {json.dumps(launches)}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"convert: errors {errs}, launches {launches} (want {want})")
    return {"reference_tensors": len(reference), "port_tensors": len(state),
            "max_abs_err": errs, "tol": TOL_MODEL_F32, "launches": launches}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_ddp(K, S, card: str, root: str) -> dict:
    """The ``Trainer`` in a NCCL process group of one (its data-parallel
    route: the outputs gathered, the gradients all-reduced) against the plain
    trainer: ``N_DDP_STEPS`` SeqPAN steps at Charades width, f32, droprate 0,
    the same losses (``TOL_DDP`` relative) and launches (2/4/2 of #1/#2/#3 a
    step); the group torn down.  Then ``torchrun --nproc_per_node 1 -m
    vmrframe_tpu_torch`` trains the tiny SeqPAN test config one epoch."""
    import torch.distributed as dist

    from vmrframe_tpu_torch.train.trainer import Trainer

    cfg, derived, dataset, batcher = family_world(
        SEQPAN_CONFIG, {"model.droprate": 0.0, "train.compute_dtype": "float32"}, 1)
    batch = next(batcher.epoch(seed=0))
    kernels = K.KERNELS + S.KERNELS
    runs = {}
    for label in ("plain", "ddp"):
        if label == "ddp":
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                                    world_size=1, rank=0)
        try:
            trainer = Trainer(cfg, derived, dataset["word_vector"], device="cuda")
            b = trainer.to_device(batch)
            zero_counts(kernels)
            losses = [float(trainer.train_step(b)["loss"]) for _ in range(N_DDP_STEPS)]
            torch.cuda.synchronize()
            launches = read_launches(f"ddp {label}", kernels,
                                     want_launches(SEQPAN_TRAIN_LAUNCHES, N_DDP_STEPS))
        finally:
            if label == "ddp":
                dist.destroy_process_group()
        runs[label] = {"losses": losses, "launches": launches}
        del trainer
    rel = max(abs(a - p) / abs(p) for a, p in zip(runs["ddp"]["losses"], runs["plain"]["losses"]))
    ok = rel <= TOL_DDP and all(math.isfinite(x) for x in runs["ddp"]["losses"])
    log(f"[ddp] NCCL world 1 against the plain trainer, {N_DDP_STEPS} steps: losses "
        f"{runs['ddp']['losses']} / {runs['plain']['losses']} (rel {rel:.2e}, tol {TOL_DDP})  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"ddp: losses {runs['ddp']['losses']} against "
                           f"{runs['plain']['losses']}")
    config = os.path.join(root, "tiny.yaml")
    with open("tests/configs/charades_seqpan.yaml") as f:
        text = f.read()
    with open(config, "w") as f:
        f.write(text.replace('ckpt_dir: "/tmp/vmr_tpu_test_ckpt"', 'ckpt_dir: "ckpt/"'))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", "-m", "vmrframe_tpu_torch", "--config",
                           config, "--synthetic", "--epochs", "1"], cwd=root, text=True,
                          capture_output=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": os.getcwd()})
    ckpt = os.path.join(root, "ckpt", "charades_", "best_SeqPAN.pt")
    if proc.returncode != 0 or not os.path.exists(ckpt):
        raise SmokeFailure(f"ddp: torchrun failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    seconds = time.perf_counter() - t0
    log(f"[ddp] torchrun --nproc_per_node 1 -m vmrframe_tpu_torch trained one epoch in "
        f"{seconds:.1f} s, wrote {os.path.relpath(ckpt, root)}, on {card}")
    return {**runs, "loss_rel_err": rel, "tol": TOL_DDP, "torchrun_s": seconds}


# the bf16 routes read against f32 by the repairs phase: BackBoneActionFormer
# (its f32 position table promotes its backbone to f32), and SeqPAN's
# module-path dual attention, bf16 as in the JAX package's jitted route
N_BAN_BF16_REQUESTS, N_BAN_BF16_STEPS = 64, 3
REPAIR_ROUTES = (
    ("BackBoneActionFormer", "configs/charades_backbone_actionformer.yaml", {}),
    ("SeqPAN flag off", "configs/charades_seqpan_fused.yaml", {"model.fused_dual_stack": False}),
)


def phase_repairs(kernels, card: str) -> dict:
    """The bf16 routes and the kernels' gates.  Each of ``REPAIR_ROUTES``'
    bf16 eval forward (the serving policy) against its f32 eval forward on
    the card, same seeded weights and batch of 32, the AffineDropPath
    scales lifted (``testing.lift_drop_path``; SeqPAN has none): each
    logit's largest distance beside its largest f32 magnitude and the bf16
    forward's launches, printed, and held to finiteness only.  Then one
    case just past each kernel's limit (``testing.past_limit_cases``: #5 at
    head dim 192, #3 at a 1025-position context, #1 at head dim 264), f32:
    no launch of that kernel, and the CPU's values within ``TOL_F32``; #4
    past its limit (``testing.stack_past_limit_case``: a flag-on BackBone
    at D 1152) raises the wrapper's ``ValueError`` with no launch."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.kernels import dual_stack as S
    from vmrframe_tpu_torch.testing import (lift_drop_path, make_synthetic_data, past_limit_cases,
                                            stack_past_limit_case)
    from vmrframe_tpu_torch.train.evaluator import Evaluator

    stats = {}
    for label, config, updates in REPAIR_ROUTES:
        cfg = load_config(config).updated(updates)
        dataset, store = make_synthetic_data(cfg, seed=0, n_train=32, n_test=32)
        derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"])
        batch = Batcher(dataset["test_set"], store, cfg, derived, batch_size=32).make_batch(
            list(range(32)))
        outs = {}
        for dtype in ("float32", "bfloat16"):
            ev = Evaluator(cfg.updated({"train.compute_dtype": dtype}), derived,
                           dataset["word_vector"], device="cuda", seed=0)
            lift_drop_path(ev.model, seed=0)
            zero_counts(kernels)
            outs[dtype] = ev.forward(ev.to_device(batch))
            outs[f"launches_{dtype}"] = {fn.__name__: fn.launches for fn in kernels}
        route = {}
        for key in ("slogits", "elogits"):
            f32, bf16 = outs["float32"][key].float(), outs["bfloat16"][key].float()
            if not torch.isfinite(bf16).all():
                raise SmokeFailure(f"repairs: {label}'s bf16 {key} are not finite")
            route[key] = {"max_abs_dist": (bf16 - f32).abs().max().item(),
                          "f32_max_abs": f32.abs().max().item()}
        route["launches_bf16"] = outs["launches_bfloat16"]
        stats[f"bf16_route {label}"] = route
        log(f"[repairs] {label} bf16 route against f32 on {card}: {json.dumps(route)}")

    def move(xs, dev):
        return tuple({k: v.to(dev) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)
                     for x in xs)

    first = lambda o: o[0] if isinstance(o, tuple) else o  # noqa: E731
    model, batch = stack_past_limit_case()
    zero_counts(kernels)
    try:
        with torch.no_grad():
            model.cuda()(move((batch,), "cuda")[0])
        message = None
    except ValueError as e:
        message = str(e)
    ok = message is not None and "the kernel takes D in" in message and \
        S.dual_attention_stack.launches == 0
    log(f"[repairs] flag-on BackBone at D 1152 on the card: {message!r}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("repairs: #4 past its limit did not raise the wrapper's ValueError")
    stats["dual_attention_stack D=1152"] = {"raises": message}
    del model
    for name, (kernel, module, inputs) in past_limit_cases().items():
        with torch.no_grad():
            want = module(*inputs)
            zero_counts(kernels)
            got = module.cuda()(*move(inputs, "cuda"))
            torch.cuda.synchronize()
        want = want if isinstance(want, dict) else {"out": first(want)}
        got = got if isinstance(got, dict) else {"out": first(got)}
        err = max((got[k].cpu() - w).abs().max().item() for k, w in want.items()
                  if torch.is_floating_point(w))
        n = kernel.launches
        ok = n == 0 and err <= TOL_F32
        log(f"[repairs] {name}: {n} launches of {kernel.__name__}, card against CPU max abs "
            f"{err:.3e} (tol {TOL_F32})  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"repairs: {name} took the kernel or disagrees with the CPU")
        stats[name] = {"launches": n, "max_abs_err": err}
    stats["ban_bf16"] = ban_bf16(kernels, card)
    return stats


def ban_bf16(kernels, card: str) -> dict:
    """BAN's long config in bf16 (its LSTMs in the input's type, as the JAX
    scan runs them): served (``serve_config``, 64 requests), then
    ``N_BAN_BF16_STEPS`` train steps through ``Trainer``: finite losses, the
    forward's outputs bf16 before the trainer's upcast."""
    from torch.func import functional_call

    from vmrframe_tpu_torch.data.ban_batcher import BANBatcher
    from vmrframe_tpu_torch.ops.precision import cast_batch, cast_params
    from vmrframe_tpu_torch.train.trainer import Trainer

    bf16 = {"train.compute_dtype": "bfloat16"}
    served = serve_config("repairs", BAN_CONFIG, B_BAN, N_BAN_BF16_REQUESTS, 16, kernels, card,
                          bf16)
    cfg, dataset, store, derived = config_world(BAN_CONFIG, bf16, n_train=N_BAN_BF16_STEPS * B_BAN)
    batcher = BANBatcher(dataset["train_set"], store, cfg, derived, "train")
    derived.num_train_steps = derived.steps_per_epoch = len(batcher)
    trainer = Trainer(cfg, derived, dataset["word_vector"], device="cuda")
    batches = [trainer.to_device(b) for b in batcher.epoch(seed=0)]
    with torch.no_grad():  # the trainer's forward before its upcast
        raw = functional_call(trainer.model.eval(), cast_params(trainer.model, torch.bfloat16),
                              (cast_batch(batches[0], torch.bfloat16),))
    times, losses = [], []
    for b in batches[:N_BAN_BF16_STEPS]:
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(b)["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ok = all(math.isfinite(x) for x in losses) and raw["tmap"].dtype == torch.bfloat16
    log(f"[repairs] BAN bf16 ({BAN_CONFIG}, batch {B_BAN}): served {served['qps']:.1f} "
        f"requests/s (p99 {served['p99_ms']:.1f} ms); forward tmap {raw['tmap'].dtype}; "
        f"{len(losses)} train steps, losses {losses}, {times} ms (host clock, the first "
        f"with cuDNN's setup), on {card}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("repairs: BAN's bf16 route is not bf16 or its losses are not finite")
    return {"serve": served, "train_losses": losses, "train_step_ms": times}


PROFILE_BATCH, PROFILE_CHUNK = 512, 256  # chunked_batch_apply's check
PROFILE_BATCHES = (128, 256, 512)  # profile_batch's rows here (the tool's default adds 1024)
PROFILE_LAUNCHES = {"#1": 2.0, "#2": 4.0, "#3": 2.0}  # a SeqPAN eval step, the flag off
FLOOR_SHARE = 0.95  # no operation may read below this share of its floor
BUSY_SHARE = 0.05  # the per-operation times against the busy time


def phase_profile(kernels, card: str) -> dict:
    """The profiling and roofline tools at one or two reps, SeqPAN at
    Charades width: ``ops/chunked.py`` at B 512 in chunks of 256 (f32)
    against the direct call (logits within ``TOL_F32``, spans equal);
    ``roofline``'s probes and its row at B 128; ``trace_profile`` of the
    bf16 eval step at B 128 (2/4/2 launches of #1/#2/#3 a step, the
    operations' times summing to the busy time within 5%);
    ``roofline_trace`` on the two (no operation below 0.95 of its floor);
    ``profile_batch``'s rows at chunk 0 and 256; ``profile_seqpan``'s
    blocks; ``profile_model``'s SeqPAN pieces (``check_profile_model`` holds
    their GFLOP to the zoo phase's)."""
    from vmrframe_tpu_torch.ops.chunked import chunked_batch_apply
    from vmrframe_tpu_torch.tools import (profile_batch, profile_model, profile_seqpan,
                                          roofline, roofline_trace, trace_profile)

    stats = {}
    fwd, batch, _, ev = roofline.seqpan_eval(PROFILE_BATCH, "cuda", dtype="float32")
    direct, chunked = fwd(batch), chunked_batch_apply(fwd, batch, PROFILE_BATCH, PROFILE_CHUNK)
    err = max((chunked[k] - direct[k]).abs().max().item() for k in ("slogits", "elogits"))
    same = torch.equal(chunked["props"], direct["props"])
    log(f"[profile] chunked_batch_apply at B {PROFILE_BATCH}, chunk {PROFILE_CHUNK}, f32: "
        f"logits max abs diff {err:.3e} (tol {TOL_F32}), spans equal {same}  "
        f"{'ok' if err <= TOL_F32 and same else 'FAIL'}")
    if err > TOL_F32 or not same:
        raise SmokeFailure("profile: chunked_batch_apply disagrees with the direct call")
    stats["chunked"] = {"max_abs_err": err, "spans_equal": same}
    del fwd, batch, ev, direct, chunked
    torch.cuda.empty_cache()

    probes = roofline.probes("cuda")
    stats["probes"] = {"hbm_best_bytes_per_s": probes["hbm"]["best_bytes_per_s"],
                       "hbm_largest_bytes_per_s": probes["hbm"]["largest_buffer_bytes_per_s"],
                       "launch_ms": probes["launch"]["ms_per_kernel"],
                       "chain_bytes_per_s": probes["chain"]["best_bytes_per_s"],
                       "points": probes["hbm"]["points"],
                       # the probes the profiler saw nothing of, timed by CUDA events
                       "timed_by_cuda_events": [
                           f"{kind} of {size} bytes"
                           for size, rates in probes["hbm"]["by_buffer_size"].items()
                           for kind, rate in rates.items() if rate["timer"] != "profiler"]}
    stats["roofline"] = roofline.roofline_row(128, probes, "cuda", steps=5, reps=1)
    log(f"[profile] roofline probes {json.dumps(stats['probes'])}; SeqPAN eval B 128 "
        f"{json.dumps(stats['roofline'])}, on {card}")

    fwd, batch, _, ev = roofline.seqpan_eval(128, "cuda")
    trace = trace_profile.trace(lambda: fwd(batch), "cuda", steps=5, reps=1)
    del fwd, batch, ev
    launches = {k: trace["kernel_launches_per_step"][k] for k in PROFILE_LAUNCHES}
    busy, ops_ms = trace["device_busy_ms_per_step"], trace["ops_ms_per_step"]
    rt = roofline_trace.decompose(trace, probes["hbm"])
    stats["trace"] = {k: trace[k] for k in ("step_ms", "device_busy_ms_per_step",
                                            "device_ops_per_step", "profile_passes",
                                            "ops_ms_per_step",
                                            "by_category", "kernel_launches_per_step")}
    stats["trace"]["top_sinks"] = trace_profile.top_sinks({"rows": trace["rows"]})
    stats["roofline_trace"] = {k: v for k, v in rt.items() if k not in ("groups", "unjoined")}
    stats["roofline_trace"]["top_groups"] = rt["groups"][:12]
    log(f"[profile] trace_profile SeqPAN eval B 128 bf16: {json.dumps(stats['trace'])}")
    log(f"[profile] roofline_trace: {json.dumps(stats['roofline_trace'])}")
    if launches != PROFILE_LAUNCHES:
        raise SmokeFailure(f"profile: trace_profile saw {launches} a step, want {PROFILE_LAUNCHES}")
    if abs(ops_ms - busy) > BUSY_SHARE * busy:
        raise SmokeFailure(f"profile: per-operation times sum to {ops_ms} ms, busy {busy} ms")
    if rt["below_floor"]:
        raise SmokeFailure("profile: operations below 0.95 of their floor: "
                           + json.dumps([{k: g[k] for k in ("op", "shapes", "category",
                                                            "ms_per_step", "floor_ms")}
                                         for g in rt["below_floor"][:8]]))

    stats["profile_batch"] = [row for chunk in (0, PROFILE_CHUNK) for row in
                              profile_batch.batch_rows(PROFILE_BATCHES, "cuda", chunk, steps=3,
                                                       reps=1, log=lambda s: None)]
    log(f"[profile] profile_batch: {json.dumps(stats['profile_batch'])}")
    stats["profile_seqpan"] = profile_seqpan.profile_blocks("cuda", 128, steps=3, reps=1,
                                                            log=lambda s: None)
    log(f"[profile] profile_seqpan: {json.dumps(stats['profile_seqpan'])}")
    pm = profile_model.profile("SeqPAN", "cuda", steps=1, reps=1, log=lambda s: None)
    stats["profile_model"] = pm
    log(f"[profile] profile_model SeqPAN: {json.dumps(pm['pieces'])}")
    return stats


def check_profile_model(pm: dict, zoo_seqpan: dict) -> None:
    """``profile_model``'s GFLOP of SeqPAN's train step and eval step equal
    ``bench_zoo``'s row of the zoo phase."""
    want = {"full_train": zoo_seqpan["train_flops"], "eval_step": zoo_seqpan["eval_flops"]}
    got = {k: pm["pieces"][k]["gflop"] * 1e9 for k in want}
    ok = all(abs(got[k] - want[k]) <= TOL_FLOPS * want[k] for k in want)
    log(f"[zoo] profile_model's SeqPAN FLOPs {got} against the zoo row's {want}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"profile: profile_model's FLOPs {got}, the zoo's {want}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the full record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    from vmrframe_tpu_torch.kernels import attention as K
    from vmrframe_tpu_torch.kernels import dual_stack as S
    from vmrframe_tpu_torch.kernels import window_attention as W

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    kernels = K.KERNELS + S.KERNELS + W.KERNELS
    fns = functions(K, W, S)
    g = torch.Generator(device="cuda").manual_seed(0)
    time_cases, weights, long_cases, f32_cases, sentence_cases, blocks = table_cases(g)
    cases = {name: time_cases[name] for name in ATTENTION + (STACK,)}
    wide = wide_stack_cases(g)  # #4 at D 256-1024: 4 heads at Charades lengths
    wide_check = [case for _, _, _, case in wide] + [
        case + (STACK_CHECK_HEADS,) for _, _, blocks, _ in wide
        for case in stack_cases(g, blocks, ((3, LV, LT),))] + [
        empty_to_side_case(g, blocks) for dim, _, blocks, _ in wide if dim == WIDER_DIM]
    odd_hd = lambda make: [c for hd in AF_CHECK_HD for c in make(hd)]  # noqa: E731
    check_cases = {**cases, **{name: cases[name] + long_cases[name] + sentence_cases[name]
                               for name in ATTENTION},
                   "banded_attention": banded_cases(g, AF_CHECK_T)
                   + odd_hd(lambda hd: banded_cases(g, (1000,), hd=hd)),
                   STACK: cases[STACK] + stack_cases(g, blocks, STACK_CHECK_SHAPES[1:])
                   + long_cases[STACK] + [case + (STACK_CHECK_HEADS,) for case in stack_cases(
                       g, blocks, ((3, LV, LT),))] + wide_check}
    bwd_check = banded_bwd_cases(g, AF_CHECK_T) + odd_hd(
        lambda hd: banded_bwd_cases(g, (1000,), hd))
    for name in BWD_KERNELS:  # the two backward kernels share their cases
        check_cases[name] = bwd_check
    record, seconds = {"card": card}, {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        log(f"[{name}] phase took {seconds[name]:.1f} s")
        return out

    record["build"] = phase("build", phase_build)
    record["check"] = phase("check", phase_check, fns, check_cases)
    record["time"] = phase("time", time_kernels, fns, time_cases, weights, card, long_cases,
                           f32_cases, sentence_cases)
    # free the long grids, the odd head dims and the f32 rows: the serve
    # phases' peak memory stays comparable
    for name in ATTENTION + (STACK,):
        check_cases[name] = cases[name]
    for name in ("banded_attention",) + BWD_KERNELS:
        check_cases[name] = check_cases[name][:len(AF_CHECK_T)]
    del long_cases, f32_cases, bwd_check, sentence_cases, wide_check
    time_module_path(blocks, cases[STACK][0], record["time"], card)
    time_wide_stack(fns, wide, record["time"], card)
    del wide
    # the profiling tools before the serve phases, in a process whose
    # profiler has recorded nothing yet
    record["profile"] = phase("profile", phase_profile, kernels, card)
    record["serve"], dataset, store, derived, cfg = phase("serve", phase_serve, kernels, card)
    record["verify"] = phase("verify", phase_verify, cfg, derived, dataset, store)
    record["verify_long"] = phase("verify-long", phase_verify_long)
    record["serve_af"], service, af_data, af_cfg = phase("serve-AF", phase_serve_af, kernels, card)
    record["verify_af"] = phase("verify-AF", phase_verify_af, service, af_data, af_cfg)
    del service  # its model leaves the card before training measures its peak memory
    torch.cuda.empty_cache()
    record["train_af"] = phase("train-AF", phase_train_af, W, card)
    record["verify_train_af"] = phase("verify-train-AF", phase_verify_train_af, W)
    record["serve_stack"], _, _, _, cfg_stack = phase("serve-stack", phase_serve, kernels, card,
                                                      True)
    compare_serving(record["serve"], record["serve_stack"])
    record["verify_stack"] = phase("verify-stack", phase_verify, cfg_stack, derived, dataset,
                                   store, "verify-stack")
    record["verify_stack_long"] = phase("verify-stack-long", phase_verify_long, True)
    record["verify_stack_wide"] = phase("verify-stack-wide", phase_verify_wide)
    record["verify_stack_heads"] = phase("verify-stack-heads", phase_verify_heads)
    record["verify_stack_wider"] = phase("verify-stack-wider", phase_verify_wider)
    record["serve_router"] = phase("serve-router", phase_serve_router, kernels, card)
    record["train_seqpan"] = phase("train-SeqPAN", phase_train_seqpan, K, S, card)
    record["verify_train_seqpan"] = phase("verify-train-SeqPAN", phase_verify_train_seqpan, K, S)
    with tempfile.TemporaryDirectory() as root:  # the dataset files, checkpoints and caches
        record["train_files"], config, best, predictions = phase(
            "train-files", phase_train_files, K, S, card, root)
        record["serve_files"] = phase("serve-files", phase_serve_files, kernels, card, config,
                                      best, predictions)
        record["pipeline"] = phase("pipeline", phase_pipeline, K, S, card, config)
        record["distill"] = phase("distill", phase_distill, K, S, card, root, config, best)
    record["verify_train_distill"] = phase("verify-train-distill", phase_verify_train_distill,
                                           K, S)
    record["sentence"] = phase("sentence", phase_sentence, K, S, card)
    record["backbone_af"] = phase("backbone-af", phase_backbone_af, K, S, W, card)
    record["af_rest"] = phase("af-rest", phase_af_rest, W)
    record["serve_ban"] = phase("serve-BAN", phase_serve_ban, kernels, card)
    record["verify_ban"] = phase("verify-BAN", phase_verify_ban)
    with tempfile.TemporaryDirectory() as root:  # the BAN checkpoint, the student's run
        record["train_ban"] = phase("train-BAN", phase_train_ban, kernels, card, root)
        record["ban_pretrain"] = phase("ban-pretrain", phase_ban_pretrain, kernels, card,
                                       record["train_ban"]["best_path"])
    record["repairs"] = phase("repairs", phase_repairs, kernels, card)
    record["serve_cca"] = phase("serve-CCA", phase_serve_cca, kernels, card)
    record["verify_cca"] = phase("verify-CCA", phase_verify_cca)
    with tempfile.TemporaryDirectory() as root:  # the CCA checkpoint, its curves
        record["train_cca"] = phase("train-CCA", phase_train_cca, kernels, card, root)
        record["cca_pretrain"] = phase("cca-pretrain", phase_cca_pretrain, kernels, card,
                                       record["train_cca"]["best_path"])
    record["serve_cpl"] = phase("serve-CPL", phase_serve_cpl, kernels, card)
    record["verify_cpl"] = phase("verify-CPL", phase_verify_cpl)
    with tempfile.TemporaryDirectory() as root:
        record["train_cpl"] = phase("train-CPL", phase_train_cpl, kernels, card, root)
    record["zoo"] = phase("zoo", phase_zoo, card)
    check_profile_model(record["profile"]["profile_model"], record["zoo"]["SeqPAN"])
    record["sweep"] = phase("sweep", phase_sweep, card)
    record["convert"] = phase("convert", phase_convert, K.KERNELS + S.KERNELS)
    with tempfile.TemporaryDirectory() as root:  # torchrun's checkpoints
        record["ddp"] = phase("ddp", phase_ddp, K, S, card, root)
    record["seconds"] = seconds
    # the main path each kernel's launches are read from, and the type of the
    # numbers in its line: the serve phases run bf16, training the YAML's f32
    main_path = {fn.__name__: "serve" for fn in K.KERNELS}
    main_path["banded_attention"], main_path[STACK] = "serve_af", "serve_stack"
    line_dtype = {fn.__name__: "bf16" for fn in kernels}
    for name in BWD_KERNELS:
        main_path[name], line_dtype[name] = "train_af", "f32"

    out = []
    for fn in kernels:
        name = fn.__name__
        key = line_dtype[name]
        t, c = record["time"][name][key], record["check"][name]
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[SOURCE_OF[name]],
            "replaces": REPLACES[name],
            "launches": record[main_path[name]]["launches"][name],
            "max_abs_err": c[key]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "dtype": {"bf16": "bfloat16", "f32": "float32"}[key], "tol": c[key]["tol"],
            "max_abs_err_f32": c["f32"]["max_abs_err"],
            "max_abs_err_bf16": c["bf16"]["max_abs_err"],
            "card": card,
        })
        if name in ATTENTION:  # a SeqPAN train step at droprate 0
            out[-1]["launches_per_train_step"] = \
                record["train_seqpan"]["droprate_0"]["launches_per_step"][name]
        if name in ATTENTION + (STACK,):  # the distillation path: OneTeacher_SoftLabel
            out[-1]["launches_distill_eval"] = record["distill"]["eval_launches"][name]
            out[-1]["launches_per_distill_train_step"] = \
                record["distill"]["droprate_0"]["launches_per_step"][name]
            # the sentence variants and BackBoneActionFormer, per served forward
            out[-1]["launches_per_sentence_forward"] = {
                route: burst["launches_per_forward"][name]
                for route, burst in record["sentence"]["serve"]["bursts"].items()}
            out[-1]["launches_per_backbone_af_forward"] = \
                record["backbone_af"]["serve"]["bursts"]["backbone_af"][
                    "launches_per_forward"][name]
        # the zoo's rows (tools/bench_zoo.py), per train and eval step
        out[-1]["launches_per_zoo_step"] = {
            row: {mode: res[f"{mode}_launches_per_step"][name] for mode in ("train", "eval")}
            for row, res in record["zoo"].items()}
        # CCA and CPL run no hand-written kernel: their served forwards and
        # train steps (0 each, checked by their phases)
        out[-1]["launches_cca_cpl"] = {
            key: record[key]["launches"][name]
            for key in ("serve_cca", "train_cca", "serve_cpl", "train_cpl")}
        if "module_path_ms" in t:  # the other route to the same result, not a library call
            out[-1]["module_path_ms"] = t["module_path_ms"]
        if name == STACK:  # D 256-1024 at Charades lengths, outside the means
            out[-1]["wide_shapes"] = {
                k: [{"shape": r["shape"], "ms": r["ms"]["median"], "bound_ms": r["bound_ms"],
                     "module_path_ms": r["module_path_ms"]}
                    for r in record["time"][name][k]["wide_shapes"]]
                for k in ("bf16", "f32")}
        if name in ATTENTION:  # TACoS width and the sentence variants' shapes, outside the means
            for extra in ("long_shapes", "sentence_shapes"):
                out[-1][extra] = {
                    k: [{"shape": r["shape"], "ms": r["ms"]["median"], "bound_ms": r["bound_ms"],
                         "library_ms": r["library_ms"]["median"] if r["library_ms"] else None}
                        for r in record["time"][name][k][extra]]
                    for k in ("bf16", "f32")}
        if key == "bf16" and "f32" in record["time"][name]:
            out[-1]["ms_f32"] = record["time"][name]["f32"]["ms"]
            out[-1]["bound_ms_f32"] = record["time"][name]["f32"]["bound_ms"]
            out[-1]["library_ms_f32"] = record["time"][name]["f32"]["library_ms"]
    record["kernels"] = out
    print(json.dumps({"profile_batch": record["profile"]["profile_batch"], "card": card}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
