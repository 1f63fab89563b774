#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``textocvp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's 01 CLIs, its two serving paths and dynamic request
batching, its 05 evaluate-predictor path, its 02 train path, its 03
evaluate-decomposition path on the SAVi that 02 trained, its 04
predictor-train path, the 06 figure CLIs on both, the four other
predictors' 05, 04 and serving paths and the CLIPort chain (02, 04, 05, 03
and 06 on ExtendedDINOSAUR) at full width with random weights drawn from a
seed, and checks them:

* CATER: SAVi (8 slots x 128, 64x64 frames) + TextOCVP_T5 (T5-small, 8
  predictor layers), 19 predicted frames;
* CLIPort: ExtendedDINOSAUR (DINOv2 ViT-B/14, 12 blocks, at 336 px; 10 slots
  x 128; MLP patch decoder and BatchNorm CNN head) + TextOCVP_T5, 9 predicted
  frames;
* eval: the CATER model under the 05 protocol, B=64, 1 seed frame, 19
  predicted frames, PSNR/SSIM/LPIPS, over a temporary CATER ``.npy`` set;
* train: the CATER SAVi under the 02 ``DecompTrainer`` at B=64, T=8 (Adam,
  lr 1e-4, warmup 2000, cosine, clip 0.05, ``mse``), over a temporary CATER
  ``.npy`` train set;
* pred_train: TextOCVP_T5 (T5-small, 8 layers, token 512) under the 04
  ``PredictorTrainer`` at B=64, c=1, p=9, buffer 10, through the frozen SAVi
  that the train path wrote (Adam, lr 1e-4, warmup 2000, cosine, clip 0.05,
  ``pred_img_mse`` + ``pred_slot_mse``), over the same ``.npy`` set;
* CLIPort chain: the ExtendedDINOSAUR above under the 02 ``DecompTrainer`` at
  B=64, T=8, ``accum_steps`` 8 (Adam, lr 1e-4, warmup 2000, cosine, clip
  0.05, ``pred_feature_mse`` + ``mse``; the ViT frozen), TextOCVP_T5 through
  it under the 04 ``PredictorTrainer`` at B=64, c=1, p=9, ``accum_steps`` 8,
  and the 05 protocol on that predictor at B=16, 1 seed frame, 9 predicted
  frames, over a temporary CLIPort color-cache set (64 train, 16 val and 32
  test episodes of 12 frames at 336 x 336, coloured blocks over a shaded
  table, about 450 MB).

* 03: the decomposition model a user evaluates first
  (``scripts/03_evaluate_decomp_{CATER,CLIPort}.sh``): the 01 CLI's
  experiment, the 02 phase's checkpoint dropped into its ``models/`` under
  the released name (``SAVi_CATER``, ``ExtendedDINOSAUR_CLIPort``), the 03
  CLI at B=64 (CATER, 128 test videos) and B=16 (CLIPort, 32 test
  episodes), T=8, ``--results_name results_DecompModel``.

Phases, one JSON line each:

1. device   the card's name and power limit (``nvidia-smi``);
2. build    compile the three CUDA kernels from ``csrc/``, one ``nvcc`` each, at
            once; print each library's ``ptxas -v`` report and its count of
            tensor-core instructions (``cuobjdump -sass``), which must not be
            0 for conv5 and the ViT attention;
3. kernels  slot attention against its plain PyTorch version at the CATER
            shape (N=4096, S=8, MLP 256, B in (1, 8, 64)) and the CLIPort shape
            (N=576, S=10, MLP 512, B in (1, 8, 16): a 06 sequence's frame, a
            request and the 02 and 04 microbatches, the valid batches and the
            05 batch), 1 and 3
            iterations, each call's
            device kernels counted under ``torch.profiler`` (one cluster
            launch, ``slot_attention_cluster_kernel``) and timed with the card
            held busy while the host enqueues (the kernel's own time, not
            the wrapper's host time per call); the ViT attention
            against its plain version at (B, 12, 577, 64) for each B of
            ``VIT_BATCHES``, the frames of one ViT call on the main paths (8 a
            request or a 06a sequence, 16 the 05 seed frames, 64 and 80 the 02
            and 04 microbatches, 128 and 160 their valid batches, 1 the 06b
            seed frame), with
            ``F.scaled_dot_product_attention`` timed as a yardstick; conv5
            against its plain version at N=8, 64 and 152 (a 06 sequence's
            seed, its 8 frames, its 19 predictions), N=1216 (a CATER request)
            and N=9728 (an eval batch) maps of 64x64x64, with
            ``F.conv2d`` + ReLU (cuDNN, TF32 off) timed as a yardstick. Max abs
            error, time from CUDA events, the plain version's time, the bound
            (for conv5 and the ViT attention, which run 3xTF32 products on the
            tensor cores, the 3xTF32 bound, with the float32 CUDA-core bound
            beside it as ``bound_ms_fp32_cores``). The backward: conv5's
            autograd Function against autograd through its plain version at
            N=1216 and N=4096 (the train step), the input gradient's launch of
            the kernel, the weight gradient and cuDNN's
            ``convolution_backward`` timed apart; the slot-attention Function's
            gradients against the plain version's at B=64, N=4096 and at the
            CLIPort 02 microbatch's B=8, N=576, S=10, MLP 512, 1 and 3
            iterations, and its backward's time; conv5's Function behind
            frozen weights at the predictor step's N=4608 (one forward and one
            input-gradient launch, no weight gradient), its input gradient
            against the plain version's and both launches timed. Gradients are
            held to 1e-4 of the reference's largest value;
then
C. create   the 01 CLIs: a SAVi / CATER_Easy and an ExtendedDINOSAUR /
            CLIPort experiment (``--name``), each ``experiment_params.json``
            equal to ``build_exp_params``; a TextOCVP_T5 experiment under the
            first refused while its ``models/`` is empty, then made with
            ``--skip_ckpt_check``, its params equal to ``add_predictor_params``;

then for each serving path:
4. parity   the predict stage (seed encode + rollout) on the card and on the
            CPU with the same weights and initial slots, TF32 off, each
            rollout step's error held to that step's largest slot; and the
            decode of the same frames on both;
5. service  a ``PredictionService`` (batch 8, 24 tokens) over a temporary
            experiment of ``.pt`` checkpoints: warmup, three requests (8 rows
            float32, 3 rows uint8, 8 rows), five more 8-row requests for the
            steady time, and one request split into its two stages; each
            request launches each kernel as often as its path says;
6. http     ``/healthz``, one ``/predict`` and ``/stats`` on 127.0.0.1;
7. profile  one more request under ``torch.profiler``: device busy time
            against wall time, the kernels that take the most time, and the
            port's kernels' own launches and time inside the request, with
            exactly one slot-attention device kernel;
then on the CATER path's experiment:
S. serve_batching  a ``PredictionService`` at batch 8 behind
            ``serve/batching.py::DynamicBatcher``: two one-row requests
            coalesced into one batch equal, bit for bit, a direct two-row
            predict from the same generator state; then 32 one-row HTTP
            requests from 16 client threads with batching off, at a 20 ms
            window with one dispatcher and with two: requests/s, the clients'
            p50 and p95 ms, the device batches and their mean fill, every
            reply's shape.

then the eval path:
8. eval_parity  the eval step at B=2 on the card and on the CPU, the same
            weights, initial slots and frames: framewise PSNR within 1e-3 dB,
            SSIM and LPIPS within 1e-4;
9. eval     ``textocvp_tpu_torch.cli.evaluate_predictor.main`` at B=64 over
            128 videos (two batches): finite means, 19 framewise values a
            metric, 1 slot-attention call and 3 conv5 launches a batch;
10. eval_step one more B=64 batch split into its stages (predict, decode,
            metrics) with the peak memory, and one step under ``torch.profiler``
            with exactly one slot-attention device kernel.

then the train path:
11. train_parity  DecompTrainer on the card and on the CPU at full width,
            B=2, T=3, the same weights, video and slot noise, warmup off, the
            CPU with the card's ReLU masks of the decoder-tail convs and of
            each ``MLP``'s hidden layers (its own-mask result reported):
            the loss (1e-5 relative), every gradient leaf (1e-4 of the leaf's
            largest value) and the buffers after one step, the loss and the
            parameters after two;
12. train   ``textocvp_tpu_torch.cli.train_decomp.main`` at B=64, T=8 over 320
            training videos (5 steps after one B=64 valid batch): finite
            losses, ``checkpoint_last_saved.pt`` and
            ``checkpoint_epoch_final.pt``, 8 slot-attention calls and 3 conv5
            forward and 3 input-gradient launches a step; then
            ``--resume_training`` from ``checkpoint_last_saved`` runs a second
            epoch from the saved step;
13. train_step  the steady B=64 step on the host clock, split into forward,
            backward and optimizer, its peak memory and launches, and one
            step under ``torch.profiler``;
14. train_sign  20 steps on one batch of 8 at lr 4e-4: the loss falls.

then the 03 path on CATER, over phase C's SAVi experiment with phase 12's
``checkpoint_epoch_final.pt`` as ``models/SAVi_CATER.pt`` and the eval
path's 128 test videos:
D1. decomp_eval_parity  the 03 step (all T frames decomposed, all B x T
            decoded) at B=2, T=8 on the card and on the CPU, the same weights,
            initial slots and frames: reconstructions within 1e-4 of their
            largest value, framewise PSNR within 1e-3 dB, SSIM and LPIPS
            within 1e-4;
D2. decomp_eval  ``textocvp_tpu_torch.cli.evaluate_decomp.main`` at B=64:
            finite means, 8 framewise values a metric, 8 slot-attention calls
            and 3 conv5 launches a batch; then one batch's steady step on the
            host clock (reconstructed frames/s = 512 / step), split into its
            stages, its peak memory, and one step under ``torch.profiler``.

then the predictor-train path, over the experiment that phase 12 trained:
15. pred_train_parity  PredictorTrainer on the card and on the CPU at full
            width, B=2, c=1, p=2 (``PARITY_PREDS``), the same weights, video, captions and slot noise,
            warmup off, the CPU with the card's ReLU masks as in phase 11
            (its own-mask result reported): the loss (1e-5 relative) and every
            trainable gradient leaf (1e-4 of its largest value) after one
            step, the loss and the parameters after two;
16. pred_train  ``textocvp_tpu_torch.cli.train_predictor.main`` at B=64 over
            the phase-12 set (5 steps after one valid batch), its frozen SAVi
            phase 12's ``checkpoint_epoch_final.pt``: finite losses, the
            checkpoints, 10 slot-attention calls, 3 conv5 forward and 3
            input-gradient launches and no conv5 weight gradient a step, no
            ViT launch; then ``--resume_training`` for a second epoch, and the
            05 CLI on the predictor's ``checkpoint_epoch_final``: finite
            means, 19 framewise values;
17. pred_train_step  the steady B=64 step on the host clock, split into
            frozen encode, forward, backward and optimizer, its peak memory
            and launches, and one step under ``torch.profiler`` with one
            slot-attention device kernel a call;
18. pred_train_sign  20 steps on one batch of 8 at lr 1e-4: the loss falls;
F1. figs_parity  06b's figures of one sequence at p=3 on the card and on the
            CPU with the same initial slots: every array a figure writer is
            handed within 1e-4 of the largest value it or the decoded
            predictions (before their clip to [0, 1]) hold, the two
            argmax-coloured GIFs' frames on all but 1e-3 of their pixels;
            each rollout step's slots and the decode of the same slots on
            both devices reported beside;
F2. figs    the 06 CLIs (``cli/generate_figs_decomp.py`` on phase 12's
            SAVi, ``cli/generate_figs_predictor.py`` on phase 16's
            TextOCVP_T5 at c=1, p=19), two sequences each: every figure and
            GIF of each sequence decoded at its size and frame count, the 06b
            directories' PSNR and LPIPS the generator's, the seconds a
            sequence and each kernel's launches.

then the four other predictors (VanillaTransformer, OCVPSeq, OCVPPar:
token 128, hidden 256, 2 layers, 4 heads; TextOCVP_CustomTF: token 512, 8
layers, its text encoder 128 wide with 2 layers over CustomTokenizer ids),
each through phase 12's frozen SAVi, c=1, buffer 10, every line carrying
``"predictor"``:
P1. predictors_parity  a random predictor's 19-step rollout on the card and
            on the CPU at B=2, the same weights, slots and captions: each
            step within 1e-4 of its largest slot;
P2. predictors_eval, predictors_eval_step  the 05 CLI at B=64, p=19 over
            the eval phase's 128 videos (random weights drawn as phase 4
            does): finite means, 19 framewise values a metric, 1
            slot-attention call and 3 conv5 launches a batch; then one more
            batch split into its stages, its peak memory, and one step under
            ``torch.profiler``;
P3. predictors_service  (OCVPSeq and TextOCVP_CustomTF) a
            ``PredictionService`` at batch 8 with 19 predictions: warmup and
            three requests (8 rows float32, 3 rows uint8, 8 rows), 1 / 3
            launches a request; CustomTF refuses an out-of-vocabulary word;
P4. predictors_train_parity  PredictorTrainer at B=2, p=2 on the card and on
            the CPU as phase 15, also with the card's masks of the torch-style
            feed-forward ReLUs; the attention key biases are exact-zero
            leaves;
P5. predictors_train, predictors_train_step  the 04 CLI at B=64, c=1, p=9,
            2 steps after one valid batch over a set of 128 + 64 videos: the
            launches of phase 16, the checkpoints, a resumed epoch, the 05
            CLI on its checkpoint; then the steady step split and profiled
            as phase 17.

then the CLIPort chain, over the color-cache set:
19. clip_train_parity  DecompTrainer on ExtendedDINOSAUR on the card and on
            the CPU at full width, B=2, T=3, as phase 11, the CPU with the
            card's masks (every ReLU on the gradient's path, the slot-attention
            MLP's from the card's recompute, the loss's clips); the BatchNorm
            statistics after the first step (1e-5), the ViT bit for bit;
20. clip_train  the 02 CLI at B=64, T=8, ``accum_steps`` 8: two epochs of
            one step after a B=16 valid batch, then ``--resume_training`` for a
            third; 8 slot-attention calls and 12 ViT-attention launches a
            (micro)batch, the checkpoints hold the ViT and the statistics;
21. clip_train_step  the steady step on the host clock, split into forward,
            backward (each summed over the microbatches) and optimizer, its
            peak memory, launches, and one step under ``torch.profiler``;
22. clip_train_sign  10 steps on one batch of 8 at lr 1e-6: the loss falls;
23. clip_pred_train_parity, clip_pred_train, clip_pred_train_step,
            clip_pred_train_sign  the same for the 04 step through the frozen
            ExtendedDINOSAUR of phase 20 (B=64, c=1, p=9, ``accum_steps`` 8;
            one epoch, then a resume; 10 slot-attention calls and 12
            ViT-attention launches a microbatch; the parity at p=2);
24. clip_eval_parity  the eval step at B=2 on the card and on the CPU, on
            phase 23's checkpoint, as phase 8;
25. clip_eval  the 05 CLI at B=16, 1 seed frame, 9 predictions over the 32
            test episodes (two batches): finite means, 9 framewise values a
            metric, 1 slot-attention call and 12 ViT-attention launches a batch;
26. clip_eval_step  one more B=16 batch split into its stages, and one step
            under ``torch.profiler``;
27. clip_decomp_eval_parity, clip_decomp_eval  phases D1 and D2 on phase C's
            ExtendedDINOSAUR experiment with phase 20's checkpoint as
            ``models/ExtendedDINOSAUR_CLIPort.pt``: the parity at B=2, T=3
            (the ViT on the CPU), the 03 CLI at B=16 over the 32 test
            episodes, 8 slot-attention calls, 12 ViT-attention launches and
            no conv5 launch a batch;
28. clip_figs  phase F2 on the CLIPort chain's ExtendedDINOSAUR (phase 20)
            and TextOCVP_T5 (phase 23, p=9), one sequence each, its objects
            and masks at 96 px.

and the host input and the trainers' extras:
H1. host_io  what the machine offers the host input path (``native.host_io``:
            the compiler, the build against zlib, PIL, imageio and ffmpeg,
            tensorboard), the ``native/imgio.cpp`` build and its
            seconds, the C++ resize against ``resize_bilinear_plain`` on
            320 x 240 -> 64 x 64 and 640 x 480 -> 336 x 336 frames and PNGs
            of the stdlib writer (rows through filter types 0-4) decoded back,
            bit for bit; decode plus resize in frames/s on 1 thread and 8;
H2. png_eval  (after phase 10) the CATER 05 CLI at B=64, p=19 over 64
            frame-directory videos of 21 PNG frames at 320 x 240 (8 loader
            threads), then over the ``.npy`` caches ``cli/make_npy_cache.py``
            builds from them: the same items bit for bit and the same
            ``results.json``; the loader's frames/s against the step's
            demand, and the device's idle share of a loader pass and its step;
H3. train_extras, train_remat  (after phase D2) the 02 CLI on CATER (B=16,
            2 steps) with ``tpu.async_checkpoint`` and ``TEXTOCVP_PROFILE``:
            ``logs.txt``, the Chrome trace with the slot-attention and conv5
            kernels, the checkpoints equal to the trainer's state,
            TensorBoard's event files where ``tensorboard`` imports; one CATER
            02 step (B=64, T=8) and one 04 step (B=64, c=1, p=9), each
            without and with ``tpu.remat``: ms, peak GB and the largest
            gradient difference over the largest leaf (held to
            REMAT_TOLERANCE);
H4. clip_remat, clip_png_eval  (after phase 27) one CLIPort 02 microbatch of
            8 without and with remat (ms, peak GB, gradient difference);
            one CLIPort 04 microbatch of 16 (``accum_steps`` 4) with remat,
            its peak; the CLIPort 05 CLI at
            B=16, p=9 over 16 test episodes of 12 PNG frames at 640 x 480
            without a cache, against the cache route as H2.

The trainers' CLI runs add one TensorBoard image strip an epoch where
``tensorboard`` imports (``Trainer.image_strips``), and their launch counts
count it. The 03 and 05 CLI runs' phases check that each metric's
``<metric>_framewise.png`` lies beside ``results.json`` and decodes.
Phases 5 and 6 are a serving path's main path, phase 9 the eval path's, H2's
and H4's PNG runs the PNG routes',
phase 12's first run the train path's, the 03 CLI runs of D2 and 27 the
03 paths', S's HTTP runs the batching path's, the 06 CLI runs of F2 and 28
the 06 paths', phase 16's first run the
predictor-train path's, P2's and P5's CLI runs and P3 the other predictors'
paths, and the first runs of the CLIs of phases 20, 23 and 25 the CLIPort
chain's three: every kernel's launch counter (and conv5's input-gradient
launches and weight-gradient calls) is set to 0 before it and read after.
Every phase's line carries ``phase_s``, the seconds since the line before. Every trace under ``torch.profiler`` is taken whole
(``traced``: device spins before and after the call, and taken again behind
a longer spin when the profiler dropped the trace's first records), and the
port's device kernels in it are counted exactly. Then one
``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
not 0 and the last line is not printed. Without a CUDA device the script
exits 2 before doing anything.
"""

from __future__ import annotations

import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

SEED = 14
BATCH, MAX_TOKENS = 8, 24
PRED_OUT_SCALE = 0.02
ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
TF32X3_PRODUCTS = 3        # TF32 products per float32-accurate product (csrc/tf32x3.cuh)
TENSOR_CORE_KERNELS = ("conv5", "vit_attention")
VIT_HEADS, VIT_TOKENS, VIT_DH = 12, 577, 64  # DINOv2 ViT-B/14 at 336 px
CONV5_RES, CONV5_CH = 64, 64                 # SAVi decoder tail on CATER
EVAL_BATCH, EVAL_PREDS, EVAL_VIDEOS = 64, 19, 128
TRAIN_BATCH, TRAIN_FRAMES = 64, 8                  # bench_train.py's flagship step
TRAIN_VIDEOS, TRAIN_VALID_VIDEOS = 5 * TRAIN_BATCH, TRAIN_BATCH  # 5 steps, 1 valid batch
GRAD_TOLERANCE = 1e-4  # gradients: max abs error over the reference's max |value|
# remat's gradients against the plain step's, over the largest leaf, a
# step: limits a little above the H100 readings in PERF.md (02: 4.4e-6 to
# 5.0e-6, the decoder's final conv's weight gradient summed over 8 regions of
# frames, where the plain step differs from itself by 1.1e-7; 04: 6.5e-7 to
# 8.3e-7)
REMAT_TOLERANCE = {"02": 1e-5, "04": 2e-6}
PRED_NAME = "textocvp_t5"
PRED_CONTEXT, PRED_PREDS = 1, 9          # the 04 defaults (core/config.py DEFAULTS)
PRED_FRAMES = PRED_CONTEXT + PRED_PREDS  # frames of a predictor-training clip
# predictions of a 04 parity step: it runs at B=2 on the CPU twice (its own
# masks and the card's) at full width, the decode of every predicted frame
# and its backward most of that time; at p=9 the six 04 parities took 554 s
# of a 1318 s run, at p=3 186 s of a 1048 s one (an H100 80GB HBM3 at 700 W
# and its host)
PARITY_PREDS = 2
PRED_TAIL_N = TRAIN_BATCH * PRED_PREDS * 8  # slot maps through the decoder tail a step
CLIP_RES, CLIP_PATCHES, CLIP_SLOTS, CLIP_SLOT_DIM = 336, 576, 10, 128  # ExtendedDINOSAUR
CLIP_TRAIN_BATCH, CLIP_FRAMES = 64, 8   # configs/datasets/CLIPort.json, the 02 batch
CLIP_ACCUM = 8                          # docs/TRAIN.md's accum_steps for ExtendedDINOSAUR
CLIP_EPISODES = (("train", 64), ("val", 16), ("test", 32))
CLIP_EPISODE_FRAMES = 12                # c + p = 10 for the 04 step, and room for random_start
CLIP_EVAL_BATCH, CLIP_PREDS = 16, 9     # scripts/05_evaluate_TextOCVP_CLIPort.sh
CLIP_VALID_BATCH = dict(CLIP_EPISODES)["val"]  # one valid batch, no accumulation
CLIP_STEADY_REPS = 1  # timed steady CLIPort train steps (5.5 and 7.6 s each)
# the batches of one ViT call on the main paths, in frames: a request's and
# the 05 seed frames, the 02 microbatch and valid batch, the 04 microbatch
# and valid batch
VIT_BATCHES = (BATCH, CLIP_EVAL_BATCH, CLIP_TRAIN_BATCH // CLIP_ACCUM * CLIP_FRAMES,
               CLIP_TRAIN_BATCH // CLIP_ACCUM * PRED_FRAMES, CLIP_VALID_BATCH * CLIP_FRAMES,
               CLIP_VALID_BATCH * PRED_FRAMES, 1)  # 1: the 06b seed frame
CLIP_PRED_NAME = "textocvp_t5_clipport"
VIT_BLOCKS = 12
# the CNN head's conv biases sit before a BatchNorm in training mode: the batch
# mean takes away any shift common to a channel, so their gradient is 0 in
# exact arithmetic
CLIP_EXACT_ZERO = tuple(f"patch_decoder.cnns.{i}.conv.bias" for i in range(4))


@dataclass(frozen=True)
class ServedPath:
    """One model family the service runs, at its full width."""
    name: str
    model: str
    dataset: str
    res: int
    num_preds: int
    parity_batch: int
    vit_per_request: int    # ViT attention launches per request (one per block)
    conv5_per_request: int  # conv5 launches per request (SAVi's three tail convs)
    captions: tuple


PATHS = (
    ServedPath("cater", "SAVi", "CATER_Easy", 64, 19, 2, 0, 3, (
        "the cone is sliding to (1, -2)", "the snitch is picked up and placed to (3, 3)",
        "the cone is rotating", "the snitch is containing the cone",
        "the cone is picked up and placed to (-1, 1)", "the snitch is sliding to (2, 2)",
        "the cone is sliding to (-3, -3)", "the snitch is rotating and sliding")),
    ServedPath("clipport", "ExtendedDINOSAUR", "CLIPort", 336, 9, 1, 12, 0, (
        "put the red block in the green bowl", "put the blue block in the yellow bowl",
        "put the green block in the brown bowl", "put the yellow block in the red bowl",
        "put the purple block in the blue bowl", "put the orange block in the gray bowl",
        "put the white block in the pink bowl", "put the cyan block in the purple bowl")),
)


PHASE_CLOCK = [time.perf_counter()]  # when the last phase line was printed


def emit(obj):
    """Print ``obj`` as one JSON line; a phase's line gets ``phase_s``, the
    seconds since the line before it."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "phase_s": now - PHASE_CLOCK[0]}
        PHASE_CLOCK[0] = now
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


HOLD_CYCLES = 50_000_000  # about 25 ms of the card's clock


def cuda_ms(fn, reps=20, warmup=3, hold=False):
    """Mean ms a call from CUDA events around ``reps`` calls after warm-up.
    With ``hold`` the card first spins for HOLD_CYCLES while the host enqueues
    the calls, so the host's time per call does not show in a short kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


FENCE_KERNEL = "spin_kernel"  # torch.cuda._sleep's
FENCE_SPINS = (8, 64, 512)    # spins of about 12 ms before a traced call, by attempt


def fence(spins=1):
    """``spins`` device spins of HOLD_CYCLES / 2 (about 12 ms) each, then a
    synchronize."""
    for _ in range(spins):
        torch.cuda._sleep(HOLD_CYCLES // 2)
    torch.cuda.synchronize()


def traced(fn, cpu=True):
    """``fn()`` once under torch.profiler between two fences, with a
    synchronize after it: (the profiler, the call's ms on the host clock,
    the spins of the fence before it). Without ``cpu`` the trace holds the
    device's activity only.

    The profiler drops the earliest device records of a trace: none in a
    young process, then a stretch that grows with the process's age (up to
    the first 175 ms of a trace after 8 minutes, ``chip_trace_probe.py``)
    and now and then falls back to none. A trace counts only if a spin of
    the first fence comes before ``fn``'s first device record and a spin of
    the last after its last one, so that no record of ``fn`` can be
    missing; else ``fn`` runs again behind the next fence of FENCE_SPINS,
    and after the last the check fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if cpu else []
    for spins in FENCE_SPINS:
        with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
            fence(spins)
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t)
            fence()
        names = [name for _, name in sorted(
            (e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA)]
        body = [i for i, name in enumerate(names) if FENCE_KERNEL not in name]
        if body and 0 < body[0] and body[-1] < len(names) - 1:
            return prof, wall_ms, spins
    check(False, f"no whole trace behind {FENCE_SPINS[-1]} fence spins: the last one held "
                 f"{len(names)} device records, {len(body)} of the call, first {names[:3]}")


def device_records(prof):
    """The device entries of ``prof.key_averages()``, the fences left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and FENCE_KERNEL not in e.key]


def bound(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bounds_tf32x3(nbytes, flops):
    """The least time for float32-accurate work as 3xTF32 on the tensor cores,
    and, third, the float32 CUDA-core bound of the same work."""
    ms, by = bound(nbytes, TF32X3_PRODUCTS * flops, TF32_FLOP_PER_S)
    return ms, by, bound(nbytes, flops)[0]


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name


def phase_build():
    from textocvp_tpu_torch.ops import build

    t = time.perf_counter()
    built = build.build_all()
    seconds = time.perf_counter() - t
    libs = {}
    for src in build.sources():
        report = build.ptxas_report(src.stem)
        tensor_core = build.tensor_core_instructions(src.stem)
        print(f"{src.stem}: {tensor_core} tensor-core SASS instructions\n{report}", flush=True)
        libs[src.stem] = {"tensor_core_sass": tensor_core, "ptxas": report.splitlines()}
    emit({"phase": "build", "seconds": seconds, "built": built,
          "sources": [str(p.relative_to(ROOT)) for p in build.sources()],
          "headers": [str(p.relative_to(ROOT)) for p in build.headers()], "libraries": libs})
    for stem in TENSOR_CORE_KERNELS:
        check(libs[stem]["tensor_core_sass"] > 0, f"{stem}: no tensor-core instruction in its SASS")


def slot_attention_bound_ms(b, n, d, s, h, iters):
    """Least time on the card: K and V read once, slots in and out, attn out,
    weights read once; operations of every iteration at the float32 rate."""
    weights = 3 * d + d * d + 2 * (3 * d * d + 3 * d) + 2 * d + h * d + h + d * h + d
    nbytes = 4 * (2 * b * n * d + 2 * b * s * d + b * s * n + weights)
    per_iter = (4 * b * s * n * d + 8 * b * s * n                       # q.k, a.v, softmax
                + 2 * b * s * (d * d + 6 * d * d + 2 * d * h) + 20 * b * s * d)  # q, GRU, MLP
    return bound(nbytes, iters * per_iter)


def vit_attention_bounds(b, h, n, dh):
    """q, k, v read once and out written once; the two products as 3xTF32 (and
    at the float32 CUDA-core rate)."""
    return bounds_tf32x3(4 * 4 * b * h * n * dh, 4 * b * h * n * n * dh)


SLOT_ATTENTION_KERNEL = "slot_attention_cluster_kernel"  # csrc/slot_attention.cu
VIT_ATTENTION_KERNEL = "attention_kernel"                # csrc/vit_attention.cu


def device_kernels(fn):
    """{name: (count, ms)} of the device kernels that one call of ``fn`` runs,
    from a whole trace (``traced``)."""
    prof, _, _ = traced(fn)
    return {e.key: (e.count, e.self_device_time_total / 1e3) for e in device_records(prof)}


def slot_attention_rows(n, s, mlp, batches):
    from textocvp_tpu_torch.models.factory import random_init_
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak
    from textocvp_tpu_torch.ops.slot_attention import SlotAttention

    d = 128
    gen = torch.Generator().manual_seed(SEED)
    mod = random_init_(SlotAttention(d, d, s, mlp), gen).cuda()
    params = {k: p.detach() for k, p in mod.iteration_params().items()}
    scale = d ** -0.5
    rows = []
    for b in batches:
        k = torch.randn((b, n, d), generator=gen).cuda()
        v = torch.randn((b, n, d), generator=gen).cuda()
        slots = torch.randn((b, s, d), generator=gen).cuda()
        for iters in (1, 3):
            launches = sak.slot_attention_cuda.launches
            out, attn = sak.slot_attention_cuda(k, v, slots, params, iters, scale)
            ref, ref_attn = sak.slot_attention_plain(k, v, slots, params, iters, scale)
            torch.cuda.synchronize()
            err_slots = (out - ref).abs().max().item()
            err_attn = (attn - ref_attn).abs().max().item()
            check(bool(torch.isfinite(out).all()), "kernel slots not finite")
            # float32 on both sides, sums in other orders: 1e-4 absolute on
            # slots of order 1 and on attention weights in [0, 1]
            check(err_slots <= 1e-4 and err_attn <= 1e-4,
                  f"slot attention vs plain at N={n} S={s} B={b} iters={iters}: "
                  f"slots {err_slots}, attn {err_attn}")
            kernels = device_kernels(
                lambda: sak.slot_attention_cuda(k, v, slots, params, iters, scale))
            ours = [c for name, c in kernels.items() if SLOT_ATTENTION_KERNEL in name]
            device_launches = sum(count for count, _ in ours)
            check(device_launches == 1,
                  f"slot attention at B={b} N={n} iters={iters}: device kernels {kernels}")
            # the card held while the host enqueues: a short kernel's own time,
            # not the wrapper's host time per call
            ms = cuda_ms(lambda: sak.slot_attention_cuda(k, v, slots, params, iters, scale),
                         hold=True)
            plain_ms = cuda_ms(lambda: sak.slot_attention_plain(k, v, slots, params, iters, scale))
            bound_ms, bound_by = slot_attention_bound_ms(b, n, d, s, mlp, iters)
            rows.append({"B": b, "N": n, "S": s, "mlp": mlp, "iters": iters,
                         "max_abs_err_slots": err_slots, "max_abs_err_attn": err_attn,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
                         "launches": sak.slot_attention_cuda.launches - launches,
                         "device_launches": device_launches,
                         "device_kernels_per_call": sum(c for c, _ in kernels.values()),
                         "profiled_device_ms": sum(t for _, t in ours),
                         "cluster_size": sak.load_library().sa_cluster_size(),
                         "active_clusters": sak.load_library().sa_active_clusters(s, mlp)})
    return rows


def vit_attention_rows():
    import torch.nn.functional as F

    from textocvp_tpu_torch.ops import vit_attention as va

    scale = VIT_DH ** -0.5
    gen = torch.Generator().manual_seed(SEED + 3)
    rows = []
    for b in VIT_BATCHES:
        q, k, v = (torch.randn((b, VIT_HEADS, VIT_TOKENS, VIT_DH), generator=gen).cuda()
                   for _ in range(3))
        launches = va.vit_attention_cuda.launches
        out = va.vit_attention_cuda(q, k, v, scale)
        ref = va.vit_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # float32 on both sides, sums in other orders: the JAX package's own
        # flash-vs-XLA tolerance
        check(bool(torch.isfinite(out).all()) and err <= 2e-5,
              f"ViT attention vs plain at B={b}: {err} > 2e-5")
        ms = cuda_ms(lambda: va.vit_attention_cuda(q, k, v, scale))
        plain_ms = cuda_ms(lambda: va.vit_attention_plain(q, k, v, scale))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        bound_ms, bound_by, fp32_ms = vit_attention_bounds(b, VIT_HEADS, VIT_TOKENS, VIT_DH)
        rows.append({"B": b, "h": VIT_HEADS, "n": VIT_TOKENS, "dh": VIT_DH,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_ms_fp32_cores": fp32_ms,
                     "launches": va.vit_attention_cuda.launches - launches})
    return rows


def conv5_bounds(n, h, w, c):
    """x read once and out written once, weights and bias read once; the
    products, bias and ReLU as 3xTF32 (and at the float32 CUDA-core rate)."""
    nbytes = 4 * (2 * n * h * w * c + 25 * c * c + c)
    return bounds_tf32x3(nbytes, 2 * 25 * c * c * n * h * w + 2 * n * h * w * c)


def conv5_rows():
    """conv5 against its plain version at the 06 paths' map counts, a CATER
    request's and an eval batch's. The error is taken over the first 256 frames and
    the last one (the plain version of all 9728 needs 50 GB); times cover
    all frames, fewer repetitions at N=9728. The yardstick is ``F.conv2d``
    (cuDNN, TF32 off) with the bias, then an in-place ReLU, timed on the
    NCHW-contiguous input and on the channels-last view of the NHWC input;
    ``library_ms`` is the faster."""
    import torch.nn.functional as F

    from textocvp_tpu_torch.ops import conv5 as c5

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 4)
    xgen = torch.Generator("cuda").manual_seed(SEED + 4)  # 10 GB at N=9728: drawn on the card
    c, res = CONV5_CH, CONV5_RES
    w = (torch.randn((5, 5, c, c), generator=gen) / (25 * c) ** 0.5).cuda()
    b = (0.1 * torch.randn((c,), generator=gen)).cuda()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    rows = []
    # the 06 paths' maps: a sequence's seed (8), 06a's 8 frames (64), 06b's
    # 19 predicted frames (152)
    for n, reps in ((8, 20), (DECOMP_FRAMES * 8, 20), (EVAL_PREDS * 8, 20),
                    (BATCH * 19 * 8, 10), (EVAL_BATCH * EVAL_PREDS * 8, 2)):
        x = torch.randn((n, res, res, c), device="cuda", generator=xgen).mul_(0.5)
        launches = c5.conv5_cuda.launches
        out = c5.conv5_cuda(x, w, b)
        check_idx = [*range(min(n, 256)), n - 1]
        ref = torch.cat([c5.conv5_plain(x[:min(n, 256)], w, b), c5.conv5_plain(x[n - 1:], w, b)])
        torch.cuda.synchronize()
        err = (out[check_idx] - ref).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        del out, ref
        # float32 on both sides, 1600-term sums in other orders, outputs of order 1
        check(finite and err <= 1e-4, f"conv5 vs plain at N={n}: {err} > 1e-4")
        ms = cuda_ms(lambda: c5.conv5_cuda(x, w, b), reps=reps, warmup=1)
        launches = c5.conv5_cuda.launches - launches
        lib_cl = cuda_ms(lambda: F.relu_(F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=2)),
                         reps=reps, warmup=1)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        lib_nchw = cuda_ms(lambda: F.relu_(F.conv2d(x_nchw, w_oihw, b, padding=2)),
                           reps=reps, warmup=1)
        del x_nchw
        torch.cuda.empty_cache()
        plain_ms = cuda_ms(lambda: c5.conv5_plain(x, w, b), reps=max(1, reps // 2), warmup=1)
        del x
        torch.cuda.empty_cache()
        bound_ms, bound_by, fp32_ms = conv5_bounds(n, res, res, c)
        layout = "nchw" if lib_nchw <= lib_cl else "channels_last"
        rows.append({"N": n, "H": res, "W": res, "C": c, "max_abs_err": err,
                     "err_frames": f"first {min(n, 256)} and the last", "ms": ms,
                     "plain_ms": plain_ms, "library_ms": min(lib_nchw, lib_cl),
                     "library_layout": layout,
                     "library_ms_by_layout": {"nchw": lib_nchw, "channels_last": lib_cl},
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_ms_fp32_cores": fp32_ms, "launches": launches, "reps": reps})
    return rows


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def grad_errs(got, want):
    """Each gradient's max abs error over its reference's max |value|, that
    scale floored at a thousandth of the largest reference's: a gradient that
    is 0 in exact arithmetic (the query bias and the slot LayerNorm's bias:
    the softmax over slots does not see a shift common to every slot) is
    rounding noise on both sides."""
    top = max(w.abs().max().item() for w in want)
    return [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-3 * top)
            for g, w in zip(got, want)]


def conv5_weight_grad_bound_ms(n, h, w, c):
    """x and g' read once, dW written once; 25 float32 products over every
    pixel at the CUDA-core rate (cuBLAS float32, TF32 off)."""
    return bound(4 * (2 * n * h * w * c + 25 * c * c), 2 * 25 * c * c * n * h * w)


def conv5_backward_rows():
    """conv5's autograd Function on the card against autograd through
    ``conv5_plain`` on the card (in chunks of 512 frames: the plain version
    of 4096 frames at once needs over 100 GB), at a CATER request's N=1216
    and the train step's N=4096, the output gradient strided as autograd
    hands it back through the final conv, both sides with the ReLU's mask of
    the kernel's output (``relu_mask_flips`` counts the outputs whose sign
    the plain version gives otherwise). Then the parts of the backward
    timed apart: the input gradient's launch of the kernel (on the masked
    gradient, with the rotated weights), the weight gradient's 25 products,
    the whole backward; ``library_ms`` is cuDNN's ``convolution_backward``
    of the same masked gradient (input, weight and bias, TF32 off, NHWC
    memory)."""
    from textocvp_tpu_torch.ops import conv5 as c5

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 6)
    cgen = torch.Generator("cuda").manual_seed(SEED + 6)
    c, res, chunk = CONV5_CH, CONV5_RES, 512
    w = (torch.randn((5, 5, c, c), generator=gen) / (25 * c) ** 0.5).cuda().requires_grad_()
    b = (0.1 * torch.randn((c,), generator=gen)).cuda().requires_grad_()
    rows = []
    for n, reps in ((BATCH * 19 * 8, 5), (TRAIN_BATCH * TRAIN_FRAMES * 8, 3)):
        x = torch.randn((n, res, res, c), device="cuda", generator=cgen).mul_(0.5).requires_grad_()
        g = torch.randn((n, c, res, res), device="cuda", generator=cgen).permute(0, 2, 3, 1)
        launches = c5.conv5_cuda.launches, c5.conv5_input_grad_cuda.launches
        y = c5.conv5(x, w, b)
        got = torch.autograd.grad(y, (x, w, b), g, retain_graph=True)
        torch.cuda.synchronize()
        launches = (c5.conv5_cuda.launches - launches[0],
                    c5.conv5_input_grad_cuda.launches - launches[1])
        check(launches == (2, 1), f"conv5 Function at N={n}: launches {launches}, want (2, 1)")
        # the reference takes the ReLU's mask from the kernel's output: where
        # the kernel's and the plain version's outputs straddle 0 (within the
        # forward's error), their masks differ, and with them the gradient by
        # a whole term of g
        gm = torch.where(y.detach() > 0, g, 0.0)
        ref_x = torch.empty_like(x)
        ref_w, ref_b = torch.zeros_like(w), torch.zeros_like(b)
        flips = 0
        for i in range(0, n, chunk):
            xi = x[i:i + chunk].detach().requires_grad_()
            yi = c5.conv5_plain(xi, w, b, relu=False)
            flips += int(((yi > 0) != (y[i:i + chunk] > 0)).sum())
            dx, dw, db = torch.autograd.grad(yi, (xi, w, b), gm[i:i + chunk])
            ref_x[i:i + chunk] = dx
            ref_w += dw
            ref_b += db
            del xi, yi, dx
        errs = {k: rel_err(a, r) for k, a, r in zip(("x", "w", "b"), got, (ref_x, ref_w, ref_b))}
        check(all(bool(torch.isfinite(t).all()) for t in got), f"conv5 grads at N={n} not finite")
        check(max(errs.values()) <= GRAD_TOLERANCE,
              f"conv5 backward vs plain at N={n}: {errs} > {GRAD_TOLERANCE} of max |ref|")
        del got, ref_x
        torch.cuda.empty_cache()
        with torch.no_grad():
            xd, wd, bd = x.detach(), w.detach(), b.detach()
            gm = gm.contiguous()  # the ReLU-masked gradient, NHWC memory
            w_rot = wd.flip(0, 1).transpose(2, 3).contiguous()
            zeros = torch.zeros_like(bd)
            fwd_ms = cuda_ms(lambda: c5.conv5_cuda(xd, wd, bd), reps=reps, warmup=1)
            dx_ms = cuda_ms(lambda: c5.conv5_input_grad_cuda(gm, w_rot, zeros), reps=reps, warmup=1)
            dw_ms = cuda_ms(lambda: c5.conv5_weight_grad(xd, gm), reps=reps, warmup=1)
            db_ms = cuda_ms(lambda: gm.sum((0, 1, 2)), reps=reps, warmup=1)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, (x, w, b), g, retain_graph=True),
                         reps=reps, warmup=1)
        w_oihw = wd.permute(3, 2, 0, 1).contiguous()
        lib_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
            gm.permute(0, 3, 1, 2), xd.permute(0, 3, 1, 2), w_oihw, [c], [1, 1], [2, 2], [1, 1],
            False, [0, 0], 1, [True, True, True]), reps=reps, warmup=1)
        del y, gm, xd, x, g
        torch.cuda.empty_cache()
        dx_bound, dx_by, dx_fp32 = conv5_bounds(n, res, res, c)
        dw_bound, dw_by = conv5_weight_grad_bound_ms(n, res, res, c)
        rows.append({"N": n, "H": res, "W": res, "C": c, "rel_err": errs,
                     "tolerance_rel": GRAD_TOLERANCE, "reference_chunk": chunk,
                     "relu_mask_flips": flips, "forward_ms": fwd_ms, "input_grad_ms": dx_ms,
                     "weight_grad_ms": dw_ms, "bias_grad_ms": db_ms, "backward_ms": bwd_ms,
                     "library_ms": lib_ms,
                     "library": "aten.convolution_backward (cuDNN, TF32 off, NHWC)",
                     "weight_grad_route": "torch.matmul, 25 batched float32 products",
                     "input_grad_bound_ms": dx_bound, "input_grad_bound_by": dx_by,
                     "input_grad_bound_ms_fp32_cores": dx_fp32,
                     "weight_grad_bound_ms": dw_bound, "weight_grad_bound_by": dw_by,
                     "backward_bound_ms": dx_bound + dw_bound, "reps": reps})
    return rows


def conv5_frozen_backward_rows():
    """conv5's Function behind frozen weights, as the 04 trainer's frozen
    decoder runs it, at the predictor step's N=4608: one forward and one
    input-gradient launch and no weight gradient; the input gradient against
    autograd through ``conv5_plain`` (chunks of 512 frames), both sides with
    the ReLU mask of the kernel's output; the forward and input-gradient
    launches timed against their 3xTF32 bound, the plain version's input
    gradient (one conv of the masked gradient) and cuDNN's
    ``convolution_backward`` of the input alone (TF32 off, NHWC memory)."""
    from textocvp_tpu_torch.ops import conv5 as c5

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 9)
    cgen = torch.Generator("cuda").manual_seed(SEED + 9)
    c, res, chunk, n = CONV5_CH, CONV5_RES, 512, PRED_TAIL_N
    w = (torch.randn((5, 5, c, c), generator=gen) / (25 * c) ** 0.5).cuda()
    b = (0.1 * torch.randn((c,), generator=gen)).cuda()
    x = torch.randn((n, res, res, c), device="cuda", generator=cgen).mul_(0.5).requires_grad_()
    g = torch.randn((n, c, res, res), device="cuda", generator=cgen).permute(0, 2, 3, 1)

    before = launch_counts()[1:]
    y = c5.conv5(x, w, b)
    (got,) = torch.autograd.grad(y, x, g)
    torch.cuda.synchronize()
    counts = tuple(a - z for a, z in zip(launch_counts()[1:], before))
    check(counts == (2, 1, 0), f"conv5 behind frozen weights at N={n}: launches, input-gradient "
                               f"launches, weight-gradient calls {counts}, want (2, 1, 0)")
    gm = torch.where(y.detach() > 0, g, 0.0)
    del y, g
    ref = torch.empty_like(got)
    for i in range(0, n, chunk):
        xi = x[i:i + chunk].detach().requires_grad_()
        (ref[i:i + chunk],) = torch.autograd.grad(c5.conv5_plain(xi, w, b, relu=False), xi,
                                                  gm[i:i + chunk])
        del xi
    err = rel_err(got, ref)
    check(bool(torch.isfinite(got).all()) and err <= GRAD_TOLERANCE,
          f"conv5 input gradient behind frozen weights at N={n}: {err} > {GRAD_TOLERANCE}")
    del got, ref
    torch.cuda.empty_cache()
    with torch.no_grad():
        xd = x.detach()
        del x
        gm = gm.contiguous()
        w_rot = w.flip(0, 1).transpose(2, 3).contiguous()
        zeros = torch.zeros_like(b)
        fwd_ms = cuda_ms(lambda: c5.conv5_cuda(xd, w, b), reps=3, warmup=1)
        dx_ms = cuda_ms(lambda: c5.conv5_input_grad_cuda(gm, w_rot, zeros), reps=3, warmup=1)
        plain_ms = cuda_ms(lambda: c5.conv5_plain(gm, w_rot, zeros, relu=False), reps=1,
                           warmup=1)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        lib_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
            gm.permute(0, 3, 1, 2), xd.permute(0, 3, 1, 2), w_oihw, [c], [1, 1], [2, 2],
            [1, 1], False, [0, 0], 1, [True, False, False]), reps=3, warmup=1)
    del xd, gm
    torch.cuda.empty_cache()
    bound_ms, bound_by, fp32_ms = conv5_bounds(n, res, res, c)
    return [{"N": n, "H": res, "W": res, "C": c, "rel_err": err, "tolerance_rel": GRAD_TOLERANCE,
             "reference_chunk": chunk, "launches": counts[0], "input_grad_launches": counts[1],
             "weight_grad_calls": counts[2], "forward_ms": fwd_ms, "input_grad_ms": dx_ms,
             "plain_input_grad_ms": plain_ms, "library_ms": lib_ms,
             "library": "aten.convolution_backward, input only (cuDNN, TF32 off, NHWC)",
             "bound_ms": bound_ms, "bound_by": bound_by, "bound_ms_fp32_cores": fp32_ms}]


def slot_attention_backward_bound_ms(b, n, d, s, h, iters):
    """The gradient's least time: k, v, slots, the two cotangents and the
    weights read once, the gradients of k, v, slots and the weights written
    once; each forward product's two gradient products at the float32 rate."""
    weights = 3 * d + d * d + 2 * (3 * d * d + 3 * d) + 2 * d + h * d + h + d * h + d
    nbytes = 4 * (4 * b * n * d + 3 * b * s * d + b * s * n + 2 * weights)
    per_iter = (4 * b * s * n * d + 8 * b * s * n
                + 2 * b * s * (d * d + 6 * d * d + 2 * d * h) + 20 * b * s * d)
    return bound(nbytes, 2 * iters * per_iter)


def slot_attention_backward_rows(b, n, s, mlp, seed):
    """The slot-attention Function's gradients (k, v, slots, the 14
    parameters; cotangents on both outputs) on the card against autograd
    through ``slot_attention_plain`` on the card, at (B, N, S, MLP), 1 and 3
    iterations; the backward's time."""
    from textocvp_tpu_torch.models.factory import random_init_
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak
    from textocvp_tpu_torch.ops.slot_attention import SlotAttention

    d = 128
    gen = torch.Generator().manual_seed(seed)
    mod = random_init_(SlotAttention(d, d, s, mlp), gen).cuda()
    params = {k: p.detach().clone().requires_grad_() for k, p in mod.iteration_params().items()}
    k, v = (torch.randn((b, n, d), generator=gen).cuda().requires_grad_() for _ in range(2))
    slots = torch.randn((b, s, d), generator=gen).cuda().requires_grad_()
    leaves = [k, v, slots, *params.values()]
    rows = []
    for iters in (1, 3):
        gs = torch.randn((b, s, d), generator=gen).cuda()
        ga = torch.randn((b, s, n), generator=gen).cuda()
        out = sak.slot_attention_iterations(k, v, slots, params, iters, d ** -0.5)
        got = torch.autograd.grad(out, leaves, [gs, ga], retain_graph=True)
        ref = sak.slot_attention_plain(k, v, slots, params, iters, d ** -0.5)
        want = torch.autograd.grad(ref, leaves, [gs, ga])
        names = ["k", "v", "slots", *params]
        errs = dict(zip(names, grad_errs(got, want)))
        check(max(errs.values()) <= GRAD_TOLERANCE,
              f"slot-attention backward vs plain at B={b} N={n} S={s} {iters} it: {errs}")
        ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, [gs, ga], retain_graph=True),
                     reps=10, warmup=2)
        bound_ms, bound_by = slot_attention_backward_bound_ms(b, n, d, s, mlp, iters)
        rows.append({"B": b, "N": n, "S": s, "mlp": mlp, "iters": iters, "rel_err": errs,
                     "max_rel_err": max(errs.values()), "tolerance_rel": GRAD_TOLERANCE,
                     "backward_ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "route": "recompute through slot_attention_plain under autograd"})
        del out, got, ref, want
    return rows


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    # B=1: one 06 sequence, frame by frame
    rows = {"slot_attention_cater": slot_attention_rows(4096, 8, 256, (1, 8, 64)),
            # a request's and the 02 and 04 microbatches (B=8), the valid
            # batches and the 05 batch (B=16)
            "slot_attention_clipport": slot_attention_rows(
                CLIP_PATCHES, CLIP_SLOTS, 512, (1, BATCH, CLIP_EVAL_BATCH)),
            "vit_attention": vit_attention_rows(),
            "conv5": conv5_rows(),
            "conv5_backward": conv5_backward_rows(),
            "conv5_frozen_backward": conv5_frozen_backward_rows(),
            "slot_attention_backward": slot_attention_backward_rows(
                TRAIN_BATCH, CONV5_RES * CONV5_RES, 8, 256, SEED + 7),
            # the CLIPort 02 microbatch: B=8 videos a frame, N=576, S=10, MLP 512
            "slot_attention_backward_clipport": slot_attention_backward_rows(
                CLIP_TRAIN_BATCH // CLIP_ACCUM, CLIP_PATCHES, 10, 512, SEED + 11)}
    emit({"phase": "kernels", "tolerance_abs": {"slot_attention": 1e-4, "vit_attention": 2e-5,
                                                "conv5": 1e-4},
          "tolerance_rel_backward": GRAD_TOLERANCE, **rows})
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def full_width_params(path: ServedPath):
    from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params

    params = build_exp_params(path.model, path.dataset)
    pred_params = add_predictor_params(params, "TextOCVP_T5")
    pred_params["prediction_params"]["num_preds"] = path.num_preds
    return params, pred_params


def random_predictor(pred_params, gen):
    """The predictor of ``pred_params`` with weights drawn from ``gen``, in
    ``eval()``, its output projection scaled by PRED_OUT_SCALE."""
    from textocvp_tpu_torch.models import setup_predictor
    from textocvp_tpu_torch.models.factory import random_init_

    predictor = random_init_(setup_predictor(pred_params), gen).eval().requires_grad_(False)
    # With Xavier draws alone each rollout step adds a change larger than the
    # slots it started from: they grow about 1.7x a step, to 1e5 by step 19,
    # and every decoded pixel saturates. A trained predictor changes the slots
    # a little per step; so does this one with its output projection scaled
    # by 0.02 (slots of order 1 to 10 over the 19 steps).
    predictor.predictor.mlp_out.weight.mul_(PRED_OUT_SCALE)
    return predictor


def random_models(params, pred_params, gen):
    from textocvp_tpu_torch.models import setup_model
    from textocvp_tpu_torch.models.factory import random_init_

    model = random_init_(setup_model(params), gen).eval().requires_grad_(False)
    return model, random_predictor(pred_params, gen)


def phase_parity(path: ServedPath, params, pred_params):
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 1)
    model, predictor = random_models(params, pred_params, gen)
    b = path.parity_batch
    video = torch.rand((b, 1, path.res, path.res, 3), generator=gen)
    init = model.slot_initializer(b, gen)
    text = caption_batch(pred_params, b, path)

    def predict(dev, m, p):
        with torch.inference_mode():
            hist = m.decompose(video.to(dev), initial_slots=init.to(dev))["slot_history"]
            return p(hist, num_preds=path.num_preds, **{k: v.to(dev) for k, v in text.items()})

    ref = predict("cpu", model, predictor)
    cmodel, cpred = copy.deepcopy(model).cuda(), copy.deepcopy(predictor).cuda()
    out = predict("cuda", cmodel, cpred).cpu()
    check(bool(torch.isfinite(out).all()), f"{path.name}: card pred_slots not finite")
    # autoregressive steps through 8 layers in float32 on two devices, sums
    # in other orders: each step's error within 1e-4 of that step's largest
    # slot value
    step_err = (out - ref).abs().amax(dim=(0, 2, 3))
    step_ref = ref.abs().amax(dim=(0, 2, 3))
    ratios = (step_err / step_ref).tolist()
    check(max(ratios) <= 1e-4,
          f"{path.name}: pred_slots card vs CPU, error / max|ref| per step: {ratios}")

    frames = ref[:, 0]  # the same slots into both decoders
    with torch.inference_mode():
        dref = model.decode(frames)["recons_imgs"]
        dout = cmodel.decode(frames.cuda())["recons_imgs"].cpu()
    derr = (dout - dref).abs().max().item()
    check(derr <= 1e-4, f"{path.name}: decode card vs CPU: {derr} > 1e-4")
    emit({"phase": "parity", "path": path.name, "B": b, "pred_slots_shape": list(out.shape),
          "pred_slots_max_abs_err": step_err.max().item(),
          "pred_slots_max_abs_ref_per_step": step_ref.tolist(),
          "pred_slots_err_ratio_per_step": ratios, "pred_slots_ratio_tolerance": 1e-4,
          "decode_frames": b, "decode_max_abs_err": derr,
          "decode_max_abs_ref": dref.abs().max().item(), "decode_tolerance": 1e-4,
          "tf32": False})


def write_experiment(root: Path, params, pred_params):
    from textocvp_tpu_torch.core.experiment import Experiment

    gen = torch.Generator().manual_seed(SEED)
    model, predictor = random_models(params, pred_params, gen)
    parent = Experiment(root / "exp")
    parent.save_params(params)
    pred = Experiment(root / "exp" / "predictors" / "textocvp_t5")
    pred.save_params(pred_params)
    parent.models_dir.mkdir(parents=True, exist_ok=True)
    pred.models_dir.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), parent.checkpoint_path("random"))
    torch.save(predictor.state_dict(), pred.checkpoint_path("random"))
    return parent.exp_path


def kernel_counters():
    from textocvp_tpu_torch.ops import conv5 as c5
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak
    from textocvp_tpu_torch.ops import vit_attention as va

    return {"slot_attention": sak.slot_attention_cuda, "vit_attention": va.vit_attention_cuda,
            "conv5": c5.conv5_cuda}


def launches():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def reset_launches():
    for fn in kernel_counters().values():
        fn.launches = 0


def phase_service(path: ServedPath, exp_path):
    from textocvp_tpu_torch.serve import PredictionService

    torch.cuda.reset_peak_memory_stats()  # the peak of this path's service alone
    t0 = time.perf_counter()
    service = PredictionService(exp_path, "textocvp_t5", "random", "random",
                                batch_size=BATCH, max_tokens=MAX_TOKENS, device="cuda")
    load_s = time.perf_counter() - t0
    check(service.num_preds == path.num_preds, "num_preds")
    check(service.resolution == (path.res, path.res), f"resolution {service.resolution}")
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0, 1, (BATCH, 1, path.res, path.res, 3)).astype(np.float32)
    captions = list(path.captions[:BATCH])
    per_request = {"slot_attention": 1, "vit_attention": path.vit_per_request,
                   "conv5": path.conv5_per_request}

    unsaturated = []

    def call(frames, captions):
        before = launches()
        t = time.perf_counter()
        out = service.predict(frames, captions)
        ms = 1e3 * (time.perf_counter() - t)
        after = launches()
        for name, n in per_request.items():
            check(after[name] - before[name] == n,
                  f"{path.name}: {after[name] - before[name]} {name} launches in a request, "
                  f"want {n}")
        b = frames.shape[0]
        check(out.shape == (b, path.num_preds, path.res, path.res, 3), f"output shape {out.shape}")
        check(bool(np.isfinite(out).all()) and out.min() >= 0 and out.max() <= 1,
              "output finite and in [0, 1]")
        # the clip to [0, 1] says little if every pixel sits at 0 or 1
        inside = float(((out > 0) & (out < 1)).mean())
        check(inside >= 0.05, f"share of output values strictly inside (0, 1): {inside}")
        unsaturated.append(inside)
        return out, ms

    t = time.perf_counter()
    service.warmup()
    warmup_ms = 1e3 * (time.perf_counter() - t)
    _, ms_f32 = call(video, captions)
    _, ms_u8 = call(np.round(video[:3] * 255).astype(np.uint8), captions[:3])
    _, ms_8 = call(video, captions)
    steady = [call(video, captions)[1] for _ in range(5)]

    # stage split of one full request, host clock with synchronize
    text = service._tokenize(captions)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pred_slots = service._predict_stage(video, text)
    torch.cuda.synchronize()
    t_pred = time.perf_counter()
    service._decode_stage(pred_slots)
    torch.cuda.synchronize()
    t_dec = time.perf_counter()
    emit({"phase": "service", "path": path.name, "model": path.model, "batch": BATCH,
          "num_preds": path.num_preds, "resolution": path.res, "load_s": load_s,
          "warmup_ms": warmup_ms, "request_ms": {"8_float32": ms_f32, "3_uint8": ms_u8,
                                                  "8_float32_again": ms_8},
          "steady_8_row_ms": steady,
          "stage_ms": {"predict": 1e3 * (t_pred - t), "decode": 1e3 * (t_dec - t_pred)},
          "unsaturated_share": unsaturated,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "tokenizer_fallback": bool(service.tokenizer.is_fallback)})
    return service


def phase_http(path: ServedPath, service, video_rows):
    from textocvp_tpu_torch.serve import serve

    httpd = serve(service, host="127.0.0.1", port=0, warmup=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["num_preds"] == path.num_preds,
              f"healthz {health}")
        buf = io.BytesIO()
        np.savez(buf, frames=video_rows, captions=np.array(path.captions[:BATCH]))
        req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                     headers={"Content-Type": "application/npz"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            pred = np.load(io.BytesIO(r.read()))["pred_frames"]
        ms = 1e3 * (time.perf_counter() - t)
        check(pred.dtype == np.uint8
              and pred.shape == (BATCH, path.num_preds, path.res, path.res, 3),
              f"pred_frames {pred.dtype} {pred.shape}")
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        check(stats["requests"] == 1 and stats["errors"] == 0, f"stats {stats}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread stopped")
    emit({"phase": "http", "path": path.name, "pred_frames_shape": list(pred.shape),
          "dtype": str(pred.dtype), "round_trip_ms": ms, "stats": stats})


def phase_profile(path: ServedPath, service, video):
    """One full request under torch.profiler: device busy time (the sum of
    kernel and copy times on the one stream) against the request's wall time,
    the kernels that take the most device time, and the port's kernels' own
    launches inside the request. Off the main path."""
    captions = list(path.captions[:BATCH])
    service.predict(video, captions)
    prof, wall_ms, spins = traced(lambda: service.predict(video, captions))
    dev = device_records(prof)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:12]

    def entries(*names):
        return [{"name": e.key[:60], "count": e.count, "ms": e.self_device_time_total / 1e3}
                for e in dev if any(n in e.key for n in names)]

    slot_attention = entries(SLOT_ATTENTION_KERNEL)
    emit({"phase": "profile", "path": path.name, "request_wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
          "device_ops": sum(e.count for e in dev), "trace_fence_spins": spins,
          "slot_attention": slot_attention,
          "vit_attention": entries("attention_kernel"), "conv5": entries("conv5_kernel"),
          "top": [{"name": e.key[:90], "count": e.count,
                   "ms": e.self_device_time_total / 1e3} for e in top]})
    # one slot-attention call a request, one device kernel a call
    check(sum(e["count"] for e in slot_attention) == 1,
          f"{path.name}: slot-attention device kernels in a request: {slot_attention}")


def write_cater_fixture(root: Path, splits=(("test", EVAL_VIDEOS),)) -> Path:
    """A CATER ``.npy`` set: for each (split, count), count videos of 21 uint8
    64x64 frames, three coloured squares sliding over a shaded floor with a
    little noise, and ``easy/<split>_explicit.json`` with CATER-style
    captions. Videos are drawn 64 at a time."""
    rng = np.random.default_rng(SEED)
    t, r = EVAL_PREDS + 2, CONV5_RES
    yy, xx = np.meshgrid(np.arange(r), np.arange(r), indexing="ij")
    mode = root / "easy"
    mode.mkdir(parents=True)
    captions = PATHS[0].captions
    first = 0
    for split, count in splits:
        for lo in range(0, count, 64):
            v = min(64, count - lo)
            frames = np.broadcast_to((0.35 + 0.25 * yy / r)[None, None, :, :, None],
                                     (v, t, r, r, 3))
            steps = np.arange(t)[None, :, None, None]
            for _ in range(3):
                color = rng.uniform(0, 1, (v, 1, 1, 1, 3))
                size = rng.integers(4, 9, (v, 1, 1, 1))
                cy = rng.uniform(8, 56, (v, 1, 1, 1)) + rng.uniform(-1.5, 1.5, (v, 1, 1, 1)) * steps
                cx = rng.uniform(8, 56, (v, 1, 1, 1)) + rng.uniform(-1.5, 1.5, (v, 1, 1, 1)) * steps
                inside = (np.abs(yy - cy) < size) & (np.abs(xx - cx) < size)
                frames = np.where(inside[..., None], color, frames)
            frames = frames + 0.02 * rng.standard_normal(frames.shape)
            videos = np.round(np.clip(frames, 0, 1) * 255).astype(np.uint8)
            for i in range(v):
                np.save(mode / f"video_{first + lo + i:04d}.npy", videos[i])
        with open(mode / f"{split}_explicit.json", "w") as f:
            json.dump({str(i): {"video": f"video_{first + i:04d}.npy",
                                "caption": captions[i % len(captions)]} for i in range(count)}, f)
        first += count
    return root


def phase_eval_parity(exp_path, pred_name="textocvp_t5", ckpts=("random", "random"),
                      num_preds=EVAL_PREDS, phase="eval_parity"):
    """The eval step at B=2 on the card and on the CPU: the same weights
    (``ckpts``: the decomposition model's and the predictor's), initial
    slots and frames. Off the main path."""
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    evs = {}
    for dev in ("cpu", "cuda"):
        evs[dev] = PredictorEvaluator(exp_path, pred_name, *ckpts, num_seed=1,
                                      num_preds=num_preds, batch_size=2, device=dev)
        evs[dev].load_data()
        evs[dev].load_models()
    videos, info = next(iter(evs["cpu"].test_loader))
    init = evs["cpu"].model.slot_initializer(2, torch.Generator().manual_seed(SEED + 5))
    vals = {dev: {m: v.cpu() for m, v in ev.eval_step(videos, info, initial_slots=init).items()}
            for dev, ev in evs.items()}
    # float32 through encode, the rollout and the decode on two devices, sums
    # in other orders: PSNR within 1e-3 dB, SSIM and LPIPS within 1e-4
    tol = {"psnr": 1e-3, "ssim": 1e-4, "lpips": 1e-4}
    errs = {}
    for m, limit in tol.items():
        out, ref = vals["cuda"][m], vals["cpu"][m]
        check(out.shape == (2, num_preds) and bool(torch.isfinite(out).all()),
              f"{phase}: {m} {tuple(out.shape)} not finite or misshapen")
        errs[m] = (out - ref).abs().max().item()
        check(errs[m] <= limit, f"{phase}: framewise {m} card vs CPU {errs[m]} > {limit}")
    emit({"phase": phase, "B": 2, "num_preds": num_preds, "max_abs_err": errs,
          "tolerance": tol, "cpu_framewise_mean": {m: v.mean(0).tolist()
                                                   for m, v in vals["cpu"].items()}})


def eval_results_path(exp_path):
    return (exp_path / "predictors" / "textocvp_t5" / "results"
            / f"eval_pred_random_NumSeed=1_NumPreds={EVAL_PREDS}" / "results.json")


def check_framewise_plots(results_dir: Path, results: dict, what: str) -> list:
    """Each metric's ``<metric>_framewise.png`` beside ``results.json``
    (``train/evaluator.py::_save_framewise_plots``) decodes through PIL at the
    plot's size. Returns their names."""
    from PIL import Image

    from textocvp_tpu_torch.viz.figures import METRIC_SIZE

    names = [f"{m}_framewise.png" for m, v in results.items()
             if isinstance(v, dict) and "framewise" in v]
    check(len(names) == 3, f"{what}: metrics with framewise values {names}")
    for name in names:
        check((results_dir / name).is_file(), f"{what}: no {name} beside results.json")
        with Image.open(results_dir / name) as img:
            img.load()
            check(img.size == METRIC_SIZE, f"{what}: {name} is {img.size}")
    return names


def phase_eval(exp_path):
    """The 05 CLI at B=64 over EVAL_VIDEOS videos, on the card: the eval
    path's main path. Returns its kernel launches."""
    from textocvp_tpu_torch.cli import evaluate_predictor

    reset_launches()  # the main path starts here
    t = time.perf_counter()
    rc = evaluate_predictor.main(["-d", str(exp_path), "--name_pred_exp", "textocvp_t5",
                                  "--decomp_ckpt", "random", "--pred_ckpt", "random",
                                  "--batch_size", str(EVAL_BATCH), "--num_seed", "1",
                                  "--num_preds", str(EVAL_PREDS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    batches = EVAL_VIDEOS // EVAL_BATCH
    check(rc == 0, f"evaluate_predictor returned {rc}")
    check(counts == {"slot_attention": batches, "vit_attention": 0, "conv5": 3 * batches},
          f"eval: kernel launches on the main path: {counts}")
    with open(eval_results_path(exp_path)) as f:
        results = json.load(f)
    for m in ("psnr", "ssim", "lpips"):
        vals = results[m]["framewise"] + [results[m]["mean"]]
        check(len(results[m]["framewise"]) == EVAL_PREDS and bool(np.isfinite(vals).all()),
              f"eval results.json: {m} {results[m]}")
    check(results["lpips"]["comparable"] is False, "lpips.comparable false (random AlexNet)")
    plots = check_framewise_plots(eval_results_path(exp_path).parent, results, "eval")
    emit({"phase": "eval", "batch": EVAL_BATCH, "videos": EVAL_VIDEOS, "num_seed": 1,
          "num_preds": EVAL_PREDS, "cli_seconds": seconds, "launches": counts,
          "results": results, "framewise_plots": plots})
    return counts


def phase_eval_step(exp_path, pred_name="textocvp_t5", ckpts=("random", "random"),
                    batch=EVAL_BATCH, num_preds=EVAL_PREDS, vit_launches=0, phase="eval_step",
                    **extra):
    """One more batch split into its stages with synchronize, the peak
    memory of the step, and one step under torch.profiler (``profiled_step``)
    with one slot-attention device kernel and ``vit_launches`` ViT-attention
    launches (``check_traced``). Off the main path. ``extra`` goes into the
    phase's line."""
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    ev = PredictorEvaluator(exp_path, pred_name, *ckpts, num_seed=1, num_preds=num_preds,
                            batch_size=batch)
    ev.load_data()
    ev.load_models()
    videos, info = next(iter(ev.test_loader))
    ev.eval_step(videos, info)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    marks = []
    mark()
    v, text = ev.to_device(videos, info)
    mark()
    slots = ev.predict_stage(v, text)
    mark()
    imgs = ev.decode_stage(slots)
    mark()
    vals = ev.metrics_stage(imgs, v)
    mark()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(all(bool(torch.isfinite(x).all()) for x in vals.values()), f"{phase} metrics finite")
    del v, slots, imgs, vals
    stage_ms = dict(zip(("to_device", "predict", "decode", "metrics"),
                        (1e3 * (t1 - t0) for t0, t1 in zip(marks[:-1], marks[1:]))))
    step_ms = 1e3 * (marks[-1] - marks[0])

    prof, entries = profiled_step(lambda: ev.eval_step(videos, info), top=12)
    slot_attention = entries(SLOT_ATTENTION_KERNEL)
    vit = entries(VIT_ATTENTION_KERNEL)
    emit({"phase": phase, **extra, "batch": batch, "num_preds": num_preds,
          "step_ms": step_ms, "stage_ms": stage_ms,
          "pred_frames_per_s": 1e3 * batch * num_preds / step_ms,
          "peak_mem_gb": peak_gb, **prof, "slot_attention": slot_attention,
          "vit_attention": vit, "conv5": entries("conv5_kernel")})
    # one slot-attention call a batch; one ViT-attention launch a block
    check_traced(phase, slot_attention, vit, (1, vit_launches))


def run_eval(tmp: Path):
    """The eval path: fixture and experiment, parity, the main path (the 05
    CLI), then the stage split and profile. Returns the main path's launches."""
    params, pred_params = full_width_params(PATHS[0])
    data_root = write_cater_fixture(tmp / "CATER")
    for p in (params, pred_params):
        p["dataset"]["root"] = str(data_root)
    exp_path = write_experiment(tmp / "eval", params, pred_params)
    phase_eval_parity(exp_path)
    counts = phase_eval(exp_path)
    gc.collect()
    torch.cuda.empty_cache()
    phase_eval_step(exp_path)
    return counts


def train_experiment(root: Path, data_root, **training) -> Path:
    """A SAVi CATER experiment at full width over ``data_root``: the 02
    defaults (Adam, lr 1e-4, warmup 2000, cosine, clip 0.05, ``mse``) with
    ``training`` over them; ``num_frames`` 8 with ``random_start``."""
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.core.experiment import Experiment

    params = build_exp_params("SAVi", "CATER_Easy")
    params["dataset"]["root"] = str(data_root)
    params["training"].update({"batch_size": TRAIN_BATCH, "num_epochs": 1, "log_frequency": 1,
                               **training})
    exp = Experiment(root)
    exp.save_params(params)
    return exp.exp_path


CLIPPED = (("pred_imgs", "recons_imgs"), ("preds_feats", "recons_feats"))  # loss inputs
# the kinks whose masks the CPU takes from the card: on the CATER paths the
# decoder-tail convs and each ``MLP``'s hidden layer (and the feed-forward
# ReLU of the torch-style layers for the other predictors), on the CLIPort
# paths every kink on the gradient's path
CATER_KINKS = ("conv5", "mlp")
PREDICTOR_KINKS = CATER_KINKS + ("ff",)
ALL_KINKS = ("conv5", "mlp", "ff", "relu", "sa_relu", "clip")


def trainer_parity(what, make, step, tail_convs=6, exact_zero=(), finish=None,
                   replayed=CATER_KINKS):
    """One trainer on the card and on the CPU from the same weights:
    ``make(dev)`` builds and sets it up on ``dev``, ``step(trainer, dev, i)``
    takes its i-th training step (i = 0, 1) and returns the loss. Checks the
    two losses (1e-5 relative), every trainable gradient leaf after the
    first step (1e-4 of the leaf's largest value; a leaf of ``exact_zero``,
    whose gradient is 0 in exact arithmetic, 1e-4 of the largest value of
    any leaf on both devices), the module's buffers after the first step
    (1e-5 absolute and relative: BatchNorm's running statistics) and the
    parameters after the second. ``finish(trainers)`` may check more and
    returns what it reports. Returns what a phase reports.

    The CPU runs twice. Its own run is reported. The checked one takes the
    masks of the kinks of ``replayed`` from the card's run, in call order:
    "conv5" the ReLU of each decoder-tail conv; "mlp" each ReLU of an
    ``MLP``'s hidden layer; "ff" the ReLU of a ``TorchStyleEncoderLayer``'s
    or an ``OCVPParLayer``'s feed-forward; "relu" every other ReLU
    (``torch.nn.functional.relu``) whose input requires grad; "sa_relu" each
    ReLU of the slot-attention MLP, which the card computes in the
    backward's recompute, frames in reverse, and the CPU in the forward;
    "clip" the [0, 1] clip of each reconstruction in the 02 loss. A value
    within the card's rounding of a kink (conv5's 3xTF32, cuBLAS, cuDNN) may
    fall on either side of it on the two devices, and the gradient of what
    comes before it then differs by a whole term (``relu_mask_flips`` counts
    such values by kind, over the kinks of ``ALL_KINKS``), which no float32
    tolerance covers. ``tail_convs`` is the number of conv5 masks the two
    steps give."""
    from textocvp_tpu_torch.models import predictors
    from textocvp_tpu_torch.nn import blocks, decoders
    from textocvp_tpu_torch.ops import conv5 as c5
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    F = torch.nn.functional
    relu, tail_conv, mlp_forward = F.relu, decoders.conv5, blocks.MLP.forward
    feed_forwards = {cls: cls.feed_forward for cls in (blocks.TorchStyleEncoderLayer,
                                                       predictors.OCVPParLayer)}
    sa_plain, loss_tensors = sak.slot_attention_plain, DecompTrainer._loss_tensors

    def tracked(*tensors):
        return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)

    def kink(state, x):
        """The kind of a ReLU of ``x``, for all kinds (the masks recorded for
        ``relu_mask_flips``); None off the gradient's path."""
        if not x.requires_grad:
            return None
        return ("sa_relu" if state["in_sa"] else "mlp" if state["in_mlp"]
                else "ff" if state["in_ff"] else "relu")

    def flagged(state, flag, fn):
        def forward(self, x):
            state[flag] = True
            try:
                return fn(self, x)
            finally:
                state[flag] = False
        return forward

    def recording(rec):
        """Functions that record each kink's mask into ``rec``: "main" in
        call order, "sa" one list a tracked slot-attention call."""
        def relu_fn(x, inplace=False):
            kind = kink(rec, x)
            if kind is not None:
                (rec["sa"][-1] if rec["in_sa"] else rec["main"]).append(
                    (kind, (x.detach() > 0).cpu()))
            return relu(x, inplace=inplace)

        def sa_fn(k, v, slots, params, *args, **kwargs):
            if not tracked(k, v, slots, *params.values()):
                return sa_plain(k, v, slots, params, *args, **kwargs)
            rec["sa"].append([])
            rec["in_sa"] = True
            try:
                return sa_plain(k, v, slots, params, *args, **kwargs)
            finally:
                rec["in_sa"] = False

        def conv_fn(x, w, b, relu=True):
            y = tail_conv(x, w, b, relu)
            if relu:
                rec["main"].append(("conv5", (y.detach() > 0).cpu()))
            return y

        def loss_fn(self, out, videos):
            tensors = loss_tensors(self, out, videos)
            for key, src in CLIPPED:
                if key in tensors:
                    x = out[src].detach()
                    rec["main"].append(("clip", ((x > 0) & (x < 1)).cpu()))
            return tensors
        return relu_fn, sa_fn, conv_fn, loss_fn

    def replaying(rep):
        """Functions that take each kink's mask from ``rep``'s iterators."""
        def take(stream, kind, shape):
            got, mask = next(stream)
            check(got == kind and mask.shape == shape,
                  f"{what}: replayed {got} {tuple(mask.shape)} at a {kind} {tuple(shape)}")
            return mask

        def relu_fn(x, inplace=False):
            kind = kink(rep, x)
            if kind is None:
                return relu(x, inplace=inplace)
            mask = take(rep["call"] if rep["in_sa"] else rep["main"], kind, x.shape)
            return x * mask if kind in replayed else relu(x, inplace=inplace)

        def sa_fn(k, v, slots, params, *args, **kwargs):
            if not tracked(k, v, slots, *params.values()):
                return sa_plain(k, v, slots, params, *args, **kwargs)
            rep["call"] = iter(next(rep["sa"]))
            rep["in_sa"] = True
            try:
                return sa_plain(k, v, slots, params, *args, **kwargs)
            finally:
                rep["in_sa"] = False

        def conv_fn(x, w, b, relu=True):
            y = c5.conv5_plain(x, w, b, relu=False)
            if not relu:
                return y
            mask = take(rep["main"], "conv5", y.shape)
            return y * mask if "conv5" in replayed else torch.relu(y)

        def loss_fn(self, out, videos):
            tensors = loss_tensors(self, out, videos)
            for key, src in CLIPPED:
                if key in tensors:
                    x = out[src]
                    mask = take(rep["main"], "clip", x.shape)
                    if "clip" in replayed:
                        tensors[key] = torch.where(mask, x, x.detach().clamp(0, 1))
            return tensors
        return relu_fn, sa_fn, conv_fn, loss_fn

    recs = {run: {"main": [], "sa": [], "in_sa": False, "in_mlp": False, "in_ff": False,
                  "marks": []} for run in ("cuda", "cpu_own_masks")}
    rep = {"in_sa": False, "in_mlp": False, "in_ff": False}
    runs = {"cuda": ("cuda", recording(recs["cuda"])),
            "cpu_own_masks": ("cpu", recording(recs["cpu_own_masks"])),
            "cpu": ("cpu", replaying(rep))}
    trainers, losses, grads, buffers = {}, {}, {}, {}
    for run, (dev, (relu_fn, sa_fn, conv_fn, loss_fn)) in runs.items():
        if run == "cpu":
            # the card's slot-attention calls of each step ran in reverse
            card = recs["cuda"]
            bounds = card["marks"] + [len(card["sa"])]
            rep["main"] = iter(card["main"])
            rep["sa"] = iter([call for a, b in zip(bounds[:-1], bounds[1:])
                              for call in reversed(card["sa"][a:b])])
        F.relu, decoders.conv5, sak.slot_attention_plain = relu_fn, conv_fn, sa_fn
        DecompTrainer._loss_tensors = loss_fn
        state = rep if run == "cpu" else recs[run]
        blocks.MLP.forward = flagged(state, "in_mlp", mlp_forward)
        for cls, fn in feed_forwards.items():
            cls.feed_forward = flagged(state, "in_ff", fn)
        try:
            tr = trainers[run] = make(dev)
            losses[run] = []
            for i in range(2):
                if run in recs:
                    recs[run]["marks"].append(len(recs[run]["sa"]))
                losses[run].append(step(tr, dev, i))
                if i == 0:
                    grads[run] = {n: p.grad.detach().cpu()
                                  for n, p in tr.model.named_parameters() if p.requires_grad}
                    buffers[run] = {n: b.detach().cpu().clone()
                                    for n, b in tr.model.named_buffers()}
        finally:
            F.relu, decoders.conv5, sak.slot_attention_plain = relu, tail_conv, sa_plain
            DecompTrainer._loss_tensors = loss_tensors
            blocks.MLP.forward = mlp_forward
            for cls, fn in feed_forwards.items():
                cls.feed_forward = fn
    card, own = recs["cuda"], recs["cpu_own_masks"]
    kinds = [k for k, _ in card["main"]]
    check(kinds == [k for k, _ in own["main"]] and kinds.count("conv5") == tail_convs
          and len(card["sa"]) == len(own["sa"]),
          f"{what}: masks {len(card['main'])}, of tail convs {kinds.count('conv5')}, "
          f"slot-attention calls {len(card['sa'])} / {len(own['sa'])}")
    bounds = card["marks"] + [len(card["sa"])]
    card_sa = [m for a, b in zip(bounds[:-1], bounds[1:]) for call in reversed(card["sa"][a:b])
               for m in call]
    pairs = list(zip(card["main"], own["main"])) + list(zip(card_sa, [
        m for call in own["sa"] for m in call]))
    flips = {kind: sum(int((a != b).sum()) for (k, a), (_, b) in pairs if k == kind)
             for kind in ALL_KINKS}
    outputs = {kind: sum(a.numel() for (k, a), _ in pairs if k == kind) for kind in flips}
    names = list(grads["cpu"])
    zero = [n for n in names if n in exact_zero]
    top = max(grads["cpu"][n].abs().max().item() for n in names)
    zero_err = {n: max(grads[run][n].abs().max().item() for run in ("cuda", "cpu")) / top
                for n in zero}
    kept = [n for n in names if n not in zero]
    grad_err = {run: dict(zip(kept, grad_errs([grads["cuda"][n] for n in kept],
                                              [grads[run][n] for n in kept])))
                for run in ("cpu", "cpu_own_masks")}
    worst = {run: sorted(e.items(), key=lambda kv: -kv[1]) for run, e in grad_err.items()}
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    buffer_err = {n: ((b - buffers["cpu"][n]).abs() / (1 + buffers["cpu"][n].abs())).max().item()
                  for n, b in buffers["cuda"].items() if b.is_floating_point()}
    # Adam moves each element by about lr a step whatever its gradient's
    # size, so an element whose gradient is within rounding of 0 may move
    # either way on the two devices; every other element moves alike
    lr = trainers["cpu"].lr_schedule(0)
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().flatten() for a, b in zip(
        trainers["cuda"].optimizer.params, trainers["cpu"].optimizer.params)])
    moved_apart = float((diffs > 1e-2 * lr).float().mean())
    summary = (f"losses {losses}; parameters after two steps: max diff {diffs.max().item()}, "
               f"share apart by more than lr/100 {moved_apart} (lr {lr}); flips {flips}")
    check(worst["cpu"][0][1] <= GRAD_TOLERANCE,
          f"{what}: gradient leaves card vs CPU, error / max |g|: {worst['cpu'][:5]}; "
          f"with the CPU's own masks {worst['cpu_own_masks'][:3]}; {summary}")
    check(max(zero_err.values(), default=0) <= GRAD_TOLERANCE,
          f"{what}: leaves of exact-zero gradient, |g| / max |g| of any leaf: {zero_err}")
    check(max(loss_err) <= 1e-5, f"{what}: loss error {loss_err}; {summary}")
    check(max(buffer_err.values(), default=0) <= 1e-5,
          f"{what}: buffers after the first step card vs CPU: "
          f"{sorted(buffer_err.items(), key=lambda kv: -kv[1])[:5]}")
    check(diffs.max().item() <= 2 * 2 * lr and moved_apart <= 1e-3, f"{what}: {summary}")
    extra = finish(trainers) if finish is not None else {}
    del trainers
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "loss_rel_err": loss_err,
            "grad_err_over_max": dict(worst["cpu"][:8]),
            "grad_err_over_max_cpu_own_masks": dict(worst["cpu_own_masks"][:8]),
            "exact_zero_grad_over_max": zero_err,
            "buffer_max_err": max(buffer_err.values(), default=None),
            "trainable_leaves": len(names), "relu_mask_flips": flips, "replayed": list(replayed),
            "relu_mask_outputs": outputs, "grad_tolerance": GRAD_TOLERANCE,
            "params_max_abs_diff": diffs.max().item(),
            "params_share_apart_over_lr_100": moved_apart, "lr": lr, "tf32": False, **extra}


def phase_train_parity(tmp: Path):
    """DecompTrainer on the card and on the CPU at full width, B=2, T=3 (the
    first frame 3 iterations, the others 1), the same initial weights, video
    and slot noise, warmup off (``trainer_parity``). Off the main path."""
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    exp = train_experiment(tmp / "train_parity", tmp / "none", batch_size=2, lr_warmup=False)
    gen = torch.Generator().manual_seed(SEED + 8)
    video = torch.rand((2, 3, CONV5_RES, CONV5_RES, 3), generator=gen)
    noise = [torch.randn((2, 8, 128), generator=gen) for _ in range(2)]

    def make(dev):
        tr = DecompTrainer(exp, device=dev)
        tr.setup_model()
        return tr

    res = trainer_parity("train parity", make, lambda tr, dev, i: float(
        tr.train_step(video.to(dev), noise[i])["_total"]))
    emit({"phase": "train_parity", "B": 2, "T": 3, **res})


def run_cli(main, argv):
    """``main(argv)`` of a training CLI with its output echoed and kept;
    returns (trainer, output)."""
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = main(argv)
    print(buf.getvalue(), end="", flush=True)
    return trainer, buf.getvalue()


def loss_lines(out):
    return [float(line.split("loss=")[1]) for line in out.splitlines() if "loss=" in line]


def phase_train(exp_path):
    """The 02 CLI at B=64, T=8 over TRAIN_VIDEOS training videos (5 steps
    after one B=64 valid batch): the train path's main path. Then a second
    run resumes from ``checkpoint_last_saved`` for a second epoch. Returns
    the main path's launches."""
    from textocvp_tpu_torch.cli import train_decomp
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.ops import conv5 as c5

    steps, valid = TRAIN_VIDEOS // TRAIN_BATCH, TRAIN_VALID_VIDEOS // TRAIN_BATCH
    reset_launches()  # the main path starts here
    c5.conv5_input_grad_cuda.launches = 0
    t = time.perf_counter()
    trainer, out = run_cli(train_decomp.main, ["-d", str(exp_path)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    input_grad = c5.conv5_input_grad_cuda.launches
    # and the TensorBoard image strip of iteration 0 (one sequence's forward)
    # where tensorboard imports
    strips = trainer.image_strips
    want = {"slot_attention": TRAIN_FRAMES * (valid + steps + strips), "vit_attention": 0,
            "conv5": 3 * (valid + strips) + 6 * steps}
    check(counts == want and input_grad == 3 * steps and strips == int(trainer.writer is not None),
          f"train: kernel launches on the main path {counts}, input-gradient {input_grad}, "
          f"image strips {strips}; want {want}, {3 * steps}")
    losses = loss_lines(out)
    check(len(losses) == steps and bool(np.isfinite(losses).all()), f"train losses {losses}")
    check(trainer.global_step == valid + steps and trainer.optimizer.count == steps,
          f"train: step {trainer.global_step}, updates {trainer.optimizer.count}")
    models = Experiment(exp_path).models_dir
    for name in ("checkpoint_last_saved.pt", "checkpoint_epoch_final.pt"):
        check((models / name).is_file(), f"train: {name} not written")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    exp = Experiment(exp_path)
    params = exp.params
    params["training"]["num_epochs"] = 2
    exp.save_params(params)
    t = time.perf_counter()
    resumed, out2 = run_cli(train_decomp.main, ["-d", str(exp_path), "--checkpoint",
                                                "checkpoint_last_saved", "--resume_training"])
    resume_seconds = time.perf_counter() - t
    losses2 = loss_lines(out2)
    check("Resuming training from epoch 1" in out2 and resumed.start_epoch == 1
          and resumed.global_step == 2 * (valid + steps) and resumed.optimizer.count == 2 * steps,
          f"resume: epoch {resumed.start_epoch}, step {resumed.global_step}, "
          f"updates {resumed.optimizer.count}")
    check(len(losses2) == steps and bool(np.isfinite(losses2).all()), f"resumed losses {losses2}")
    emit({"phase": "train", "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "train_videos": TRAIN_VIDEOS, "valid_videos": TRAIN_VALID_VIDEOS,
          "cli_seconds": seconds, "resume_cli_seconds": resume_seconds, "launches": counts,
          "image_strips": strips,
          "conv5_input_grad_launches": input_grad, "losses": losses, "resumed_losses": losses2,
          "epoch_lines": [line for line in (out + out2).splitlines() if line.startswith("Epoch")]})
    return counts, input_grad, resumed


def phase_train_sign(exp_path, videos):
    """20 steps on one fixed batch of 8 at lr 4e-4, no warmup: the loss must
    fall. Off the main path."""
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    tr = DecompTrainer(exp_path)
    tr.training_params.update(lr=4e-4, lr_warmup=False)
    tr.setup_model()
    batch = tr.to_device(videos[:8])
    losses = [float(tr.train_step(batch)["_total"]) for _ in range(20)]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"sign check: the loss did not fall over 20 steps: {losses}")
    emit({"phase": "train_sign", "batch": 8, "frames": TRAIN_FRAMES, "lr": 4e-4, "steps": 20,
          "losses": losses})


def launch_counts():
    """(slot-attention launches, conv5 launches, conv5 input-gradient
    launches, conv5 weight-gradient calls) so far."""
    from textocvp_tpu_torch.ops import conv5 as c5
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak

    return (sak.slot_attention_cuda.launches, c5.conv5_cuda.launches,
            c5.conv5_input_grad_cuda.launches, c5.conv5_weight_grad.calls)


def steady_steps(step, reps=2, warm=True):
    """``step()`` once to warm up (unless ``warm`` is False: a trainer that
    its CLI run has just trained on the same shapes), then ``reps`` times on
    the host clock with synchronize: (ms of each, peak GB of the timed
    steps)."""
    if warm:
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(reps):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
    return step_ms, torch.cuda.max_memory_allocated() / 2**30


def split_ms(names, stages):
    """Run ``stages`` in turn with synchronize around each: {name: ms}."""
    torch.cuda.synchronize()
    marks = [time.perf_counter()]
    for stage in stages:
        stage()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    return dict(zip(names, (1e3 * (b - a) for a, b in zip(marks[:-1], marks[1:]))))


def profiled_step(step, top=15, cpu=True):
    """One ``step()`` under torch.profiler (a whole trace, ``traced``): its
    wall ms, device busy ms, idle share and device ops, the ``top`` device
    kernels by time, and ``entries(name)``: the device kernels whose name
    holds ``name``. Without ``cpu`` the trace holds the device's activity
    only (with the host's ops too, a CLIPort predictor step of 100,000
    device kernels took a minute to read)."""
    prof, wall_ms, spins = traced(step, cpu)
    dev = device_records(prof)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3

    def entries(name):
        return [{"name": e.key[:60], "count": e.count, "ms": e.self_device_time_total / 1e3}
                for e in dev if name in e.key]

    ranked = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {"profiled_step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms, "device_ops": sum(e.count for e in dev),
            "trace_fence_spins": spins,
            "top": [{"name": e.key[:90], "count": e.count, "ms": e.self_device_time_total / 1e3}
                    for e in ranked]}, entries


def phase_train_step(trainer, videos):
    """The steady train step at B=64, T=8 on the resumed trainer: two
    steps on the host clock with synchronize, one split into forward,
    backward and optimizer, the peak memory, the launches of a step, and
    one step under torch.profiler. Off the main path."""
    batch = trainer.to_device(videos)
    step_ms, peak_gb = steady_steps(lambda: trainer.train_step(batch), warm=False)
    before = launch_counts()
    noise = trainer._noise(batch.shape[0])
    out = {}

    def forward():
        trainer.optimizer.zero_grad()
        out["total"] = trainer.forward_loss(batch, noise)[0]

    split = split_ms(("forward", "backward", "optimizer"),
                     (forward, lambda: out.pop("total").backward(), trainer.optimizer.step))
    per_step = tuple(a - b for a, b in zip(launch_counts(), before))
    check(per_step == (TRAIN_FRAMES, 6, 3, 3),
          f"train step launches (slot attention, conv5, conv5 input gradient, weight-gradient "
          f"calls): {per_step}")
    prof, entries = profiled_step(lambda: trainer.train_step(batch))
    slot_attention = entries(SLOT_ATTENTION_KERNEL)
    conv5 = entries("conv5_kernel")
    check(sum(e["count"] for e in slot_attention) == TRAIN_FRAMES
          and sum(e["count"] for e in conv5) == 6,
          f"train step device kernels: slot attention {slot_attention}, conv5 {conv5}")
    mean_ms = sum(step_ms) / len(step_ms)
    emit({"phase": "train_step", "batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
          "step_ms": step_ms, "train_frames_per_s": 1e3 * TRAIN_BATCH * TRAIN_FRAMES / mean_ms,
          "split_ms": split, "peak_mem_gb": peak_gb,
          "launches_per_step": dict(zip(("slot_attention", "conv5", "conv5_input_grad",
                                         "conv5_weight_grad_calls"), per_step)),
          **prof, "slot_attention": slot_attention, "conv5": conv5,
          "index_kernels": entries("index")})  # the decoder's tile gather and its backward


def run_train(tmp: Path):
    """The train path: card-against-CPU parity, the fixture, the main path
    (the 02 CLI and its resume), the sign check, the steady step. Returns
    the main path's launches, its conv5 input-gradient launches and the
    trained experiment (its ``checkpoint_epoch_final.pt`` is the predictor
    path's frozen SAVi)."""
    phase_train_parity(tmp)
    data_root = write_cater_fixture(tmp / "CATER_train", (("train", TRAIN_VIDEOS),
                                                          ("test", TRAIN_VALID_VIDEOS)))
    exp_path = train_experiment(tmp / "train", data_root)
    counts, input_grad, trainer = phase_train(exp_path)
    videos, _ = next(iter(trainer.train_loader))
    phase_train_step(trainer, videos)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_sign(train_experiment(tmp / "train_sign", data_root), videos)
    return counts, input_grad, exp_path


def pred_experiment(parent: Path, name: str, num_preds=PRED_PREDS, **training) -> Path:
    """A TextOCVP_T5 predictor experiment at full width nested in the SAVi
    experiment ``parent``: the 04 defaults (c=1, p=9, buffer 10, no teacher
    forcing, Adam lr 1e-4, warmup 2000, cosine, clip 0.05, ``pred_img_mse`` +
    ``pred_slot_mse``), B=64, one epoch, with ``num_preds`` and ``training``
    over them."""
    from textocvp_tpu_torch.core.config import add_predictor_params
    from textocvp_tpu_torch.core.experiment import Experiment

    params = add_predictor_params(Experiment(parent).params, "TextOCVP_T5")
    params["prediction_params"]["num_preds"] = num_preds
    params["training"].update({"batch_size": TRAIN_BATCH, "num_epochs": 1, "log_frequency": 1,
                               "save_frequency": 1, **training})
    exp = Experiment(parent / "predictors" / name)
    exp.save_params(params)
    return exp.exp_path


def caption_batch(exp_params, b, path=PATHS[0]):
    """``b`` captions of ``path`` through the tokenizer of ``exp_params``'
    dataset (``serving_tokenizer``): {key of TEXT_KEYS: tensor}, each (b, L)
    array padded to MAX_TOKENS."""
    from textocvp_tpu_torch.data.tokenizers import TEXT_KEYS
    from textocvp_tpu_torch.serve.pipeline import serving_tokenizer

    tok = serving_tokenizer(exp_params)([path.captions[i % len(path.captions)]
                                         for i in range(b)])
    out = {}
    for k in TEXT_KEYS:
        if tok.get(k) is not None:
            v = np.asarray(tok[k])
            out[k] = torch.from_numpy(np.pad(v, ((0, 0), (0, MAX_TOKENS - v.shape[1])))
                                      if v.ndim == 2 else v)
    return out


def rows(info, n):
    """The first ``n`` rows of a loader batch's caption arrays (``TEXT_KEYS``
    the tokenizer filled)."""
    from textocvp_tpu_torch.data.tokenizers import TEXT_KEYS

    return {k: np.asarray(info[k])[:n] for k in TEXT_KEYS if info.get(k) is not None}


def random_predictor_(trainer):
    """Scale the trainer's random predictor's output projection by
    PRED_OUT_SCALE, as ``random_models`` does: Xavier draws alone grow the
    slots about 1.7x a rollout step, to 1e3 by step 9."""
    with torch.no_grad():
        trainer.model.predictor.mlp_out.weight.mul_(PRED_OUT_SCALE)


def phase_pred_train_parity(parent: Path):
    """PredictorTrainer on the card and on the CPU at full width, B=2, c=1,
    p=PARITY_PREDS, the frozen SAVi of ``parent``'s ``checkpoint_epoch_final``, the same
    predictor weights, video, captions and slot noise, warmup off
    (``trainer_parity``; the predictor's 16 MLPs a rollout step are where
    most of its ReLU masks differ between the devices). Off the main path.

    At lr 1e-5: the second loss is taken after an update in which Adam
    moved the elements whose gradient is within rounding of 0 by up to lr
    either way on the two devices; at lr 1e-4 that alone put the second loss
    4.9e-5 apart (relative) with every gradient leaf within its limit, at
    1e-5 it is a tenth of that."""
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    exp = pred_experiment(parent, "pred_parity", PARITY_PREDS, batch_size=2, lr=1e-5,
                          lr_warmup=False)
    gen = torch.Generator().manual_seed(SEED + 10)
    video = torch.rand((2, PRED_CONTEXT + PARITY_PREDS, CONV5_RES, CONV5_RES, 3), generator=gen)
    noise = [torch.randn((2, 8, 128), generator=gen) for _ in range(2)]
    text = caption_batch(Experiment(exp).params, 2)

    def make(dev):
        tr = PredictorTrainer(exp, "checkpoint_epoch_final", device=dev)
        tr.setup_model()
        random_predictor_(tr)
        return tr

    def step(tr, dev, i):
        tx = {k: v.to(dev) for k, v in text.items()}
        return float(tr.train_step(video.to(dev), noise[i], **tx)["_total"])

    res = trainer_parity("predictor train parity", make, step)
    emit({"phase": "pred_train_parity", "B": 2, "num_context": PRED_CONTEXT,
          "num_preds": PARITY_PREDS, **res})


def phase_pred_train(parent: Path, exp_path: Path, steps: int, phase="pred_train", **extra):
    """The 04 CLI at B=64, c=1, p=9 on the predictor experiment ``exp_path``
    nested in ``parent`` (``steps`` steps after one B=64 valid batch), its
    frozen SAVi the ``checkpoint_epoch_final.pt`` that the 02 phase wrote: a
    predictor-train path's main path. Then a second run resumes from
    ``checkpoint_last_saved`` for a second epoch, and the 05 CLI evaluates
    the predictor's ``checkpoint_epoch_final`` (B=64, 19 predictions).
    Returns the main path's launches, its conv5 input-gradient launches and
    weight-gradient calls, and the resumed trainer. ``extra`` goes into the
    phase's line."""
    from textocvp_tpu_torch.cli import evaluate_predictor, train_predictor
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.ops import conv5 as c5

    argv = ["-d", str(parent), "--name_pred_exp", exp_path.name, "--decomp_ckpt",
            "checkpoint_epoch_final"]
    valid = TRAIN_VALID_VIDEOS // TRAIN_BATCH
    reset_launches()  # the main path starts here
    c5.conv5_input_grad_cuda.launches = 0
    c5.conv5_weight_grad.calls = 0
    t = time.perf_counter()
    trainer, out = run_cli(train_predictor.main, argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    input_grad, weight_grad = c5.conv5_input_grad_cuda.launches, c5.conv5_weight_grad.calls
    # and the image strip of iteration 0 where tensorboard imports: one
    # sequence encoded, rolled out and its predictions decoded
    strips = trainer.image_strips
    want = {"slot_attention": PRED_FRAMES * (valid + steps + strips), "vit_attention": 0,
            "conv5": 3 * (valid + strips) + 6 * steps}
    what = f"{phase} {exp_path.name}"
    check(strips == int(trainer.writer is not None), f"{what}: {strips} image strips")
    check(counts == want and input_grad == 3 * steps and weight_grad == 0,
          f"{what}: kernel launches on the main path {counts}, input-gradient {input_grad}, "
          f"weight-gradient calls {weight_grad}; want {want}, {3 * steps}, 0")
    losses = loss_lines(out)
    check(len(losses) == steps and bool(np.isfinite(losses).all()), f"{what} losses {losses}")
    check(trainer.global_step == valid + steps and trainer.optimizer.count == steps,
          f"{what}: step {trainer.global_step}, updates {trainer.optimizer.count}")
    exp = Experiment(exp_path)
    for name in ("checkpoint_last_saved.pt", "checkpoint_epoch_1.pt", "checkpoint_epoch_final.pt"):
        check((exp.models_dir / name).is_file(), f"{what}: {name} not written")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    params = exp.params
    params["training"]["num_epochs"] = 2
    exp.save_params(params)
    t = time.perf_counter()
    resumed, out2 = run_cli(train_predictor.main, argv + ["--checkpoint", "checkpoint_last_saved",
                                                          "--resume_training"])
    resume_seconds = time.perf_counter() - t
    losses2 = loss_lines(out2)
    check("Resuming training from epoch 1" in out2 and resumed.start_epoch == 1
          and resumed.global_step == 2 * (valid + steps) and resumed.optimizer.count == 2 * steps,
          f"{what} resume: epoch {resumed.start_epoch}, step {resumed.global_step}, "
          f"updates {resumed.optimizer.count}")
    check(len(losses2) == steps and bool(np.isfinite(losses2).all()),
          f"{what} resumed losses {losses2}")

    t = time.perf_counter()
    evaluate_predictor.main(["-d", str(parent), "--name_pred_exp", exp_path.name, "--decomp_ckpt",
                             "checkpoint_epoch_final", "--pred_ckpt", "checkpoint_epoch_final",
                             "--batch_size", str(EVAL_BATCH), "--num_seed", "1",
                             "--num_preds", str(EVAL_PREDS)])
    eval_seconds = time.perf_counter() - t
    results_dir = exp_path / "results" / (
        f"eval_pred_checkpoint_epoch_final_NumSeed=1_NumPreds={EVAL_PREDS}")
    with open(results_dir / "results.json") as f:
        results = json.load(f)
    for m in ("psnr", "ssim", "lpips"):
        vals = results[m]["framewise"] + [results[m]["mean"]]
        check(len(results[m]["framewise"]) == EVAL_PREDS and bool(np.isfinite(vals).all()),
              f"{what}: 05 on the 04 checkpoint: {m} {results[m]}")
    check_framewise_plots(results_dir, results, f"{what}: 05 on the 04 checkpoint")
    emit({"phase": phase, **extra, "batch": TRAIN_BATCH, "num_context": PRED_CONTEXT,
          "num_preds": PRED_PREDS, "train_videos": steps * TRAIN_BATCH,
          "valid_videos": TRAIN_VALID_VIDEOS, "decomp_ckpt": "checkpoint_epoch_final (02 phase)",
          "cli_seconds": seconds, "resume_cli_seconds": resume_seconds, "launches": counts,
          "image_strips": strips,
          "conv5_input_grad_launches": input_grad, "conv5_weight_grad_calls": weight_grad,
          "losses": losses, "resumed_losses": losses2,
          "epoch_lines": [line for line in (out + out2).splitlines() if line.startswith("Epoch")],
          "eval_cli_seconds": eval_seconds,
          "eval_means": {m: results[m]["mean"] for m in ("psnr", "ssim", "lpips")}})
    return counts, input_grad, weight_grad, resumed


def phase_pred_train_step(trainer, videos, info, phase="pred_train_step", **extra):
    """The steady predictor step at B=64 on the resumed trainer: two steps
    on the host clock with synchronize, one split into frozen encode,
    forward (rollout, decode, loss), backward and optimizer, the peak memory,
    the launches of a step, and one step under torch.profiler. Off the main
    path. ``extra`` goes into the phase's line."""
    batch, text = trainer.batch_to_device(videos, info)
    step_ms, peak_gb = steady_steps(lambda: trainer.train_step(batch, **text), warm=False)
    before = launch_counts()
    noise = trainer._noise(batch.shape[0])
    out = {}

    def encode():
        trainer.optimizer.zero_grad()
        out["slots"] = trainer.encode(batch, noise)

    def forward():
        out["total"] = trainer.predict_loss(batch, out.pop("slots"), **text)[0]

    split = split_ms(("frozen_encode", "forward", "backward", "optimizer"),
                     (encode, forward, lambda: out.pop("total").backward(),
                      trainer.optimizer.step))
    per_step = tuple(a - b for a, b in zip(launch_counts(), before))
    check(per_step == (PRED_FRAMES, 6, 3, 0),
          f"predictor step launches (slot attention, conv5, conv5 input gradient, weight-"
          f"gradient calls): {per_step}")
    prof, entries = profiled_step(lambda: trainer.train_step(batch, **text))
    slot_attention = entries(SLOT_ATTENTION_KERNEL)
    conv5 = entries("conv5_kernel")
    check(sum(e["count"] for e in slot_attention) == PRED_FRAMES
          and sum(e["count"] for e in conv5) == 6,
          f"predictor step device kernels: slot attention {slot_attention}, conv5 {conv5}")
    mean_ms = sum(step_ms) / len(step_ms)
    emit({"phase": phase, **extra, "batch": TRAIN_BATCH, "num_context": PRED_CONTEXT,
          "num_preds": PRED_PREDS, "step_ms": step_ms,
          "pred_train_frames_per_s": 1e3 * TRAIN_BATCH * PRED_PREDS / mean_ms,
          "split_ms": split, "peak_mem_gb": peak_gb, "accum_steps": trainer.accum,
          "launches_per_step": dict(zip(("slot_attention", "conv5", "conv5_input_grad",
                                         "conv5_weight_grad_calls"), per_step)),
          **prof, "device_idle_share_of_mean_step": 1 - prof["device_busy_ms"] / mean_ms,
          "slot_attention": slot_attention, "conv5": conv5})


def phase_pred_train_sign(parent: Path, videos, info):
    """20 predictor steps on one fixed batch of 8 at lr 1e-4, no warmup, the
    random predictor's output projection scaled (``random_predictor_``): the
    loss must fall. Off the main path."""
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    tr = PredictorTrainer(pred_experiment(parent, "pred_sign", batch_size=8, lr=1e-4,
                                          lr_warmup=False), "checkpoint_epoch_final")
    tr.setup_model()
    random_predictor_(tr)
    batch, text = tr.batch_to_device(videos[:8], rows(info, 8))
    losses = [float(tr.train_step(batch, **text)["_total"]) for _ in range(20)]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"predictor sign check: the loss did not fall over 20 steps: {losses}")
    emit({"phase": "pred_train_sign", "batch": 8, "num_preds": PRED_PREDS, "lr": 1e-4,
          "steps": 20, "losses": losses})


def run_pred_train(parent: Path):
    """The predictor-train path over the 02 phase's experiment ``parent``:
    card-against-CPU parity, the main path (the 04 CLI, its resume and the
    05 CLI on its checkpoint), the steady step, the sign check. Returns the
    main path's launches, conv5 input-gradient launches and weight-gradient
    calls."""
    phase_pred_train_parity(parent)
    counts, input_grad, weight_grad, trainer = phase_pred_train(
        parent, pred_experiment(parent, PRED_NAME), TRAIN_VIDEOS // TRAIN_BATCH)
    videos, info = next(iter(trainer.train_loader))
    phase_pred_train_step(trainer, videos, info)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    phase_pred_train_sign(parent, videos, info)
    return counts, input_grad, weight_grad


# ------------------------------------------------------------ the other predictors

OTHER_PREDICTORS = ("VanillaTransformer", "OCVPSeq", "OCVPPar", "TextOCVP_CustomTF")
SERVED_OTHERS = ("OCVPSeq", "TextOCVP_CustomTF")
OTHER_TRAIN_STEPS = 2  # steps of the 04 CLI's first run, after one valid batch


def other_experiment(parent: Path, name: str, data_root, tag: str, num_preds=PRED_PREDS,
                     **training):
    """The predictor experiment ``<name>_<tag>`` nested in the SAVi experiment
    ``parent``: the published config of predictor ``name`` at full width,
    c=1, p=9, buffer 10, Adam lr 1e-4, warmup 2000, cosine, clip 0.05, B=64,
    one epoch, with ``num_preds`` and ``training`` over them, over the CATER
    set at ``data_root``; TextOCVP_CustomTF's dataset tokenizes with the
    CustomTokenizer (CATER_Easy vocabulary)."""
    from textocvp_tpu_torch.core.config import add_predictor_params
    from textocvp_tpu_torch.core.experiment import Experiment

    params = add_predictor_params(Experiment(parent).params, name)
    params["prediction_params"]["num_preds"] = num_preds
    params["dataset"]["root"] = str(data_root)
    if name == "TextOCVP_CustomTF":
        params["dataset"]["tokenizer"] = "CustomTokenizer"
    params["training"].update({"batch_size": TRAIN_BATCH, "num_epochs": 1, "log_frequency": 1,
                               "save_frequency": 1, **training})
    exp = Experiment(parent / "predictors" / f"{name}_{tag}")
    exp.save_params(params)
    exp.models_dir.mkdir(parents=True, exist_ok=True)
    return exp


def phase_predictors_parity(name, exp):
    """The rollout of a random predictor (``random_predictor``) on the card
    and on the CPU at B=2, 19 steps, the same weights, slots and captions,
    TF32 off: each step's error within 1e-4 of that step's largest slot.
    Off the main path."""
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 20)
    predictor = random_predictor(exp.params, gen)
    hist = torch.randn((2, PRED_CONTEXT, 8, 128), generator=gen)
    text = caption_batch(exp.params, 2)
    with torch.inference_mode():
        ref = predictor(hist, num_preds=EVAL_PREDS, **text)
        card = copy.deepcopy(predictor).cuda()
        out = card(hist.cuda(), num_preds=EVAL_PREDS,
                   **{k: v.cuda() for k, v in text.items()}).cpu()
    check(bool(torch.isfinite(out).all()), f"{name}: card pred_slots not finite")
    step_err = (out - ref).abs().amax(dim=(0, 2, 3))
    step_ref = ref.abs().amax(dim=(0, 2, 3))
    ratios = (step_err / step_ref).tolist()
    check(max(ratios) <= 1e-4,
          f"{name}: pred_slots card vs CPU, error / max|ref| per step: {ratios}")
    emit({"phase": "predictors_parity", "predictor": name, "B": 2, "num_preds": EVAL_PREDS,
          "text_keys": sorted(text), "pred_slots_max_abs_err": step_err.max().item(),
          "pred_slots_max_abs_ref_per_step": step_ref.tolist(),
          "pred_slots_err_ratio_per_step": ratios, "pred_slots_ratio_tolerance": 1e-4,
          "tf32": False})


def phase_predictors_eval(parent: Path, name, exp):
    """The 05 CLI at B=64, p=19 over EVAL_VIDEOS videos on the random
    predictor ``exp`` holds as ``random`` and the frozen SAVi of ``parent``:
    a main path. Then one more batch split into its stages and profiled
    (``phase_eval_step``). Returns the main path's launches."""
    from textocvp_tpu_torch.cli import evaluate_predictor

    ckpts = ("checkpoint_epoch_final", "random")
    reset_launches()  # the main path starts here
    t = time.perf_counter()
    rc = evaluate_predictor.main(["-d", str(parent), "--name_pred_exp", exp.exp_path.name,
                                  "--decomp_ckpt", ckpts[0], "--pred_ckpt", ckpts[1],
                                  "--batch_size", str(EVAL_BATCH), "--num_seed", "1",
                                  "--num_preds", str(EVAL_PREDS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    batches = EVAL_VIDEOS // EVAL_BATCH
    check(rc == 0 and counts == {"slot_attention": batches, "vit_attention": 0,
                                 "conv5": 3 * batches},
          f"predictors_eval {name}: kernel launches on the main path: {counts}")
    results_dir = exp.exp_path / "results" / f"eval_pred_random_NumSeed=1_NumPreds={EVAL_PREDS}"
    with open(results_dir / "results.json") as f:
        results = json.load(f)
    for m in ("psnr", "ssim", "lpips"):
        vals = results[m]["framewise"] + [results[m]["mean"]]
        check(len(results[m]["framewise"]) == EVAL_PREDS and bool(np.isfinite(vals).all()),
              f"predictors_eval {name} results.json: {m} {results[m]}")
    check_framewise_plots(results_dir, results, f"predictors_eval {name}")
    emit({"phase": "predictors_eval", "predictor": name, "batch": EVAL_BATCH,
          "videos": EVAL_VIDEOS, "num_seed": 1, "num_preds": EVAL_PREDS, "cli_seconds": seconds,
          "launches": counts, "means": {m: results[m]["mean"] for m in ("psnr", "ssim", "lpips")}})
    gc.collect()
    torch.cuda.empty_cache()
    phase_eval_step(parent, exp.exp_path.name, ckpts, phase="predictors_eval_step",
                    predictor=name)
    return counts


def phase_predictors_service(parent: Path, name, exp):
    """A ``PredictionService`` (batch 8, 24 tokens, 19 predictions) of the
    random predictor ``exp`` holds and the frozen SAVi of ``parent``: its
    warmup and three requests (8 rows float32, 3 rows uint8, 8 rows), each
    with 1 slot-attention call and 3 conv5 launches: a main path. A closed
    vocabulary refuses a word outside it before any launch. Returns the main
    path's launches."""
    from textocvp_tpu_torch.serve import PredictionService

    per_request = {"slot_attention": 1, "vit_attention": 0, "conv5": 3}
    reset_launches()  # the main path starts here
    t = time.perf_counter()
    service = PredictionService(parent, exp.exp_path.name, "checkpoint_epoch_final", "random",
                                num_preds=EVAL_PREDS, batch_size=BATCH, max_tokens=MAX_TOKENS,
                                device="cuda")
    load_s = time.perf_counter() - t
    rng = np.random.default_rng(SEED + 3)
    video = rng.uniform(0, 1, (BATCH, 1, CONV5_RES, CONV5_RES, 3)).astype(np.float32)
    captions = list(PATHS[0].captions[:BATCH])
    requests = (("warmup", None, 1), ("8_float32", video, BATCH),
                ("3_uint8", np.round(video[:3] * 255).astype(np.uint8), 3),
                ("8_float32_again", video, BATCH))
    request_ms, unsaturated = {}, []
    for label, frames, rows in requests:
        before = launches()
        t = time.perf_counter()
        if frames is None:
            service.warmup()
        else:
            out = service.predict(frames, captions[:rows])
        request_ms[label] = 1e3 * (time.perf_counter() - t)
        after = launches()
        for k, n in per_request.items():
            check(after[k] - before[k] == n,
                  f"predictors_service {name}: {after[k] - before[k]} {k} launches in a "
                  f"request, want {n}")
        if frames is None:
            continue
        check(out.shape == (rows, EVAL_PREDS, CONV5_RES, CONV5_RES, 3)
              and bool(np.isfinite(out).all()) and out.min() >= 0 and out.max() <= 1,
              f"predictors_service {name}: output {out.shape} not finite in [0, 1]")
        inside = float(((out > 0) & (out < 1)).mean())
        check(inside >= 0.05, f"predictors_service {name}: share inside (0, 1) {inside}")
        unsaturated.append(inside)
    counts = launches()  # and ends here
    check(counts == {k: len(requests) * n for k, n in per_request.items()},
          f"predictors_service {name}: kernel launches on the main path: {counts}")
    refused = None
    if name == "TextOCVP_CustomTF":
        try:
            service.predict(video[:1], ["warmup"])
        except ValueError as e:
            refused = str(e)
        check(refused is not None and launches() == counts,
              f"predictors_service {name}: an out-of-vocabulary caption was not refused")
    emit({"phase": "predictors_service", "predictor": name, "batch": BATCH,
          "num_preds": EVAL_PREDS, "load_s": load_s, "request_ms": request_ms,
          "unsaturated_share": unsaturated, "launches": counts,
          "tokenizer": type(service.tokenizer).__name__,
          "warmup_caption": service._warmup_caption(), "out_of_vocabulary": refused})
    del service
    torch.cuda.empty_cache()
    return counts


def phase_predictors_train_parity(parent: Path, name):
    """PredictorTrainer on the card and on the CPU at full width, B=2, c=1,
    p=PARITY_PREDS, lr 1e-5, warmup off, a random predictor ``name`` through the frozen
    SAVi of ``parent``, the same weights, video, captions and slot noise
    (``trainer_parity``), the CPU with the card's masks of conv5, each
    ``MLP`` and each torch-style feed-forward ReLU (its own-mask result
    reported); the attention key biases are exact-zero leaves. Off the main
    path."""
    from textocvp_tpu_torch.models import setup_predictor
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    exp = other_experiment(parent, name, parent / "none", "parity", PARITY_PREDS,
                           batch_size=2, lr=1e-5, lr_warmup=False)
    gen = torch.Generator().manual_seed(SEED + 21)
    video = torch.rand((2, PRED_CONTEXT + PARITY_PREDS, CONV5_RES, CONV5_RES, 3), generator=gen)
    noise = [torch.randn((2, 8, 128), generator=gen) for _ in range(2)]
    text = caption_batch(exp.params, 2)
    key_biases = tuple(n for n, _ in setup_predictor(exp.params).named_parameters()
                       if n.endswith(".k.bias"))

    def make(dev):
        tr = PredictorTrainer(exp.exp_path, "checkpoint_epoch_final", device=dev)
        tr.setup_model()
        random_predictor_(tr)
        return tr

    def step(tr, dev, i):
        tx = {k: v.to(dev) for k, v in text.items()}
        return float(tr.train_step(video.to(dev), noise[i], **tx)["_total"])

    res = trainer_parity(f"{name} train parity", make, step, exact_zero=key_biases,
                         replayed=PREDICTOR_KINKS)
    emit({"phase": "predictors_train_parity", "predictor": name, "B": 2,
          "num_context": PRED_CONTEXT, "num_preds": PARITY_PREDS, "text_keys": sorted(text),
          **res})


def run_predictors(tmp: Path, parent: Path):
    """The four other predictors through the frozen SAVi of the 02 phase's
    experiment ``parent``: for each, the rollout parity, the 05 path (the
    CLI, then a step split and profiled) over the eval phase's set, the
    service (OCVPSeq and TextOCVP_CustomTF), the 04 parity, and the 04 path
    (the CLI for OTHER_TRAIN_STEPS steps, its resume and the 05 CLI on its
    checkpoint, then the steady step) over a set of its own. Returns each
    main path's launches and, by predictor, the 04 paths' conv5
    input-gradient launches and weight-gradient calls."""
    data_root = write_cater_fixture(tmp / "CATER_predictors", (
        ("train", OTHER_TRAIN_STEPS * TRAIN_BATCH), ("test", TRAIN_VALID_VIDEOS)))
    counts, input_grads, weight_grads = {}, {}, {}
    for name in OTHER_PREDICTORS:
        exp = other_experiment(parent, name, tmp / "CATER", "eval")
        torch.save(random_predictor(exp.params, torch.Generator().manual_seed(SEED + 4))
                   .state_dict(), exp.checkpoint_path("random"))
        phase_predictors_parity(name, exp)
        counts[f"predictors_eval:{name}"] = phase_predictors_eval(parent, name, exp)
        if name in SERVED_OTHERS:
            counts[f"predictors_service:{name}"] = phase_predictors_service(parent, name, exp)
        phase_predictors_train_parity(parent, name)
        exp = other_experiment(parent, name, data_root, "train")
        key = f"predictors_train:{name}"
        counts[key], input_grads[name], weight_grads[name], trainer = phase_pred_train(
            parent, exp.exp_path, OTHER_TRAIN_STEPS, phase="predictors_train", predictor=name)
        videos, info = next(iter(trainer.train_loader))
        phase_pred_train_step(trainer, videos, info, phase="predictors_train_step",
                              predictor=name)
        del trainer, videos, info
        gc.collect()
        torch.cuda.empty_cache()
    return counts, input_grads, weight_grads


# ------------------------------------------------------------ 01 and 03: a user's first day

DECOMP_FRAMES = 8  # configs/datasets/{CATER_Easy,CLIPort}.json num_frames
CLIP_DECOMP_PARITY_FRAMES = 3  # the ViT on the CPU at B=2 is the parity's cost
DECOMP_RESULTS = "results_DecompModel"  # scripts/03_evaluate_decomp_*.sh


@dataclass(frozen=True)
class DecompPath:
    """One 03 path: the experiment the 01 CLI made, the checkpoint a user drops
    into its ``models/`` and the launches of one batch."""
    name: str
    model: str
    dataset: str
    ckpt: str  # the released checkpoint's name (scripts/03_evaluate_decomp_*.sh)
    batch: int
    parity_frames: int
    launches: dict  # a batch's kernel launches


DECOMP_PATHS = {
    "cater": DecompPath("decomp_eval", "SAVi", "CATER_Easy", "SAVi_CATER", EVAL_BATCH,
                        DECOMP_FRAMES, {"slot_attention": DECOMP_FRAMES, "vit_attention": 0,
                                        "conv5": 3}),
    "clipport": DecompPath("clip_decomp_eval", "ExtendedDINOSAUR", "CLIPort",
                           "ExtendedDINOSAUR_CLIPort", CLIP_EVAL_BATCH, CLIP_DECOMP_PARITY_FRAMES,
                           {"slot_attention": DECOMP_FRAMES, "vit_attention": VIT_BLOCKS,
                            "conv5": 0}),
}


def phase_create(tmp: Path):
    """The 01 CLIs as a user runs them: a decomposition experiment a path
    (``--name``), each ``experiment_params.json`` equal to ``build_exp_params``;
    a predictor experiment under the CATER one is refused while its
    ``models/`` is empty, and made with ``--skip_ckpt_check``, its params equal
    to ``add_predictor_params``. Returns {path: experiment}."""
    from textocvp_tpu_torch.cli import create_experiment, create_predictor_experiment
    from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params

    made = {}
    for key, path in DECOMP_PATHS.items():
        exp = create_experiment.main(["-d", str(tmp / "experiments"), "--name", key,
                                      "--model_name", path.model, "--dataset_name", path.dataset])
        written = json.loads((exp.exp_path / "experiment_params.json").read_text())
        check(written == build_exp_params(path.model, path.dataset),
              f"create: {key} experiment_params.json is not build_exp_params")
        check(all((exp.exp_path / d).is_dir() for d in ("models", "plots", "tboard_logs")),
              f"create: {key} directories")
        made[key] = exp.exp_path
    pred_args = ["-d", str(made["cater"]), "--name", PRED_NAME, "--predictor_name", "TextOCVP_T5"]
    try:
        create_predictor_experiment.main(pred_args)
        refused = None
    except FileNotFoundError as e:
        refused = str(e)
    check(refused is not None and "no trained checkpoints" in refused,
          f"create: a parent without a checkpoint was not refused ({refused})")
    pred = create_predictor_experiment.main(pred_args + ["--skip_ckpt_check"])
    check(pred.params == add_predictor_params(build_exp_params("SAVi", "CATER_Easy"),
                                              "TextOCVP_T5"),
          "create: the predictor experiment's params are not add_predictor_params")
    emit({"phase": "create", "experiments": {k: str(v) for k, v in made.items()},
          "predictor": str(pred.exp_path), "refused_without_checkpoint": refused})
    return made


def drop_in(exp_path: Path, path: DecompPath, trained: Path, data_root: Path):
    """What a user does before 03: put the checkpoint in ``models/`` under its
    released name and point the dataset's ``root`` at the data."""
    import shutil

    from textocvp_tpu_torch.core.experiment import Experiment

    exp = Experiment(exp_path)
    shutil.copyfile(trained, exp.checkpoint_path(path.ckpt))
    params = exp.params
    params["dataset"]["root"] = str(data_root)
    exp.save_params(params)


def decomp_evaluator(exp_path, path: DecompPath, device="cuda", batch=None, frames=None):
    from textocvp_tpu_torch.train.evaluator import DecompEvaluator

    ev = DecompEvaluator(exp_path, path.ckpt, batch_size=batch or path.batch, device=device)
    if frames is not None:
        ev.exp_params["dataset"]["num_frames"] = frames
    ev.load_data()
    ev.load_model()
    return ev


def phase_decomp_eval_parity(exp_path, path: DecompPath):
    """The 03 step at B=2 on the card and on the CPU: the same weights,
    initial slots and frames (T=8 on CATER, 3 on CLIPort). Framewise PSNR
    within 1e-3 dB, SSIM and LPIPS within 1e-4, reconstructions within 1e-4
    of their largest value. Off the main path."""
    evs = {dev: decomp_evaluator(exp_path, path, dev, batch=2, frames=path.parity_frames)
           for dev in ("cpu", "cuda")}
    videos, _ = next(iter(evs["cpu"].test_loader))
    init = evs["cpu"].model.slot_initializer(2, torch.Generator().manual_seed(SEED + 7))
    recons, vals = {}, {}
    for dev, ev in evs.items():
        v = ev.to_device(videos)
        rec = ev.reconstruct(v, init)
        vals[dev] = {m: x.cpu() for m, x in ev.metric_tracker.compute(rec, v.clamp(0, 1)).items()}
        recons[dev] = rec.cpu()
    what = f"{path.name}_parity"
    rec_err = ((recons["cuda"] - recons["cpu"]).abs().max() / recons["cpu"].abs().max()).item()
    check(rec_err <= 1e-4, f"{what}: reconstructions card vs CPU {rec_err} of their max > 1e-4")
    tol = {"psnr": 1e-3, "ssim": 1e-4, "lpips": 1e-4}
    errs = {}
    for m, limit in tol.items():
        out, ref = vals["cuda"][m], vals["cpu"][m]
        check(out.shape == (2, path.parity_frames) and bool(torch.isfinite(out).all()),
              f"{what}: {m} {tuple(out.shape)} not finite or misshapen")
        errs[m] = (out - ref).abs().max().item()
        check(errs[m] <= limit, f"{what}: framewise {m} card vs CPU {errs[m]} > {limit}")
    emit({"phase": what, "B": 2, "T": path.parity_frames, "max_abs_err": errs,
          "recons_rel_err": rec_err, "tolerance": tol | {"recons_rel": 1e-4},
          "cpu_framewise_mean": {m: v.mean(0).tolist() for m, v in vals["cpu"].items()}})


def phase_decomp_eval(exp_path, path: DecompPath, videos_in_split: int):
    """The 03 CLI over the test split at the path's batch and T=8: the 03
    path's main path (``scripts/03_evaluate_decomp_*.sh``). Then, off it, one
    batch's steady step on the host clock with synchronize, split into its
    stages, its peak memory, and one step under ``torch.profiler`` with one
    slot-attention device kernel a frame and one ViT-attention kernel a
    block. Returns the main path's launches."""
    from textocvp_tpu_torch.cli import evaluate_decomp

    reset_launches()  # the main path starts here
    t = time.perf_counter()
    rc = evaluate_decomp.main(["-d", str(exp_path), "--decomp_ckpt", path.ckpt, "--results_name",
                               DECOMP_RESULTS, "--batch_size", str(path.batch)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    batches = videos_in_split // path.batch
    check(rc == 0, f"{path.name}: evaluate_decomp returned {rc}")
    check(counts == {k: n * batches for k, n in path.launches.items()},
          f"{path.name}: kernel launches on the main path {counts}, want "
          f"{path.launches} x {batches}")
    results = json.loads((exp_path / "results" / DECOMP_RESULTS / "results.json").read_text())
    for m in ("psnr", "ssim", "lpips"):
        vals = results[m]["framewise"] + [results[m]["mean"]]
        check(len(results[m]["framewise"]) == DECOMP_FRAMES and bool(np.isfinite(vals).all()),
              f"{path.name} results.json: {m} {results[m]}")
    plots = check_framewise_plots(exp_path / "results" / DECOMP_RESULTS, results, path.name)
    gc.collect()
    torch.cuda.empty_cache()

    ev = decomp_evaluator(exp_path, path)
    videos, _ = next(iter(ev.test_loader))
    step_ms, peak_gb = steady_steps(lambda: ev.eval_step(videos))
    out = {}
    split = split_ms(("to_device", "reconstruct", "metrics"), (
        lambda: out.update(v=ev.to_device(videos)),
        lambda: out.update(rec=ev.reconstruct(out["v"])),
        lambda: ev.metric_tracker.compute(out["rec"], out["v"].clamp(0, 1))))
    del out
    prof, entries = profiled_step(lambda: ev.eval_step(videos))
    slot_attention = entries(SLOT_ATTENTION_KERNEL)
    vit = entries(VIT_ATTENTION_KERNEL)
    conv5 = entries("conv5_kernel")
    launched = path.launches
    check_traced(path.name, slot_attention, vit,
                 (launched["slot_attention"], launched["vit_attention"]))
    check(sum(e["count"] for e in conv5) == launched["conv5"],
          f"{path.name}: conv5 device kernels in the trace {conv5}, launched {launched['conv5']}")
    mean_ms = sum(step_ms) / len(step_ms)
    frames = path.batch * DECOMP_FRAMES
    emit({"phase": path.name, "model": path.model, "batch": path.batch, "frames": DECOMP_FRAMES,
          "videos": batches * path.batch, "cli_seconds": seconds, "launches": counts,
          "results": results, "framewise_plots": plots, "step_ms": step_ms,
          "recons_frames_per_s": 1e3 * frames / mean_ms,
          "split_ms": split, "peak_mem_gb": peak_gb, **prof,
          "slot_attention": slot_attention, "vit_attention": vit, "conv5": conv5})
    return counts


def run_decomp_eval(key, exp_path, trained: Path, data_root: Path, videos_in_split: int):
    """A 03 path over the experiment the 01 CLI made: the trained checkpoint
    dropped in, the card-against-CPU parity, then the main path (the 03 CLI)
    and its step. Returns the main path's launches."""
    path = DECOMP_PATHS[key]
    drop_in(exp_path, path, trained, data_root)
    phase_decomp_eval_parity(exp_path, path)
    counts = phase_decomp_eval(exp_path, path, videos_in_split)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- CLIPort chain

CLIP_COLORS = {"train": ("red", "green", "blue", "yellow", "brown", "gray", "cyan"),
               "test": ("red", "green", "blue", "pink", "purple", "orange", "white")}


def write_cliport_fixture(root: Path) -> Path:
    """A CLIPort color-cache set: for each (split, count) of CLIP_EPISODES,
    count episodes of CLIP_EPISODE_FRAMES uint8 336 x 336 frames, four
    coloured blocks sliding over a shaded table with a little noise, as
    ``<root>/<split>/episodeNNNNN/color_cache_336x336.npy``, and
    ``task_description.txt`` in the split's vocabulary (the test split's
    colours are unseen in training). Episodes are drawn 8 at a time."""
    rng = np.random.default_rng(SEED + 20)
    t, r = CLIP_EPISODE_FRAMES, CLIP_RES
    yy, xx = np.meshgrid(np.arange(r, dtype=np.float32), np.arange(r, dtype=np.float32),
                         indexing="ij")
    table = ((0.45 + 0.2 * yy / r + 0.1 * xx / r)[:, :, None]
             * np.array([0.9, 0.8, 0.7], np.float32))
    steps = np.arange(t, dtype=np.float32)[None, :, None, None]
    number = 0
    for split, count in CLIP_EPISODES:
        colors = CLIP_COLORS["test" if split == "test" else "train"]
        for lo in range(0, count, 8):
            v = min(8, count - lo)
            frames = np.broadcast_to(table, (v, t, r, r, 3))
            for _ in range(4):
                color = rng.uniform(0, 1, (v, 1, 1, 1, 3)).astype(np.float32)
                size = rng.integers(12, 28, (v, 1, 1, 1))
                cy, cx = (rng.uniform(40, 296, (v, 1, 1, 1))
                          + rng.uniform(-6, 6, (v, 1, 1, 1)) * steps for _ in range(2))
                inside = (np.abs(yy - cy) < size) & (np.abs(xx - cx) < size)
                frames = np.where(inside[..., None], color, frames)
            frames = frames + 0.02 * rng.standard_normal((t, r, r, 3), dtype=np.float32)
            episodes = np.round(np.clip(frames, 0, 1) * 255).astype(np.uint8)
            for i in range(v):
                ep = root / split / f"episode{number:05d}"
                ep.mkdir(parents=True)
                np.save(ep / f"color_cache_{CLIP_RES}x{CLIP_RES}.npy", episodes[i])
                block, bowl = rng.choice(colors, 2, replace=False)
                (ep / "task_description.txt").write_text(
                    f"put the {block} block in the {bowl} bowl\n")
                number += 1
    return root


def clip_experiment(root: Path, data_root, **training) -> Path:
    """An ExtendedDINOSAUR CLIPort experiment at full width over ``data_root``:
    the 02 defaults (Adam, lr 1e-4, warmup 2000, cosine, clip 0.05,
    ``pred_feature_mse`` + ``mse``), B=64, T=8 with ``random_start``,
    ``accum_steps`` 8, two epochs, with ``training`` over them."""
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.core.experiment import Experiment

    params = build_exp_params("ExtendedDINOSAUR", "CLIPort")
    params["dataset"]["root"] = str(data_root)
    params["training"].update({"batch_size": CLIP_TRAIN_BATCH, "accum_steps": CLIP_ACCUM,
                               "num_epochs": 2, "log_frequency": 1, "save_frequency": 1,
                               **training})
    exp = Experiment(root)
    exp.save_params(params)
    return exp.exp_path


def kept_vit(tr):
    """A copy of the trainer's ViT state, to hold it bit for bit later."""
    return {k: v.detach().cpu().clone() for k, v in tr.model.image_encoder.state_dict().items()}


def phase_clip_train_parity(tmp: Path):
    """DecompTrainer on ExtendedDINOSAUR on the card and on the CPU at full
    width, B=2, T=3, the same initial weights, video and slot noise, warmup
    off (``trainer_parity``: the ReLUs of the projection MLP, the
    transition, the slot-attention MLP, the patch decoder's dense stack and
    the CNN head, and the loss's clips, replayed from the card); the
    BatchNorm statistics after the first step and the ViT bit for bit after
    two. Off the main path."""
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    exp = clip_experiment(tmp / "clip_train_parity", tmp / "none", batch_size=2,
                          accum_steps=1, lr_warmup=False)
    gen = torch.Generator().manual_seed(SEED + 21)
    video = torch.rand((2, 3, CLIP_RES, CLIP_RES, 3), generator=gen)
    noise = [torch.randn((2, CLIP_SLOTS, CLIP_SLOT_DIM), generator=gen) for _ in range(2)]

    def make(dev):
        tr = DecompTrainer(exp, device=dev)
        tr.setup_model()
        tr.vit0 = kept_vit(tr)
        return tr

    def finish(trainers):
        for run, tr in trainers.items():
            now = kept_vit(tr)
            check(all(torch.equal(now[k], v) for k, v in tr.vit0.items()),
                  f"clip train parity: the ViT moved on {run}")
        return {"vit_unchanged": True}

    res = trainer_parity("clip train parity", make, lambda tr, dev, i: float(
        tr.train_step(video.to(dev), noise[i])["_total"]), tail_convs=0,
        exact_zero=CLIP_EXACT_ZERO, finish=finish, replayed=ALL_KINKS)
    emit({"phase": "clip_train_parity", "B": 2, "T": 3, **res})


def phase_clip_train(exp_path):
    """The 02 CLI on ExtendedDINOSAUR at B=64, T=8, ``accum_steps`` 8, over
    the CLIPort set (two epochs of one step after one B=16 valid batch each):
    the CLIPort train path's main path. Then a second run resumes from
    ``checkpoint_last_saved`` for a third epoch. Returns the main path's
    launches and the resumed trainer."""
    from textocvp_tpu_torch.cli import train_decomp
    from textocvp_tpu_torch.core.experiment import Experiment

    epochs = 2
    steps, valid = 1, 1  # an epoch: 64 train episodes, 16 valid
    reset_launches()  # the main path starts here
    t = time.perf_counter()
    trainer, out = run_cli(train_decomp.main, ["-d", str(exp_path)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    # one slot-attention call a frame of a (micro)batch; one ViT call a
    # (micro)batch, one attention launch a block; and each epoch's image
    # strip where tensorboard imports
    strips = trainer.image_strips
    calls = epochs * (steps * CLIP_ACCUM + valid) + strips
    want = {"slot_attention": calls * CLIP_FRAMES, "vit_attention": calls * VIT_BLOCKS,
            "conv5": 0}
    check(counts == want and strips == epochs * int(trainer.writer is not None),
          f"clip_train: kernel launches on the main path {counts}, want {want}; "
          f"{strips} image strips")
    losses = loss_lines(out)
    check(len(losses) == epochs * steps and bool(np.isfinite(losses).all()),
          f"clip_train losses {losses}")
    check(trainer.global_step == epochs * (valid + steps)
          and trainer.optimizer.count == epochs * steps,
          f"clip_train: step {trainer.global_step}, updates {trainer.optimizer.count}")
    models = Experiment(exp_path).models_dir
    for name in ("checkpoint_last_saved.pt", "checkpoint_epoch_2.pt", "checkpoint_epoch_final.pt"):
        check((models / name).is_file(), f"clip_train: {name} not written")
    params = torch.load(models / "checkpoint_epoch_final.pt", weights_only=True)["params"]
    check(any(k.startswith("image_encoder.") for k in params)
          and "patch_decoder.cnns.3.bn.running_var" in params,
          "clip_train: the checkpoint lacks the ViT or the BatchNorm statistics")
    vit = {k: v for k, v in params.items() if k.startswith("image_encoder.")}
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()

    exp = Experiment(exp_path)
    p = exp.params
    p["training"]["num_epochs"] = epochs + 1
    exp.save_params(p)
    t = time.perf_counter()
    resumed, out2 = run_cli(train_decomp.main, ["-d", str(exp_path), "--checkpoint",
                                                "checkpoint_last_saved", "--resume_training"])
    resume_seconds = time.perf_counter() - t
    losses2 = loss_lines(out2)
    check(f"Resuming training from epoch {epochs}" in out2 and resumed.start_epoch == epochs
          and resumed.global_step == (epochs + 1) * (valid + steps)
          and resumed.optimizer.count == (epochs + 1) * steps,
          f"clip_train resume: epoch {resumed.start_epoch}, step {resumed.global_step}, "
          f"updates {resumed.optimizer.count}")
    check(len(losses2) == steps and bool(np.isfinite(losses2).all()),
          f"clip_train resumed losses {losses2}")
    now = resumed.model.image_encoder.state_dict()
    check(all(torch.equal(now[k[len("image_encoder."):]].cpu(), v) for k, v in vit.items()),
          "clip_train: the ViT moved")
    emit({"phase": "clip_train", "batch": CLIP_TRAIN_BATCH, "frames": CLIP_FRAMES,
          "accum_steps": CLIP_ACCUM, "episodes": dict(CLIP_EPISODES),
          "cli_seconds": seconds, "resume_cli_seconds": resume_seconds, "launches": counts,
          "losses": losses, "resumed_losses": losses2,
          "epoch_lines": [line for line in (out + out2).splitlines() if line.startswith("Epoch")]})
    return counts, resumed


def accumulated_split(trainer, b, forward_loss, encode=None):
    """One update of a batch of ``b`` split on the host clock with
    synchronize: each microbatch's (``encode(sl, out)``, the frozen encode,)
    ``forward_loss(sl, out)`` and backward, summed over the microbatches,
    then the optimizer, as ``Trainer.backward`` and ``train_step`` run them;
    ``sl`` is the microbatch's slice of the batch, ``out`` a dict the two
    share."""
    from textocvp_tpu_torch.train.trainer import ragged_accum

    accum = ragged_accum(b, trainer.accum, trainer.training_params["batch_size"])
    mb = b // accum
    names = ("frozen_encode", "forward", "backward") if encode else ("forward", "backward")
    split = dict.fromkeys(names, 0.0)
    trainer.optimizer.zero_grad()
    for i in range(0, b, mb):
        sl, out = slice(i, i + mb), {}
        stages = ([lambda: encode(sl, out)] if encode else []) + [
            lambda: out.update(total=forward_loss(sl, out)),
            lambda: (out.pop("total") / accum).backward()]
        for k, ms in split_ms(names, stages).items():
            split[k] += ms
    split.update(split_ms(("optimizer",), (trainer.optimizer.step,)))
    return split


def launch_counts_clip():
    """(slot-attention launches, ViT-attention launches) so far."""
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak
    from textocvp_tpu_torch.ops import vit_attention as va

    return sak.slot_attention_cuda.launches, va.vit_attention_cuda.launches


def check_traced(what, slot_attention, vit, want):
    """Check the device kernels of a whole trace (``traced``) against the
    launches its call made (``want``: slot attention, ViT attention): one
    slot-attention device kernel a call and one ViT-attention kernel a
    launch, exactly."""
    traced_counts = tuple(sum(e["count"] for e in k) for k in (slot_attention, vit))
    check(traced_counts == tuple(want),
          f"{what}: device kernels in the trace (slot attention, ViT attention) "
          f"{traced_counts}, launched {want}: {slot_attention}, {vit}")
    return traced_counts


def clip_step_report(phase, trainer, run, per_step, want, frames_per_step, step_ms, peak_gb,
                     split):
    """Check a step's launches (``per_step`` against ``want``: slot attention,
    ViT attention) and the device kernels of one profiled step, and emit the
    step's line."""
    check(per_step == want, f"{phase} launches (slot attention, ViT attention): {per_step}, "
                            f"want {want}")
    prof, entries = profiled_step(run, cpu=False)
    slot_attention = entries(SLOT_ATTENTION_KERNEL)
    vit = entries(VIT_ATTENTION_KERNEL)
    counts = check_traced(phase, slot_attention, vit, want)
    mean_ms = sum(step_ms) / len(step_ms)
    emit({"phase": phase, "batch": CLIP_TRAIN_BATCH, "accum_steps": trainer.accum,
          "step_ms": step_ms, "frames_per_s": 1e3 * frames_per_step / mean_ms,
          "split_ms": split, "peak_mem_gb": peak_gb,
          "launches_per_step": dict(zip(("slot_attention", "vit_attention"), per_step)),
          **prof, "device_idle_share_of_mean_step": 1 - prof["device_busy_ms"] / mean_ms,
          "slot_attention": slot_attention, "vit_attention": vit,
          "traced_device_kernels": dict(zip(("slot_attention", "vit_attention"), counts))})


def phase_clip_train_step(trainer, videos):
    """The steady 02 step at B=64, T=8, ``accum_steps`` 8 on the resumed
    trainer: CLIP_STEADY_REPS steps on the host clock with synchronize, one
    split into forward, backward (each summed over the microbatches) and optimizer, the
    peak memory, the launches of a step (one slot-attention call a frame of
    each microbatch, 12 ViT-attention launches a microbatch), and one step
    under torch.profiler. Off the main path."""
    batch = trainer.to_device(videos)
    step_ms, peak_gb = steady_steps(lambda: trainer.train_step(batch), reps=CLIP_STEADY_REPS,
                                    warm=False)
    before = launch_counts_clip()
    noise = trainer._noise(batch.shape[0])
    split = accumulated_split(trainer, batch.shape[0],
                              lambda sl, out: trainer.forward_loss(batch[sl], noise[sl])[0])
    per_step = tuple(a - b for a, b in zip(launch_counts_clip(), before))
    clip_step_report("clip_train_step", trainer, lambda: trainer.train_step(batch), per_step,
                     (CLIP_ACCUM * CLIP_FRAMES, CLIP_ACCUM * VIT_BLOCKS),
                     CLIP_TRAIN_BATCH * CLIP_FRAMES, step_ms, peak_gb, split)


def phase_clip_train_sign(data_root, tmp: Path, videos):
    """10 steps on one fixed batch of 8 (no accumulation) and one fixed draw
    of slot noise at lr 1e-6, no warmup: the loss must fall. The config's
    warmup reaches 1e-6 at its 20th update; at 1e-4 and 4e-4 the random
    ExtendedDINOSAUR's loss moved by about 10 % from step to step around a
    flat line: Adam moves every weight of the CNN head's last conv by lr at
    once, and its 1152 inputs add up to a jump of the image's level. Off the
    main path."""
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    tr = DecompTrainer(clip_experiment(tmp / "clip_train_sign", data_root, batch_size=8,
                                       accum_steps=1, lr=1e-6, lr_warmup=False))
    tr.setup_model()
    batch = tr.to_device(videos[:8])
    noise = tr._noise(8)
    values = [tr.train_step(batch, noise) for _ in range(10)]
    losses = [float(v["_total"]) for v in values]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"clip sign check: the loss did not fall over 10 steps: {losses}")
    emit({"phase": "clip_train_sign", "batch": 8, "frames": CLIP_FRAMES, "lr": 1e-6,
          "steps": 10, "losses": losses,
          "parts": {k: [float(v[k]) for v in values] for k in values[0] if k != "_total"}})


def phase_clip_pred_train_parity(parent: Path):
    """PredictorTrainer on the card and on the CPU at full width, B=2, c=1,
    p=PARITY_PREDS, through the frozen ExtendedDINOSAUR of ``parent``'s
    ``checkpoint_epoch_final`` (its BatchNorm in ``eval()``), the same
    predictor weights, video, captions and slot noise, warmup off, lr 1e-5
    (``trainer_parity``: the predictor's MLPs and the frozen decoder's ReLUs
    replayed from the card). Off the main path."""
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    exp = pred_experiment(parent, "clip_pred_parity", PARITY_PREDS, batch_size=2,
                          accum_steps=1, lr=1e-5, lr_warmup=False)
    gen = torch.Generator().manual_seed(SEED + 22)
    video = torch.rand((2, PRED_CONTEXT + PARITY_PREDS, CLIP_RES, CLIP_RES, 3), generator=gen)
    noise = [torch.randn((2, CLIP_SLOTS, CLIP_SLOT_DIM), generator=gen) for _ in range(2)]
    text = caption_batch(Experiment(exp).params, 2, PATHS[1])

    def make(dev):
        tr = PredictorTrainer(exp, "checkpoint_epoch_final", device=dev)
        tr.setup_model()
        random_predictor_(tr)
        return tr

    def step(tr, dev, i):
        tx = {k: v.to(dev) for k, v in text.items()}
        return float(tr.train_step(video.to(dev), noise[i], **tx)["_total"])

    def finish(trainers):
        card, cpu = (trainers[d].decomp_model.state_dict() for d in ("cuda", "cpu"))
        check(all(torch.equal(v.cpu(), cpu[k]) for k, v in card.items()),
              "clip predictor parity: the frozen model differs between the devices")
        return {"frozen_model_unchanged": True}

    res = trainer_parity("clip predictor train parity", make, step, tail_convs=0,
                         finish=finish, replayed=ALL_KINKS)
    emit({"phase": "clip_pred_train_parity", "B": 2, "num_context": PRED_CONTEXT,
          "num_preds": PARITY_PREDS, **res})


def phase_clip_pred_train(parent: Path):
    """The 04 CLI at B=64, c=1, p=9, ``accum_steps`` 8, through the frozen
    ExtendedDINOSAUR that ``phase_clip_train`` wrote (one step after one
    B=16 valid batch): the CLIPort predictor path's main path. Then a second
    run resumes from ``checkpoint_last_saved`` for a second epoch. Returns
    the main path's launches and the resumed trainer."""
    from textocvp_tpu_torch.cli import train_predictor
    from textocvp_tpu_torch.core.experiment import Experiment

    exp_path = pred_experiment(parent, CLIP_PRED_NAME)
    argv = ["-d", str(parent), "--name_pred_exp", CLIP_PRED_NAME, "--decomp_ckpt",
            "checkpoint_epoch_final"]
    steps, valid = 1, 1
    reset_launches()  # the main path starts here
    t = time.perf_counter()
    trainer, out = run_cli(train_predictor.main, argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    # the frozen encode: one slot-attention call a frame, one ViT call, of
    # each (micro)batch and of the image strip where tensorboard imports
    strips = trainer.image_strips
    calls = steps * CLIP_ACCUM + valid + strips
    want = {"slot_attention": calls * PRED_FRAMES, "vit_attention": calls * VIT_BLOCKS,
            "conv5": 0}
    check(counts == want and strips == int(trainer.writer is not None),
          f"clip_pred_train: kernel launches on the main path {counts}, want {want}; "
          f"{strips} image strips")
    losses = loss_lines(out)
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          f"clip_pred_train losses {losses}")
    check(trainer.global_step == valid + steps and trainer.optimizer.count == steps
          and trainer.accum == CLIP_ACCUM,
          f"clip_pred_train: step {trainer.global_step}, updates {trainer.optimizer.count}")
    exp = Experiment(exp_path)
    for name in ("checkpoint_last_saved.pt", "checkpoint_epoch_1.pt", "checkpoint_epoch_final.pt"):
        check((exp.models_dir / name).is_file(), f"clip_pred_train: {name} not written")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    params = exp.params
    params["training"]["num_epochs"] = 2
    exp.save_params(params)
    t = time.perf_counter()
    resumed, out2 = run_cli(train_predictor.main, argv + ["--checkpoint", "checkpoint_last_saved",
                                                          "--resume_training"])
    resume_seconds = time.perf_counter() - t
    losses2 = loss_lines(out2)
    check("Resuming training from epoch 1" in out2 and resumed.start_epoch == 1
          and resumed.global_step == 2 * (valid + steps) and resumed.optimizer.count == 2 * steps,
          f"clip_pred_train resume: epoch {resumed.start_epoch}, step {resumed.global_step}, "
          f"updates {resumed.optimizer.count}")
    check(len(losses2) == steps and bool(np.isfinite(losses2).all()),
          f"clip_pred_train resumed losses {losses2}")
    emit({"phase": "clip_pred_train", "batch": CLIP_TRAIN_BATCH, "num_context": PRED_CONTEXT,
          "num_preds": PRED_PREDS, "accum_steps": CLIP_ACCUM,
          "decomp_ckpt": "checkpoint_epoch_final (clip_train phase)",
          "cli_seconds": seconds, "resume_cli_seconds": resume_seconds, "launches": counts,
          "losses": losses, "resumed_losses": losses2,
          "epoch_lines": [line for line in (out + out2).splitlines() if line.startswith("Epoch")]})
    return counts, resumed


def phase_clip_pred_train_step(trainer, videos, info):
    """The steady 04 step at B=64, c=1, p=9, ``accum_steps`` 8 on the resumed
    trainer: CLIP_STEADY_REPS steps on the host clock with synchronize, one
    split into frozen encode, forward (rollout, decode of 72 frames, loss), backward
    (each summed over the microbatches) and optimizer, the peak memory, the
    launches of a step (10 slot-attention calls and 12 ViT-attention
    launches a microbatch), and one step under torch.profiler. Off the main
    path."""
    batch, text = trainer.batch_to_device(videos, info)
    step_ms, peak_gb = steady_steps(lambda: trainer.train_step(batch, **text),
                                    reps=CLIP_STEADY_REPS, warm=False)
    before = launch_counts_clip()
    noise = trainer._noise(batch.shape[0])
    split = accumulated_split(
        trainer, batch.shape[0],
        lambda sl, out: trainer.predict_loss(batch[sl], out.pop("slots"),
                                             **{k: t[sl] for k, t in text.items()})[0],
        encode=lambda sl, out: out.update(slots=trainer.encode(batch[sl], noise[sl])))
    per_step = tuple(a - b for a, b in zip(launch_counts_clip(), before))
    clip_step_report("clip_pred_train_step", trainer,
                     lambda: trainer.train_step(batch, **text), per_step,
                     (CLIP_ACCUM * PRED_FRAMES, CLIP_ACCUM * VIT_BLOCKS),
                     CLIP_TRAIN_BATCH * PRED_PREDS, step_ms, peak_gb, split)


def phase_clip_pred_train_sign(parent: Path, videos, info):
    """10 predictor steps on one fixed batch of 8 (no accumulation) at lr
    1e-4, no warmup, the output projection scaled (``random_predictor_``):
    the loss must fall. Off the main path."""
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    tr = PredictorTrainer(pred_experiment(parent, "clip_pred_sign", batch_size=8,
                                          accum_steps=1, lr=1e-4, lr_warmup=False),
                          "checkpoint_epoch_final")
    tr.setup_model()
    random_predictor_(tr)
    batch, text = tr.batch_to_device(videos[:8], rows(info, 8))
    losses = [float(tr.train_step(batch, **text)["_total"]) for _ in range(10)]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"clip predictor sign check: the loss did not fall over 10 steps: {losses}")
    emit({"phase": "clip_pred_train_sign", "batch": 8, "num_preds": PRED_PREDS, "lr": 1e-4,
          "steps": 10, "losses": losses})


def phase_clip_eval(parent: Path):
    """The 05 CLI at B=16, 1 seed frame, 9 predictions over the 32 test
    episodes (two batches), on the predictor ``phase_clip_pred_train`` wrote:
    the CLIPort eval path's main path. Returns its launches."""
    from textocvp_tpu_torch.cli import evaluate_predictor

    reset_launches()  # the main path starts here
    t = time.perf_counter()
    rc = evaluate_predictor.main(["-d", str(parent), "--name_pred_exp", CLIP_PRED_NAME,
                                  "--decomp_ckpt", "checkpoint_epoch_final", "--pred_ckpt",
                                  "checkpoint_epoch_final", "--batch_size", str(CLIP_EVAL_BATCH),
                                  "--num_seed", "1", "--num_preds", str(CLIP_PREDS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    batches = dict(CLIP_EPISODES)["test"] // CLIP_EVAL_BATCH
    check(rc == 0, f"evaluate_predictor returned {rc}")
    check(counts == {"slot_attention": batches, "vit_attention": VIT_BLOCKS * batches,
                     "conv5": 0}, f"clip_eval: kernel launches on the main path: {counts}")
    results_dir = parent / "predictors" / CLIP_PRED_NAME / "results" / (
        f"eval_pred_checkpoint_epoch_final_NumSeed=1_NumPreds={CLIP_PREDS}")
    with open(results_dir / "results.json") as f:
        results = json.load(f)
    for m in ("psnr", "ssim", "lpips"):
        vals = results[m]["framewise"] + [results[m]["mean"]]
        check(len(results[m]["framewise"]) == CLIP_PREDS and bool(np.isfinite(vals).all()),
              f"clip_eval results.json: {m} {results[m]}")
    plots = check_framewise_plots(results_dir, results, "clip_eval")
    emit({"phase": "clip_eval", "batch": CLIP_EVAL_BATCH, "episodes": batches * CLIP_EVAL_BATCH,
          "num_seed": 1, "num_preds": CLIP_PREDS, "cli_seconds": seconds, "launches": counts,
          "results": results, "framewise_plots": plots})
    return counts


def run_clip(tmp: Path, created: Path):
    """The CLIPort chain: the fixture; the 02 path (parity, the CLI and its
    resume, the steady step, the sign check); the 04 path over the 02
    checkpoint (the same); the 05 path over the 04 checkpoint (parity, the
    CLI, the stage split and profile); the 03 path over the 02 checkpoint,
    dropped into ``created`` (the 01 CLI's experiment). Returns each path's
    main-path launches."""
    data_root = write_cliport_fixture(tmp / "CLIPort")
    phase_clip_train_parity(tmp)
    exp = clip_experiment(tmp / "clip_train", data_root)
    counts = {}
    counts["clip_train"], trainer = phase_clip_train(exp)
    videos, _ = next(iter(trainer.train_loader))
    phase_clip_train_step(trainer, videos)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    phase_clip_train_sign(data_root, tmp, videos)
    del videos
    phase_clip_pred_train_parity(exp)
    counts["clip_pred_train"], trainer = phase_clip_pred_train(exp)
    videos, info = next(iter(trainer.train_loader))
    phase_clip_pred_train_step(trainer, videos, info)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    phase_clip_pred_train_sign(exp, videos, info)
    del videos, info
    ckpts = ("checkpoint_epoch_final", "checkpoint_epoch_final")
    phase_eval_parity(exp, CLIP_PRED_NAME, ckpts, CLIP_PREDS, phase="clip_eval_parity")
    counts["clip_eval"] = phase_clip_eval(exp)
    gc.collect()
    torch.cuda.empty_cache()
    phase_eval_step(exp, CLIP_PRED_NAME, ckpts, CLIP_EVAL_BATCH, CLIP_PREDS, VIT_BLOCKS,
                    phase="clip_eval_step")
    gc.collect()
    torch.cuda.empty_cache()
    counts["clip_decomp_eval"] = run_decomp_eval(
        "clipport", created, exp / "models" / "checkpoint_epoch_final.pt", data_root,
        dict(CLIP_EPISODES)["test"])
    return counts


# ------------------------------------- host input, the PNG routes, the trainers' extras

HOST_SHAPES = {"cater": ((240, 320), (CONV5_RES, CONV5_RES)),    # a CATER frame, the model's
               "clipport": ((480, 640), (CLIP_RES, CLIP_RES))}   # a CLIPort frame, the model's
HOST_THREADS = 8        # the loader's default workers (TEXTOCVP_NUM_WORKERS)
HOST_RATE_FRAMES = 192  # PNG files read, decoded and resized for each rate
PNG_VIDEOS, PNG_VIDEO_FRAMES = EVAL_BATCH, EVAL_PREDS + 2  # frame 0, then 1 + 19 read
CLIP_PNG_EPISODES = CLIP_EVAL_BATCH
EXTRAS_BATCH, EXTRAS_VIDEOS = 16, 32  # the 02 CLI with the extras: 2 steps, 1 valid batch
CLIP_REMAT_MICROBATCH = CLIP_TRAIN_BATCH // 4  # a microbatch of accum_steps 4


def scene_frames(rng, n, h, w, blocks=3):
    """``n`` uint8 (h, w, 3) frames: coloured squares sliding over a shaded
    floor, a little noise."""
    yy, xx = np.mgrid[:h, :w]
    floor = np.stack([90 + 60 * yy // h + 25 * xx // w, 85 + 55 * yy // h + 20 * xx // w,
                      80 + 50 * yy // h + 20 * xx // w], -1).astype(np.int16)
    frames = np.repeat(floor[None], n, 0)
    side = min(h, w)
    for _ in range(blocks):
        color = rng.integers(0, 256, 3)
        size = int(rng.integers(side // 20, side // 8))
        cy, cx = rng.uniform(0.15, 0.85) * h, rng.uniform(0.15, 0.85) * w
        vy, vx = rng.uniform(-1.5, 1.5, 2) * side / 64
        for t in range(n):
            y, x = int(cy + vy * t), int(cx + vx * t)
            frames[t, max(y - size, 0):max(y + size, 0), max(x - size, 0):max(x + size, 0)] = color
    frames += rng.integers(-5, 6, frames.shape, dtype=np.int16)
    return np.clip(frames, 0, 255).astype(np.uint8)


def write_pngs(jobs):
    """(path, frame) pairs written as PNGs by the port's stdlib writer (each
    row the next of the five filter types), on HOST_THREADS threads."""
    from concurrent.futures import ThreadPoolExecutor

    from textocvp_tpu_torch.native.png import encode_png

    def write(job):
        job[0].write_bytes(encode_png(job[1], 2))

    with ThreadPoolExecutor(HOST_THREADS) as pool:
        list(pool.map(write, jobs))


def phase_host_io(tmp: Path):
    """What the machine offers the host input path (the compiler, the imgio
    build against zlib, PIL, imageio and ffmpeg, tensorboard), the
    imgio build and its seconds; the C++ resize against
    ``resize_bilinear_plain`` on CATER-like 320 x 240 -> 64 x 64 and
    CLIPort-like 640 x 480 -> 336 x 336 frames, and PNGs of the stdlib
    writer decoded back, bit for bit; then PNG files read, decoded and
    resized (``datasets._load_image_resized``) in frames/s on 1 thread and
    on HOST_THREADS. Off the main paths."""
    from concurrent.futures import ThreadPoolExecutor

    from textocvp_tpu_torch import native
    from textocvp_tpu_torch.data.datasets import _load_image_resized
    from textocvp_tpu_torch.native.png import encode_png

    t = time.perf_counter()
    info = native.host_io()
    lib = native.build()
    native.load()
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(SEED + 30)
    rates = {}
    for name, (src, dst) in HOST_SHAPES.items():
        for frame in scene_frames(rng, 3, *src):
            check(np.array_equal(native.resize_bilinear_rgb(frame, *dst),
                                 native.resize_bilinear_plain(frame, *dst)),
                  f"host_io {name}: the C++ resize differs from resize_bilinear_plain")
            check(np.array_equal(native.decode_png_rgb(encode_png(frame, 2)), frame),
                  f"host_io {name}: a PNG of the stdlib writer did not decode to its frame")
        folder = tmp / f"host_io_{name}"
        folder.mkdir()
        video = scene_frames(rng, 24, *src)
        paths = [folder / f"{i:04d}.png" for i in range(HOST_RATE_FRAMES)]
        write_pngs([(p, video[i % len(video)]) for i, p in enumerate(paths)])

        def load(p, dst=dst):
            return _load_image_resized(str(p), tuple(dst), as_uint8=True)

        def rate(threads):
            t = time.perf_counter()
            with ThreadPoolExecutor(threads) as pool:
                list(pool.map(load, paths))
            return len(paths) / (time.perf_counter() - t)

        rate(HOST_THREADS)  # the files in the page cache
        rates[name] = {"src_hw": list(src), "dst_hw": list(dst),
                       "png_kb_mean": sum(p.stat().st_size for p in paths) / len(paths) / 1e3,
                       "frames_per_s_1_thread": rate(1),
                       f"frames_per_s_{HOST_THREADS}_threads": rate(HOST_THREADS)}
    emit({"phase": "host_io", "host_io": info, "imgio_library": lib.name,
          "imgio_build_s": build_s, "bit_exact": ["resize vs resize_bilinear_plain",
                                                  "stdlib PNG writer -> decode"],
          "host_cpus": os.cpu_count(), "decode_resize": rates})


def write_cater_png_fixture(root: Path) -> Path:
    """PNG_VIDEOS CATER videos of PNG_VIDEO_FRAMES frames at 320 x 240 as
    frame directories (``easy/video_XXXX/frame_XXXXX.png``), and
    ``easy/test_explicit.json``."""
    rng = np.random.default_rng(SEED + 31)
    mode = root / "easy"
    mode.mkdir(parents=True)
    captions = PATHS[0].captions
    jobs, ann = [], {}
    for i in range(PNG_VIDEOS):
        folder = mode / f"video_{i:04d}"
        folder.mkdir()
        for t, frame in enumerate(scene_frames(rng, PNG_VIDEO_FRAMES, *HOST_SHAPES["cater"][0])):
            jobs.append((folder / f"frame_{t:05d}.png", frame))
        ann[str(i)] = {"video": folder.name, "caption": captions[i % len(captions)]}
    write_pngs(jobs)
    (mode / "test_explicit.json").write_text(json.dumps(ann))
    return root


def write_cliport_png_fixture(root: Path) -> Path:
    """CLIP_PNG_EPISODES CLIPort test episodes of CLIP_EPISODE_FRAMES PNG
    frames at 640 x 480 (``test/episodeNNNNN/color/<n>_color.png``) with
    their ``task_description.txt``, and no cache."""
    rng = np.random.default_rng(SEED + 32)
    jobs = []
    for n in range(CLIP_PNG_EPISODES):
        ep = root / "test" / f"episode{n:05d}"
        (ep / "color").mkdir(parents=True)
        for t, frame in enumerate(scene_frames(rng, CLIP_EPISODE_FRAMES,
                                               *HOST_SHAPES["clipport"][0], blocks=4)):
            jobs.append((ep / "color" / f"{t:06d}_color.png", frame))
        block, bowl = rng.choice(CLIP_COLORS["test"], 2, replace=False)
        (ep / "task_description.txt").write_text(f"put the {block} block in the {bowl} bowl\n")
    write_pngs(jobs)
    return root


def png_route_eval(tmp: Path, phase, path: ServedPath, png_root: Path, cache_args, batch,
                   want_launches):
    """The 05 CLI (B=``batch``, 1 seed frame, ``path.num_preds``) over the
    PNG set ``png_root`` on the card, a PNG route's main path, then over the
    ``.npy`` caches that ``cli/make_npy_cache.py`` builds from it (args
    ``cache_args``): the same weights, the same frames bit for bit, so the
    same ``results.json``. Then the loader's frames/s on the PNG set against
    the eval step's demand, and the device's idle share of the loader's
    batch and its step under ``torch.profiler``. Returns the main path's
    launches."""
    from textocvp_tpu_torch.cli import evaluate_predictor, make_npy_cache
    from textocvp_tpu_torch.data.loader import load_data
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    cache_root = png_root.with_name(png_root.name + "_npy")
    t = time.perf_counter()
    make_npy_cache.main([*cache_args, "--root", str(png_root), "--out", str(cache_root)])
    cache_s = time.perf_counter() - t
    params, pred_params = full_width_params(path)
    results, exps, cli_s = {}, {}, {}
    for route, root in (("png", png_root), ("cache", cache_root)):
        for p in (params, pred_params):
            p["dataset"]["root"] = str(root)
        exps[route] = write_experiment(tmp / f"{phase}_{route}", params, pred_params)
        argv = ["-d", str(exps[route]), "--name_pred_exp", "textocvp_t5", "--decomp_ckpt",
                "random", "--pred_ckpt", "random", "--batch_size", str(batch), "--num_seed",
                "1", "--num_preds", str(path.num_preds)]
        if route == "png":
            reset_launches()  # the main path starts here
        t = time.perf_counter()
        rc = evaluate_predictor.main(argv)
        torch.cuda.synchronize()
        cli_s[route] = time.perf_counter() - t
        if route == "png":
            counts = launches()  # and ends here
        check(rc == 0, f"{phase} {route}: evaluate_predictor returned {rc}")
        with open(exps[route] / "predictors" / "textocvp_t5" / "results" / (
                f"eval_pred_random_NumSeed=1_NumPreds={path.num_preds}") / "results.json") as f:
            results[route] = json.load(f)
    check(counts == want_launches, f"{phase}: kernel launches on the main path {counts}, "
                                   f"want {want_launches}")
    for m in ("psnr", "ssim", "lpips"):
        check(len(results["png"][m]["framewise"]) == path.num_preds
              and bool(np.isfinite(results["png"][m]["framewise"]).all()),
              f"{phase}: {m} {results['png'][m]}")
    check(results["png"] == results["cache"],
          f"{phase}: results.json over the PNGs differs from the cache route's")

    ev = PredictorEvaluator(exps["png"], "textocvp_t5", "random", "random", num_seed=1,
                            num_preds=path.num_preds, batch_size=batch)
    ev.load_data()
    ev.load_models()
    # the items themselves, bit for bit
    cached = load_data({**ev.exp_params, "dataset": {**ev.exp_params["dataset"],
                                                     "root": str(cache_root)}}, "test")
    check(len(cached) == len(ev.test_set), f"{phase}: {len(cached)} cached items")
    for i in range(len(cached)):
        check(np.array_equal(ev.test_set[i][0], cached[i][0]),
              f"{phase}: item {i} of the PNG route differs from the cache's")
    t = time.perf_counter()
    frames = sum(v.shape[0] * v.shape[1] for v, _ in ev.test_loader)
    loader_fps = frames / (time.perf_counter() - t)
    videos, info = next(iter(ev.test_loader))
    step_ms, peak_gb = steady_steps(lambda: ev.eval_step(videos, info), reps=2)
    demand = 1e3 * videos.shape[0] * videos.shape[1] / (sum(step_ms) / len(step_ms))
    prof, _ = profiled_step(lambda: [ev.eval_step(v, i) for v, i in ev.test_loader], cpu=False)
    emit({"phase": phase, "batch": batch, "num_preds": path.num_preds,
          "items": len(cached), "src_hw": list(HOST_SHAPES[path.name][0]),
          "img_hw": [path.res, path.res], "loader_workers": ev.test_loader.num_workers,
          "cli_seconds": cli_s, "cache_seconds": cache_s, "launches": counts,
          "results_equal_to_cache_route": True,
          "loader_frames_per_s": loader_fps, "eval_step_ms": step_ms,
          "eval_step_demand_frames_per_s": demand, "peak_mem_gb": peak_gb,
          "loader_and_step_wall_ms": prof["profiled_step_wall_ms"],
          "loader_and_step_device_busy_ms": prof["device_busy_ms"],
          "loader_and_step_device_idle_share": prof["device_idle_share"],
          "means": {m: results["png"][m]["mean"] for m in ("psnr", "ssim", "lpips")}})
    del ev, cached
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def run_png_eval(tmp: Path):
    """The CATER 05 over frame directories of PNGs (``png_eval``)."""
    root = write_cater_png_fixture(tmp / "CATER_png")
    return png_route_eval(tmp, "png_eval", PATHS[0], root,
                          ["--dataset", "cater", "--mode", "easy", "--split", "test",
                           "--img-size", f"{PATHS[0].res}x{PATHS[0].res}",
                           "--num-frames", str(1 + EVAL_PREDS)],
                          EVAL_BATCH, {"slot_attention": 1, "vit_attention": 0, "conv5": 3})


def run_clip_png_eval(tmp: Path):
    """The CLIPort 05 over PNG episodes without a cache (``clip_png_eval``)."""
    root = write_cliport_png_fixture(tmp / "CLIPort_png")
    return png_route_eval(tmp, "clip_png_eval", PATHS[1], root,
                          ["--dataset", "cliport", "--split", "test",
                           "--img-size", f"{PATHS[1].res}x{PATHS[1].res}"],
                          CLIP_EVAL_BATCH,
                          {"slot_attention": 1, "vit_attention": VIT_BLOCKS, "conv5": 0})


def same_tensors(a, b) -> bool:
    """Whether two nested states hold the same tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tensors(x, y) for x, y in zip(a, b))
    return a == b


def phase_train_extras(tmp: Path):
    """The 02 CLI on CATER for one epoch (EXTRAS_VIDEOS videos at
    B=EXTRAS_BATCH after one valid batch) with ``tpu.async_checkpoint`` and
    ``TEXTOCVP_PROFILE``: ``logs.txt`` holds its lines, the Chrome trace the
    slot-attention and conv5 kernels, the checkpoints the trainer's state
    bit for bit and as a synchronous save of it loads, TensorBoard's event
    files where ``tensorboard`` imports. Off the main paths."""
    from textocvp_tpu_torch import native
    from textocvp_tpu_torch.cli import train_decomp
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint

    data_root = write_cater_fixture(tmp / "CATER_extras", (("train", EXTRAS_VIDEOS),
                                                           ("test", EXTRAS_BATCH)))
    exp_path = train_experiment(tmp / "extras", data_root, batch_size=EXTRAS_BATCH)
    exp = Experiment(exp_path)
    params = exp.params
    params["tpu"] = {"async_checkpoint": True}
    exp.save_params(params)
    profile_dir = tmp / "extras_profile"
    os.environ["TEXTOCVP_PROFILE"] = str(profile_dir)
    try:
        t = time.perf_counter()
        trainer, out = run_cli(train_decomp.main, ["-d", str(exp_path)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    finally:
        del os.environ["TEXTOCVP_PROFILE"]
    steps = EXTRAS_VIDEOS // EXTRAS_BATCH
    logged = (exp_path / "logs.txt").read_text()
    check(all(f"epoch 0 iter {i}: loss=" in logged for i in range(steps))
          and "Epoch 1/1: train=" in logged and "Calling: training_loop..." in logged,
          "train_extras: logs.txt lacks the iteration or epoch lines")
    traces = sorted(profile_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"train_extras: Chrome traces {traces}")
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    kernels = {k: sum(k in n for n in names) for k in (SLOT_ATTENTION_KERNEL, "conv5_kernel")}
    check(all(kernels.values()), f"train_extras: the trace lacks a port kernel: {kernels}")
    state = trainer._state(1)
    sync = save_checkpoint(tmp / "extras_sync.pt", state)
    for name in ("checkpoint_last_saved", "checkpoint_epoch_final"):
        written = load_checkpoint(exp.checkpoint_path(name))
        check(same_tensors(written["params"], state["params"])
              and same_tensors(written["opt_state"], state["opt_state"])
              and same_tensors(written, load_checkpoint(sync)),
              f"train_extras: {name} differs from the trainer's state")
    events = sorted((exp_path / "tboard_logs").glob("events.out.tfevents.*"))
    tensorboard = native.host_io()["tensorboard"]
    check(bool(events) == tensorboard and trainer.image_strips == int(tensorboard),
          f"train_extras: tensorboard {tensorboard}, event files {events}, "
          f"image strips {trainer.image_strips}")
    emit({"phase": "train_extras", "batch": EXTRAS_BATCH, "frames": TRAIN_FRAMES,
          "train_videos": EXTRAS_VIDEOS, "cli_seconds": seconds, "async_checkpoint": True,
          "logs_txt_lines": len(logged.splitlines()), "trace": traces[0].name,
          "trace_mb": traces[0].stat().st_size / 1e6, "trace_kernel_events": kernels,
          "checkpoints_equal_trainer_state": True, "tensorboard": tensorboard,
          "event_files": len(events), "image_strips": trainer.image_strips})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


def remat_rows(make, batch, reps=1):
    """``make(remat)``'s trainer without and with ``tpu.remat`` on one batch
    (``batch(trainer)`` -> (videos, noise, text)): the gradients of a first
    backward, then ``reps`` steady steps (backward and Adam) on the host
    clock, their peak GB. Returns the rows and the largest gradient
    difference over the largest leaf (checked by the caller, after it has
    printed it)."""
    rows, grads = {}, {}
    for knob in (False, True):
        tr = make(knob)
        videos, noise, text = batch(tr)
        tr.backward(videos, noise, **text)
        grads[knob] = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()
                       if p.grad is not None}

        def step():
            tr.backward(videos, noise, **text)
            tr.optimizer.step()

        step_ms, peak_gb = steady_steps(step, reps)
        rows["remat" if knob else "plain"] = {"step_ms": step_ms, "peak_mem_gb": peak_gb}
        del tr, videos, noise, text
        gc.collect()
        torch.cuda.empty_cache()
    check(grads[True].keys() == grads[False].keys(), "remat: other leaves take gradients")
    top = max(g.abs().max().item() for g in grads[False].values())
    diff = max((grads[True][n] - g).abs().max().item() for n, g in grads[False].items())
    return rows, diff / top


def phase_train_remat(train_exp: Path, data_root: Path):
    """One CATER 02 step (B=64, T=8) and one CATER 04 step (B=64, c=1, p=9,
    through the 02 path's SAVi), each without and with ``tpu.remat``, on
    one batch and one noise draw: the step's ms and peak GB, and the largest
    gradient difference over the largest leaf. Off the main paths."""
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer
    from textocvp_tpu_torch.train.trainer import REMAT_REGIONS, DecompTrainer

    def with_remat(path, knob):
        exp = Experiment(path)
        params = exp.params
        params["tpu"] = {"remat": knob}
        exp.save_params(params)
        return path

    decomp = train_experiment(train_exp.parent / "remat_02", data_root)

    def noise(tr, b):  # one draw for both trainers
        return tr._noise(b, torch.Generator().manual_seed(SEED + 6))

    def make02(knob):
        tr = DecompTrainer(with_remat(decomp, knob))
        tr.setup_model()
        return tr

    def batch02(tr):
        tr.load_data()
        videos, _ = next(iter(tr.train_loader))
        return tr.to_device(videos), noise(tr, videos.shape[0]), {}

    rows02, rel02 = remat_rows(make02, batch02)

    def make04(knob):
        tr = PredictorTrainer(with_remat(pred_experiment(train_exp, f"remat_04_{knob}"), knob),
                              "checkpoint_epoch_final")
        tr.setup_model()
        return tr

    def batch04(tr):
        tr.load_data()
        videos, info = next(iter(tr.train_loader))
        videos, text = tr.batch_to_device(videos, info)
        return videos, noise(tr, videos.shape[0]), text

    rows04, rel04 = remat_rows(make04, batch04)
    emit({"phase": "train_remat", "train_02": {"batch": TRAIN_BATCH, "frames": TRAIN_FRAMES,
                                               **rows02, "grad_diff_over_max": rel02},
          "pred_train_04": {"batch": TRAIN_BATCH, "num_context": PRED_CONTEXT,
                            "num_preds": PRED_PREDS, **rows04, "grad_diff_over_max": rel04},
          "remat_regions_of_a_decode": REMAT_REGIONS, "tolerance_rel": REMAT_TOLERANCE})
    for step, rel in (("02", rel02), ("04", rel04)):
        check(rel <= REMAT_TOLERANCE[step], f"train_remat: the {step} step's gradients under "
              f"remat differ from the plain step's by {rel} of the largest leaf > "
              f"{REMAT_TOLERANCE[step]}")


def clip_decomp_remat_rows(parent: Path):
    """One CLIPort 02 microbatch of 8 episodes (``accum_steps`` 8) of the
    ExtendedDINOSAUR of ``parent``'s config, without and with ``tpu.remat``,
    on one batch and one noise draw: its forward and backward on the host
    clock, its peak GB, the GB its forward keeps for the backward, and the
    largest gradient difference over the largest leaf. (The peak holds the
    workspace cuDNN takes for one conv of the CNN head, 27.56 GB in a
    memory history on the H100, which remat does not touch.)"""
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    data_root = Experiment(parent).params["dataset"]["root"]
    mb = CLIP_TRAIN_BATCH // CLIP_ACCUM
    rows, grads = {}, {}
    for knob in (False, True):
        exp = Experiment(clip_experiment(parent.parent / f"clip_remat_02_{knob}", data_root))
        params = exp.params
        params["tpu"] = {"remat": knob}
        exp.save_params(params)
        tr = DecompTrainer(exp.exp_path)
        tr.setup_model()
        tr.load_data()
        batch = tr.to_device(next(iter(tr.train_loader))[0][:mb])
        noise = tr._noise(mb, torch.Generator().manual_seed(SEED + 6))

        def micro():
            tr.optimizer.zero_grad()
            tr.forward_loss(batch, noise)[0].backward()

        micro()
        grads[knob] = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()
                       if p.grad is not None}
        tr.optimizer.zero_grad()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss = tr.forward_loss(batch, noise)[0]
        torch.cuda.synchronize()
        kept_gb = (torch.cuda.memory_allocated() - before) / 2**30
        loss.backward()
        del loss
        step_ms, peak_gb = steady_steps(micro, reps=1)
        rows["remat" if knob else "plain"] = {"step_ms": step_ms, "peak_mem_gb": peak_gb,
                                              "kept_after_forward_gb": kept_gb}
        del tr, batch, noise
        gc.collect()
        torch.cuda.empty_cache()
    check(grads[True].keys() == grads[False].keys(), "clip_remat: other leaves take gradients")
    top = max(g.abs().max().item() for g in grads[False].values())
    diff = max((grads[True][n] - g).abs().max().item() for n, g in grads[False].items())
    return {"microbatch": mb, **rows, "grad_diff_over_max": diff / top}


def phase_clip_remat(parent: Path):
    """One CLIPort 02 microbatch without and with ``tpu.remat``
    (:func:`clip_decomp_remat_rows`); then one CLIPort 04 microbatch with
    ``tpu.remat`` through the CLIPort 02 path's ExtendedDINOSAUR (c=1,
    p=9): of 8 episodes (``accum_steps`` 8 of B=64, the configured one;
    48.07 GB without remat, PERF.md §5) and of CLIP_REMAT_MICROBATCH
    (``accum_steps`` 4): its forward and backward on the host clock and its
    peak GB, or the card's refusal of the memory. Off the main paths."""
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer
    from textocvp_tpu_torch.train.trainer import REMAT_REGIONS

    decomp = clip_decomp_remat_rows(parent)

    exp = Experiment(pred_experiment(parent, "clip_remat", accum_steps=4))
    params = exp.params
    params["tpu"] = {"remat": True}
    exp.save_params(params)
    tr = PredictorTrainer(exp.exp_path, "checkpoint_epoch_final")
    tr.setup_model()
    tr.load_data()
    videos, info = next(iter(tr.train_loader))
    rows_out = []
    for mb in (CLIP_TRAIN_BATCH // CLIP_ACCUM, CLIP_REMAT_MICROBATCH):
        batch, text = tr.batch_to_device(videos[:mb], rows(info, mb))
        noise = tr._noise(mb)

        def micro():
            tr.optimizer.zero_grad()
            tr.forward_loss(batch, noise, **text)[0].backward()

        row = {"microbatch": mb, "accum_steps": CLIP_TRAIN_BATCH // mb}
        try:
            step_ms, peak_gb = steady_steps(micro, reps=1)
            row.update(fits=True, step_ms=step_ms, peak_mem_gb=peak_gb)
        except torch.cuda.OutOfMemoryError as e:
            row.update(fits=False, error=str(e).splitlines()[0])
        rows_out.append(row)
        del batch, text, noise
        tr.optimizer.zero_grad()
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "clip_remat", "decomp_02": decomp, "num_preds": PRED_PREDS,
          "remat_regions_of_a_decode": REMAT_REGIONS, "microbatches": rows_out,
          "card_gb": torch.cuda.get_device_properties(0).total_memory / 2**30})
    check(decomp["grad_diff_over_max"] <= REMAT_TOLERANCE["02"],
          f"clip_remat: the 02 microbatch's gradients under remat differ from the plain "
          f"one's by {decomp['grad_diff_over_max']} of the largest leaf > "
          f"{REMAT_TOLERANCE['02']}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()


# -------------------------------------- 06 figures and dynamic request batching

FIG_SEQS = 2           # 06 sequences on CATER (the CLIs' --num_seqs)
FIG_PARITY_PREDS = 3   # predictions of the card-against-CPU 06b sequence
DINOSAUR_OBJ_RES = 96  # ExtendedDINOSAUR's objects and masks (process_objs_masks_dinosaur)
FIG_WRITERS = ("visualize_recons", "visualize_decomp", "visualize_sequence",
               "visualize_qualitative_eval", "visualize_aligned_slots", "make_gif")
# GIFs coloured by the argmax over the slots' masks: a pixel whose two
# largest masks lie within rounding of each other may take either colour
ARGMAX_FIGS = ("masks_GIF_masks.gif", "overlay_GIF.gif")
BATCHING_CLIENTS, BATCHING_REQUESTS, BATCHING_WINDOW_MS = 16, 32, 20.0


GIF_FRAME_MS = 250  # make_gif's 1000 / fps ms at 4 fps


def image_info(path):
    """(size, frames) of a PNG or a GIF, every frame decoded through PIL. A
    GIF's frames are its duration over GIF_FRAME_MS: PIL's writer (and so
    imageio's) merges a frame equal to the one before into it."""
    from PIL import Image

    with Image.open(path) as img:
        ms = 0
        for i in range(getattr(img, "n_frames", 1)):
            img.seek(i)
            img.load()
            ms += img.info.get("duration", 0)
        return img.size, (ms // GIF_FRAME_MS if img.format == "GIF" else 1)


def expected_06a(t, s, res, obj_res):
    """{file: (size, frames)} of one 06a sequence of t frames at res and s
    slots, objects and masks at obj_res."""
    from textocvp_tpu_torch import viz

    z = np.zeros
    gif = 2 * res + 8  # upscaled 2x, a 4 px border
    return {"recons.png": (viz.visualize_recons(z((t, res, res, 3)), z((t, res, res, 3)))
                           .image.size, 1),
            "recons.gif": ((gif, gif), t),
            "objects.png": (viz.visualize_decomp(z((t, s, obj_res, obj_res, 3))).image.size, 1),
            "masks.png": (viz.visualize_decomp(z((t, s, obj_res, obj_res, 1))).image.size, 1),
            "segmentation.png": (viz.visualize_sequence(z((t, obj_res, obj_res, 3))).image.size,
                                 1)}


def expected_06b(c, p, s, res, obj_res):
    """{file: (size, frames)} of one 06b sequence (c seed frames, p
    predictions at res, s slots, objects and masks at obj_res)."""
    from textocvp_tpu_torch import viz

    z = np.zeros
    gif, seg, obj = 2 * res + 8, 2 * obj_res + 8, obj_res + 4  # obj: 2 px borders
    return {"qual_eval_rgb.png": (viz.visualize_qualitative_eval(
                z((c, res, res, 3)), z((p, res, res, 3)), z((p, res, res, 3))).image.size, 1),
            "aligned_slots.png": (viz.visualize_aligned_slots(z((c + p, s, obj, obj, 3)))
                                  .image.size, 1),
            "masks_GIF_masks.gif": ((seg, seg), c + p), "overlay_GIF.gif": ((seg, seg), c + p),
            "gt_GIF_frames.gif": ((gif, gif), c + p), "pred_GIF_frames.gif": ((gif, gif), c + p),
            **{f"gt_obj_{k + 1}.gif": ((2 * obj, 2 * obj), c + p) for k in range(s)}}


def check_inventory(seq_dir: Path, expected: dict, what: str):
    """The sequence directory holds exactly the expected figures (and, for
    06b, ``prompt.txt`` with a caption), each decoding at its size and frame
    count."""
    names = {p.name for p in seq_dir.iterdir()}
    want = set(expected) | ({"prompt.txt"} if "qual_eval_rgb.png" in expected else set())
    check(names == want, f"{what}: {seq_dir.name} holds {sorted(names)}, want {sorted(want)}")
    for name, info in expected.items():
        got = image_info(seq_dir / name)
        check(got == info, f"{what}: {seq_dir.name}/{name} is {got}, want {info}")
    if "prompt.txt" in want:
        check(len((seq_dir / "prompt.txt").read_text().strip()) > 0, f"{what}: empty prompt.txt")


def run_06(what, main, argv, want, sequences):
    """One 06 CLI run between a reset and a read of the launch counters: the
    06 path's main path. Checks the launches (``want`` a sequence); returns
    the generator, its seconds and the launches."""
    reset_launches()  # the main path starts here
    t = time.perf_counter()
    gen = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    check(counts == {k: n * sequences for k, n in want.items()},
          f"{what}: kernel launches on the main path {counts}, want {want} x {sequences}")
    return gen, seconds, counts


def phase_figs_06(phase, exp_path, pred_name, num_preds, sequences, slots, res, obj_res,
                  want_a, want_b):
    """06a and 06b through their CLIs on the card (``sequences`` each, c=1,
    ``num_preds``): the launches, each sequence's whole inventory, the 06b
    directories' PSNR and LPIPS those the generator computed, the seconds a
    sequence (the CLI's, loads included). Returns each path's launches."""
    from textocvp_tpu_torch.cli import generate_figs_decomp, generate_figs_predictor

    ckpt = "checkpoint_epoch_final"
    gen, seconds_a, counts_a = run_06(
        f"{phase} 06a", generate_figs_decomp.main,
        ["-d", str(exp_path), "--decomp_ckpt", ckpt, "--num_seqs", str(sequences)], want_a,
        sequences)
    dirs = sorted(p for p in gen.out_dir.iterdir())
    check([p.name for p in dirs] == [f"sequence_{i:02d}" for i in range(sequences)],
          f"{phase} 06a: {[p.name for p in dirs]}")
    t = gen.exp_params["dataset"]["num_frames"]
    for d in dirs:
        check_inventory(d, expected_06a(t, slots, res, obj_res), f"{phase} 06a")
    del gen

    gen, seconds_b, counts_b = run_06(
        f"{phase} 06b", generate_figs_predictor.main,
        ["-d", str(exp_path), "--name_pred_exp", pred_name, "--decomp_ckpt", ckpt,
         "--pred_ckpt", ckpt, "--num_seed", "1", "--num_preds", str(num_preds),
         "--num_seqs", str(sequences)], want_b, sequences)
    dirs = sorted(p for p in gen.out_dir.iterdir())
    check(len(dirs) == len(gen.sequence_metrics) == sequences, f"{phase} 06b: {dirs}")
    for i, (d, m) in enumerate(zip(dirs, gen.sequence_metrics)):
        check(np.isfinite([m["psnr"], m["lpips"]]).all(), f"{phase} 06b: metrics {m}")
        name = f"sequence_{i:02d}_psnr={m['psnr']:.2f}_lpips={m['lpips']:.3f}"
        check(d.name == name, f"{phase} 06b: directory {d.name}, the generator's {name}")
        check_inventory(d, expected_06b(1, num_preds, slots, res, obj_res), f"{phase} 06b")
    emit({"phase": phase, "sequences": sequences, "num_preds": num_preds,
          "06a": {"cli_seconds": seconds_a, "seconds_a_sequence": seconds_a / sequences,
                  "launches": counts_a,
                  "frames": t, "out_dir": str(exp_path / "plots" / f"figs_{ckpt}")},
          "06b": {"cli_seconds": seconds_b, "seconds_a_sequence": seconds_b / sequences,
                  "launches": counts_b,
                  "sequence_metrics": gen.sequence_metrics, "directories": [d.name for d in dirs]}})
    return {f"{phase}_decomp": counts_a, f"{phase}_pred": counts_b}


def phase_figs_parity(exp_path: Path):
    """06b's figures of one CATER sequence at p=FIG_PARITY_PREDS on the card
    and on the CPU: the same weights, frames, caption and initial slots.
    Every array handed to a figure writer within 1e-4 of the largest |value|
    among it and the decoded predictions before their clip to [0, 1] (the
    clip keeps the decoder's error and drops its scale: trained weights
    decode values well outside [0, 1]); the two argmax-coloured GIFs' frames
    differ on at most 1e-3 of their pixels; PSNR within 1e-3 dB, LPIPS within
    1e-4. Reported beside them: each rollout step's slots, and the decode of
    the CPU's predicted slots on both devices, each error over its largest
    value. Off the main path; the writers record here and write nothing."""
    from textocvp_tpu_torch.train.fig_generation import PredictorFigGenerator
    from textocvp_tpu_torch.viz import figures

    gens = {dev: PredictorFigGenerator(exp_path, PRED_NAME, "checkpoint_epoch_final",
                                       "checkpoint_epoch_final", num_seed=1,
                                       num_preds=FIG_PARITY_PREDS, num_seqs=1, device=dev)
            for dev in ("cpu", "cuda")}
    for gen in gens.values():
        gen.load_data()
        gen.load_models()
    videos, info = next(iter(gens["cpu"].test_loader))
    init = gens["cpu"].model.slot_initializer(1, torch.Generator().manual_seed(SEED + 8))

    pred_slots, decoded = {}, {}
    with torch.inference_mode():
        for dev, gen in gens.items():
            v, text = gen.to_device(videos, info)
            slots = gen.model.decompose(v[:, :1], initial_slots=init.to(gen.device))
            pred_slots[dev] = gen.predictor(slots["slot_history"], num_preds=FIG_PARITY_PREDS,
                                            teacher_force=False, **text).cpu()
        flat = pred_slots["cpu"].reshape(-1, *pred_slots["cpu"].shape[2:])
        for dev, gen in gens.items():
            decoded[dev] = gen.model.decode(flat.to(gen.device))["recons_imgs"].cpu()
    step_rel = ((pred_slots["cuda"] - pred_slots["cpu"]).abs().amax(dim=(0, 2, 3))
                / pred_slots["cpu"].abs().amax(dim=(0, 2, 3))).tolist()
    decode_rel = rel_err(decoded["cuda"], decoded["cpu"])
    scale = decoded["cpu"].abs().max().item()

    recorded, metrics = {}, {}
    originals = {name: getattr(figures, name) for name in FIG_WRITERS}

    def recorder(into):
        def rec(*args, **kwargs):
            path = Path(kwargs["savepath"] if "savepath" in kwargs else args[1])
            into[path.name] = [np.asarray(a, np.float32) for a in args
                               if not isinstance(a, (str, Path))]
        return rec

    try:
        for dev, gen in gens.items():
            recorded[dev] = {}
            for name in FIG_WRITERS:
                setattr(figures, name, recorder(recorded[dev]))
            metrics[dev] = gen.sequence_figs(0, videos, info, initial_slots=init)[1]
    finally:
        for name, fn in originals.items():
            setattr(figures, name, fn)
    del gens
    check(set(recorded["cuda"]) == set(recorded["cpu"]) and len(recorded["cpu"]) == 14,
          f"figs_parity: files {sorted(recorded['cuda'])} / {sorted(recorded['cpu'])}")
    errs, mismatch = {}, {}
    for name, ref in recorded["cpu"].items():
        got = recorded["cuda"][name]
        check([a.shape for a in got] == [a.shape for a in ref], f"figs_parity: {name} shapes")
        if name in ARGMAX_FIGS:
            (a,), (b,) = got, ref
            mismatch[name] = float((np.abs(a - b).max(-1) > 1e-4 * np.abs(b).max()).mean())
            check(mismatch[name] <= 1e-3, f"figs_parity: {name} differs on {mismatch[name]} "
                                          "of its pixels > 1e-3")
            continue
        errs[name] = max(float(np.abs(a - b).max() / max(np.abs(b).max(), scale))
                         for a, b in zip(got, ref))
        check(errs[name] <= 1e-4, f"figs_parity: {name} card vs CPU {errs[name]} of the "
                                  f"largest value (decoded before the clip: {scale})")
    dm = {m: abs(metrics["cuda"][m] - metrics["cpu"][m]) for m in ("psnr", "lpips")}
    check(dm["psnr"] <= 1e-3 and dm["lpips"] <= 1e-4, f"figs_parity: metrics {metrics}")
    emit({"phase": "figs_parity", "num_preds": FIG_PARITY_PREDS, "rel_err": errs,
          "argmax_pixel_mismatch": mismatch, "metrics": metrics, "metric_abs_err": dm,
          "pred_slots_rel_err_per_step": step_rel, "decode_of_cpu_slots_rel_err": decode_rel,
          "decoded_max_abs_before_clip": scale,
          "decoded_range": [decoded["cpu"].min().item(), decoded["cpu"].max().item()],
          "tolerance": {"rel": 1e-4, "argmax_mismatch": 1e-3, "psnr": 1e-3, "lpips": 1e-4}})


def run_figs(train_exp: Path):
    """The 06 paths on CATER over the 02 phase's SAVi and the 04 phase's
    TextOCVP_T5: the card-against-CPU sequence, then the two CLIs. Returns
    their main paths' launches."""
    phase_figs_parity(train_exp)
    gc.collect()
    return phase_figs_06("figs", train_exp, PRED_NAME, EVAL_PREDS, FIG_SEQS, 8, CONV5_RES,
                         CONV5_RES, {"slot_attention": DECOMP_FRAMES, "vit_attention": 0,
                                     "conv5": 3},
                         {"slot_attention": 1, "vit_attention": 0, "conv5": 6})


def run_clip_figs(clip_exp: Path):
    """The 06 paths on the CLIPort chain's ExtendedDINOSAUR and TextOCVP_T5
    (p=9), one sequence each. Returns their main paths' launches."""
    return phase_figs_06("clip_figs", clip_exp, CLIP_PRED_NAME, CLIP_PREDS, 1, CLIP_SLOTS,
                         CLIP_RES, DINOSAUR_OBJ_RES,
                         {"slot_attention": DECOMP_FRAMES, "vit_attention": VIT_BLOCKS,
                          "conv5": 0},
                         {"slot_attention": 1, "vit_attention": VIT_BLOCKS, "conv5": 0})


def batching_run(service, path: ServedPath, rows, dynamic_batch_ms, depth):
    """BATCHING_REQUESTS one-row requests from BATCHING_CLIENTS client threads
    over HTTP, each client's requests one after another: requests/s, the
    clients' p50 and p95 ms, /stats, and the device batches (slot-attention
    launches, one a batch)."""
    from textocvp_tpu_torch.serve import serve

    httpd = serve(service, host="127.0.0.1", port=0, warmup=False,
                  dynamic_batch_ms=dynamic_batch_ms, pipeline_depth=depth)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    per_client = BATCHING_REQUESTS // BATCHING_CLIENTS
    lat, outs, errors = [], {}, []

    def client(c):
        try:
            for i in range(c * per_client, (c + 1) * per_client):
                buf = io.BytesIO()
                np.savez(buf, frames=rows[i:i + 1],
                         captions=np.array([path.captions[i % len(path.captions)]]))
                req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                             headers={"Content-Type": "application/npz"})
                t = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as r:
                    outs[i] = np.load(io.BytesIO(r.read()))["pred_frames"]
                lat.append(1e3 * (time.perf_counter() - t))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    before = launches()["slot_attention"]
    try:
        clients = [threading.Thread(target=client, args=(c,)) for c in range(BATCHING_CLIENTS)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        if httpd.batcher is not None:
            httpd.batcher.close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "serve_batching: server thread stopped")
    batches = launches()["slot_attention"] - before
    what = f"serve_batching ({dynamic_batch_ms} ms, depth {depth})"
    check(not errors and len(outs) == BATCHING_REQUESTS, f"{what}: errors {errors[:3]}")
    for out in outs.values():
        check(out.dtype == np.uint8 and out.shape == (1, path.num_preds, path.res, path.res, 3),
              f"{what}: reply {out.dtype} {out.shape}")
    check(stats["requests"] == stats["rows"] == BATCHING_REQUESTS and stats["errors"] == 0,
          f"{what}: stats {stats}")
    if dynamic_batch_ms is None:
        check(batches == BATCHING_REQUESTS, f"{what}: {batches} device batches")
    else:
        check(stats["batches_dispatched"] == batches < BATCHING_REQUESTS,
              f"{what}: {batches} device batches, stats {stats}")
    lat.sort()
    return {"dynamic_batch_ms": dynamic_batch_ms, "pipeline_depth": depth,
            "requests": BATCHING_REQUESTS, "clients": BATCHING_CLIENTS, "seconds": wall,
            "requests_per_s": BATCHING_REQUESTS / wall, "p50_ms": lat[len(lat) // 2],
            "p95_ms": lat[min(len(lat) - 1, int(len(lat) * 0.95))],
            "batches_dispatched": batches,
            "mean_batch_fill": BATCHING_REQUESTS / (batches * service.batch_size),
            "stats": stats}


def phase_serve_batching(exp_path: Path):
    """The CATER service at batch 8 behind the dynamic batcher: two one-row
    requests coalesced into one batch equal, bit for bit, a direct two-row
    predict from the same generator state (off the main path); then the main
    path, BATCHING_REQUESTS one-row HTTP requests from BATCHING_CLIENTS
    clients with batching off, at a BATCHING_WINDOW_MS window with one
    dispatcher, and with two. Returns the main path's launches."""
    from textocvp_tpu_torch.serve import DynamicBatcher, PredictionService

    path = PATHS[0]
    service = PredictionService(exp_path, "textocvp_t5", "random", "random", batch_size=BATCH,
                                max_tokens=MAX_TOKENS, device="cuda")
    service.warmup()
    rng = np.random.default_rng(SEED + 9)
    rows = rng.uniform(0, 1, (BATCHING_REQUESTS, 1, path.res, path.res, 3)).astype(np.float32)
    captions = list(path.captions[:2])
    state = service.generator.get_state()
    direct = service.predict(rows[:2], captions)
    service.generator.set_state(state)
    batcher, coalesced = DynamicBatcher(service, max_wait_ms=500.0), {}
    try:
        threads = [threading.Thread(target=lambda i=i: coalesced.update(
            {i: batcher.predict(rows[i:i + 1], captions[i:i + 1])})) for i in range(2)]
        threads[0].start()
        time.sleep(0.1)  # request 0 enqueues first
        threads[1].start()
        for t in threads:
            t.join(timeout=300)
        dispatches = batcher._dispatches
    finally:
        batcher.close()
    check(dispatches == 1 and set(coalesced) == {0, 1}
          and np.array_equal(np.concatenate([coalesced[0], coalesced[1]]), direct),
          f"serve_batching: two coalesced rows ({dispatches} batches) differ from a direct "
          "2-row predict")

    reset_launches()  # the main path starts here
    runs = [batching_run(service, path, rows, ms, depth)
            for ms, depth in ((None, 2), (BATCHING_WINDOW_MS, 1), (BATCHING_WINDOW_MS, 2))]
    counts = launches()  # and ends here
    batches = sum(r["batches_dispatched"] for r in runs)
    check(counts == {"slot_attention": batches, "vit_attention": 0, "conv5": 3 * batches},
          f"serve_batching: kernel launches on the main path {counts}, {batches} batches")
    emit({"phase": "serve_batching", "path": path.name, "batch": BATCH,
          "coalesced_equals_direct": True, "runs": runs, "launches": counts})
    del service
    torch.cuda.empty_cache()
    return counts


def run_path(path: ServedPath, tmp: Path):
    """Parity, then the main path (service + HTTP) between a reset and a read
    of the launch counters, then the profile. Returns the main path's launches."""
    params, pred_params = full_width_params(path)
    phase_parity(path, params, pred_params)
    exp_path = write_experiment(tmp / path.name, params, pred_params)
    reset_launches()  # the main path starts here
    service = phase_service(path, exp_path)
    video = np.random.default_rng(SEED + 2).uniform(0, 1, (BATCH, 1, path.res, path.res, 3))
    phase_http(path, service, video.astype(np.float32))
    counts = launches()  # and ends here
    requests = 1 + 3 + 5 + 1 + 1  # warmup, 8 requests, stage split, HTTP
    check(counts == {"slot_attention": requests,
                     "vit_attention": requests * path.vit_per_request,
                     "conv5": requests * path.conv5_per_request},
          f"{path.name}: kernel launches on the main path: {counts}")
    phase_profile(path, service, video.astype(np.float32))
    del service
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA device",
              file=sys.stderr)
        return 2

    name = phase_device()
    phase_build()
    rows = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_host_io(Path(tmp))
        made = phase_create(Path(tmp))
        counts = {path.name: run_path(path, Path(tmp)) for path in PATHS}
        counts["serve_batching"] = phase_serve_batching(Path(tmp) / PATHS[0].name / "exp")
        counts["eval"] = run_eval(Path(tmp))
        counts["png_eval"] = run_png_eval(Path(tmp))
        counts["train"], train_input_grad, train_exp = run_train(Path(tmp))
        # 03 on the SAVi that 02 wrote, over the eval path's 128 test videos
        counts["decomp_eval"] = run_decomp_eval(
            "cater", made["cater"], train_exp / "models" / "checkpoint_epoch_final.pt",
            Path(tmp) / "CATER", EVAL_VIDEOS)
        phase_train_extras(Path(tmp))
        phase_train_remat(train_exp, Path(tmp) / "CATER_train")
        counts["pred_train"], pred_input_grad, pred_weight_grad = run_pred_train(train_exp)
        counts.update(run_figs(train_exp))
        other_counts, other_input_grad, other_weight_grad = run_predictors(Path(tmp), train_exp)
        counts.update(other_counts)
        counts.update(run_clip(Path(tmp), made["clipport"]))
        counts.update(run_clip_figs(Path(tmp) / "clip_train"))
        phase_clip_remat(Path(tmp) / "clip_train")
        counts["clip_png_eval"] = run_clip_png_eval(Path(tmp))

    sa = next(r for r in rows["slot_attention_cater"] if r["B"] == BATCH and r["iters"] == 3)
    sa64 = next(r for r in rows["slot_attention_cater"] if r["B"] == EVAL_BATCH
                and r["iters"] == 3)
    sa1 = next(r for r in rows["slot_attention_cater"] if r["B"] == 1 and r["iters"] == 3)
    sa_clip = {r["B"]: r for r in rows["slot_attention_clipport"] if r["iters"] == 3}
    vit = {r["B"]: r for r in rows["vit_attention"]}
    vit8 = vit[BATCH]
    conv_by_n = {r["N"]: r for r in rows["conv5"]}
    conv_eval = conv_by_n[EVAL_BATCH * EVAL_PREDS * 8]
    conv_bwd = {r["N"]: r for r in rows["conv5_backward"]}
    conv_train = conv_bwd[TRAIN_BATCH * TRAIN_FRAMES * 8]
    sa_bwd = {r["iters"]: r for r in rows["slot_attention_backward"]}
    sa_bwd_clip = {r["iters"]: r for r in rows["slot_attention_backward_clipport"]}
    (conv_frozen,) = rows["conv5_frozen_backward"]
    emit({"kernels": [{
        "name": "slot_attention",
        "route": "cuda",
        "source": "textocvp_tpu_torch/csrc/slot_attention.cu",
        "replaces": "textocvp_tpu/ops/pallas/slot_attention_kernel.py:37",
        "launches": sum(c["slot_attention"] for c in counts.values()),
        "launches_by_path": {p: c["slot_attention"] for p, c in counts.items()},
        "max_abs_err": max(max(r["max_abs_err_slots"], r["max_abs_err_attn"]) for r in
                           rows["slot_attention_cater"] + rows["slot_attention_clipport"]),
        "ms": sa["ms"],
        "plain_ms": sa["plain_ms"],
        "bound_ms": sa["bound_ms"],
        "bound_by": sa["bound_by"],
        "library_ms": None,
        "cluster_size": sa["cluster_size"],
        "active_clusters": sa["active_clusters"],
        "device_launches_per_call": max(r["device_launches"] for r in
                                        rows["slot_attention_cater"] + rows["slot_attention_clipport"]),
        **{name: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
           | {"max_abs_err": max(r["max_abs_err_slots"], r["max_abs_err_attn"])}
           for name, r in (("b64", sa64), ("b1", sa1))},
        **{"clipport_shape" if b == BATCH else f"clipport_b{b}":
           {k: r[k] for k in ("B", "N", "S", "mlp", "iters", "ms", "plain_ms", "bound_ms",
                              "bound_by")}
           | {"max_abs_err": max(r["max_abs_err_slots"], r["max_abs_err_attn"])}
           for b, r in sa_clip.items()},
        "backward": {"route": "torch.autograd.Function; backward recomputes through "
                              "slot_attention_plain (the JAX _fused_bwd)",
                     "shape": {"B": TRAIN_BATCH, "N": CONV5_RES * CONV5_RES, "S": 8, "mlp": 256},
                     **{f"{it}_it": {k: r[k] for k in ("backward_ms", "bound_ms", "bound_by",
                                                      "max_rel_err")}
                        for it, r in sa_bwd.items()},
                     "tolerance_rel": GRAD_TOLERANCE, "library_ms": None,
                     "clipport": {"shape": {"B": CLIP_TRAIN_BATCH // CLIP_ACCUM,
                                            "N": CLIP_PATCHES, "S": CLIP_SLOTS, "mlp": 512},
                                  **{f"{it}_it": {k: r[k] for k in (
                                      "backward_ms", "bound_ms", "bound_by", "max_rel_err")}
                                     for it, r in sa_bwd_clip.items()}}},
    }, {
        "name": "vit_attention",
        "route": "cuda",
        "source": "textocvp_tpu_torch/csrc/vit_attention.cu",
        "replaces": "textocvp_tpu/nn/vit.py:43",
        "launches": sum(c["vit_attention"] for c in counts.values()),
        "launches_by_path": {p: c["vit_attention"] for p, c in counts.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows["vit_attention"]),
        "ms": vit8["ms"],
        "plain_ms": vit8["plain_ms"],
        "bound_ms": vit8["bound_ms"],
        "bound_by": vit8["bound_by"],
        "bound_ms_fp32_cores": vit8["bound_ms_fp32_cores"],
        "library_ms": vit8["library_ms"],
        **{f"b{b}": {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_ms_fp32_cores",
                                       "library_ms", "max_abs_err")}
           for b, r in vit.items() if b != BATCH},
    }, {
        "name": "conv5",
        "route": "cuda",
        "source": "textocvp_tpu_torch/csrc/conv5.cu",
        "replaces": "bench_pallas_conv.py:85",
        "launches": sum(c["conv5"] for c in counts.values()),
        "launches_by_path": {p: c["conv5"] for p, c in counts.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows["conv5"]),
        "ms": conv_eval["ms"],
        "plain_ms": conv_eval["plain_ms"],
        "bound_ms": conv_eval["bound_ms"],
        "bound_by": conv_eval["bound_by"],
        "bound_ms_fp32_cores": conv_eval["bound_ms_fp32_cores"],
        "library_ms": conv_eval["library_ms"],
        "library_layout": conv_eval["library_layout"],
        "shape": [conv_eval["N"], CONV5_RES, CONV5_RES, CONV5_CH],
        **{f"n{n}": {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "bound_ms_fp32_cores", "library_ms",
                                       "library_layout", "max_abs_err")}
           for n, r in conv_by_n.items() if r is not conv_eval},
        "train_input_grad_launches": train_input_grad,
        "pred_train_input_grad_launches": pred_input_grad,
        "pred_train_weight_grad_calls": pred_weight_grad,
        "predictors_train_input_grad_launches": other_input_grad,
        "predictors_train_weight_grad_calls": other_weight_grad,
        "frozen_backward": {k: conv_frozen[k] for k in (
            "N", "rel_err", "forward_ms", "input_grad_ms", "plain_input_grad_ms", "library_ms",
            "bound_ms", "bound_by", "bound_ms_fp32_cores")},
        "backward": {"route": "cuda (input gradient: this kernel, rotated weights); weight "
                              "gradient: torch.matmul; bias gradient: a sum",
                     "max_rel_err": max(max(r["rel_err"].values()) for r in conv_bwd.values()),
                     "tolerance_rel": GRAD_TOLERANCE,
                     **{f"n{n}": {k: r[k] for k in (
                         "forward_ms", "input_grad_ms", "weight_grad_ms", "bias_grad_ms",
                         "backward_ms", "library_ms", "input_grad_bound_ms",
                         "weight_grad_bound_ms", "weight_grad_bound_by", "backward_bound_ms",
                         "rel_err")} for n, r in conv_bwd.items()},
                     "ms": conv_train["backward_ms"], "bound_ms": conv_train["backward_bound_ms"],
                     "library_ms": conv_train["library_ms"]},
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
